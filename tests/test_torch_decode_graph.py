"""Pure-decode CUDA graphs (``serving/decode_graph.py``) and the
sync-free ``rope`` they rest on.

On the CPU: ``rope``'s cached frequencies equal the former per-call
formula bit for bit for every (head_dim, rope_theta) of the port's
configs, ``rope``'s output is unchanged, a call makes no tensor from a
Python scalar (the host-to-device copy that waited for the card), the
eligibility rule, the packed lowering into a static buffer, and the
runner's invalidation (a rebuilt pool drops the graphs and each bucket
is captured again at its first use, a counter keeps the step eager) with
capture stubbed.

On the card (``cuda`` marker, skipped elsewhere; this file imports no
JAX): at every bucket of a tiny dense engine the replayed tokens equal
``api.decode_paged``'s eager ones, twice with fresh inputs in the static
buffers, the pool outside the lanes' write slots is untouched, the
dispatch runs under ``torch.cuda.set_sync_debug_mode("error")``, the
paged kernel's launch count grows by one a layer a replay, a rebuilt
pool captures a bucket again at its first use and no other, and served
engines equal the CPU's.
"""

import dataclasses
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.analysis import counting
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import common, zoo
from repro_torch.serving import decode_graph as DG
from repro_torch.serving.batch import ModelWorkerBatch, lower_arrays
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.speculative import SpeculativeConfig

torch.set_num_threads(1)

ECONF = dict(max_context=64, chunk_size=16, max_batch_tokens=64,
             max_batch_requests=8, capacity_tokens=1024, page_size=16,
             paged=True)


def _former_freq(d, theta, device="cpu"):
    """``rope``'s frequencies as every call made them before: theta
    copied from the host as a 0-d float32 tensor, then the power."""
    exps = -torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)


def _former_rope(x, positions, theta):
    angles = positions[..., None].float() * _former_freq(x.shape[-1], theta)
    angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


ROPE_PAIRS = sorted({(c.head_dim, float(c.rope_theta))
                     for base in ARCHS.values()
                     for c in (base, reduced(base)) if c.rope_theta}
                    | {(128, 10000.0)})      # the benchmark's mistral-7b


@pytest.mark.parametrize("d,theta", ROPE_PAIRS)
def test_rope_freq_bit_identical_to_the_former_formula(d, theta):
    got = common.rope_freq(d, theta, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == (d // 2,)
    assert torch.equal(got, _former_freq(d, theta))
    # cached: the same tensor for the same key
    assert common.rope_freq(d, theta, torch.device("cpu")) is got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 4, 64), (2, 1, 8, 128)])
def test_rope_output_unchanged(dtype, shape):
    g = torch.Generator().manual_seed(shape[-1])
    x = torch.randn(shape, generator=g).to(dtype)
    pos = torch.randint(0, 4096, shape[:2], generator=g, dtype=torch.int32)
    for theta in (10000.0, 1000000.0):
        assert torch.equal(common.rope(x, pos, theta),
                           _former_rope(x, pos, theta))


def test_rope_makes_no_tensor_from_a_python_scalar():
    """Even a first call (an empty cache) uploads nothing from the host."""
    common.rope_freq.cache_clear()
    x = torch.randn(2, 3, 4, 64)
    pos = torch.arange(3)[None].expand(2, 3)
    with mock.patch.object(torch, "tensor",
                           side_effect=AssertionError("torch.tensor")):
        first = common.rope(x, pos, 10000.0)
        again = common.rope(x, pos, 10000.0)
    assert torch.equal(first, again)
    assert torch.equal(first, _former_rope(x, pos, 10000.0))


def _cfg(arch="smollm-360m", **kw):
    return dataclasses.replace(reduced(ARCHS[arch]), n_layers=2,
                               dtype="float32", **kw)


def _engine_like(cfg, **kw):
    """What ``eligible`` reads of an engine, on a CUDA device by default
    (no card needed: nothing is allocated)."""
    base = dict(paged=True, device=torch.device("cuda", 0), plan=None,
                econf=EngineConfig(**ECONF),
                model_cfg=dataclasses.replace(cfg, sliding_window=0))
    base.update(kw)
    return SimpleNamespace(**base)


def _spec_econf():
    return EngineConfig(**ECONF, speculative=SpeculativeConfig(
        draft_cfg=_cfg()))


ELIGIBILITY = {
    "dense-paged-cuda": (lambda: _engine_like(_cfg()), True),
    "mistral-paged-cuda": (lambda: _engine_like(_cfg("mistral-7b")), True),
    "routed-moe": (lambda: _engine_like(_cfg("mixtral-8x22b")), False),
    "tensor-parallel": (lambda: _engine_like(_cfg(), plan=object()), False),
    "speculative": (lambda: _engine_like(_cfg(), econf=_spec_econf()),
                    False),
    "cpu": (lambda: _engine_like(_cfg(), device=torch.device("cpu")),
            False),
    "dense-plane": (lambda: _engine_like(_cfg(), paged=False), False),
}


@pytest.mark.parametrize("case", sorted(ELIGIBILITY))
def test_eligibility(case):
    make, want = ELIGIBILITY[case]
    assert DG.eligible(make()) is want


def test_a_counter_keeps_an_eligible_engine_eager():
    eng = _engine_like(_cfg())
    assert DG.eligible(eng)
    with counting.Counter():
        assert not DG.eligible(eng)
    assert DG.eligible(eng)


def _pure_decode_dispatches(st):
    """A fused paged engine's pure-decode dispatches: every dispatch that
    is not a fused one."""
    return st["model_dispatches"] - st["fused_iterations"]


def test_cpu_engine_counts_dispatches_and_replays_nothing():
    cfg = _cfg()
    params = zoo.build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, EngineConfig(**ECONF), device="cpu")
    assert eng._graphs is None
    _serve(eng, cfg.vocab_size)
    st = eng.stats
    assert st["fused_iterations"] > 0
    assert 0 < _pure_decode_dispatches(st) <= st["decode_batches"]
    assert st["decode_graph_replays"] == st["decode_graph_captures"] == 0


def test_lower_arrays_into_a_static_buffer():
    rng = np.random.default_rng(0)
    B, P = 4, 3
    wb = DG.decode_batch(rng.integers(0, 99, B).astype(np.int32),
                         rng.integers(0, 48, B).astype(np.int32),
                         rng.integers(0, 9, (B, P)).astype(np.int32))
    assert isinstance(wb, ModelWorkerBatch)
    assert wb.chunk_tokens.shape == (0, 1)
    assert wb.chunk_page_table.shape == (0, P)
    out = torch.full((B * (2 + P),), -1, dtype=torch.int32)
    views = lower_arrays(wb.arrays(), "cpu", out=out)
    plain = lower_arrays(wb.arrays(), "cpu")
    for v, p in zip(views, plain):
        assert torch.equal(v, p)
    for v in views[4:]:
        assert v.untyped_storage().data_ptr() == \
            out.untyped_storage().data_ptr()
    with pytest.raises(ValueError):
        lower_arrays(wb.arrays(), "cpu", out=out[1:])


def _serve(eng, vocab, n=6, seed=1):
    from repro_torch.core.request import Request
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, vocab, 29).tolist())
    reqs = [Request(tokens=shared + tuple(rng.integers(1, vocab, 8)
                                          .tolist()), max_new_tokens=5)
            for _ in range(n)]
    now, done = 0.0, []
    for wave in (reqs[:2], reqs[2:]):
        for r in wave:
            eng.scheduler.enqueue(r, now)
        target = len(done) + len(wave)
        while len(done) < target:
            done += eng.step(now)
            now += 0.01
    return [list(r.output_tokens) for r in reqs]


def test_runner_captures_again_when_the_pool_or_params_move():
    """The invalidation logic with capture stubbed (no card): the build
    captures every bucket, a get captures nothing more, a rebuilt pool
    (``_init_paged``) drops every graph, and then a get captures its own
    bucket alone; a counter returns None and captures nothing. (The
    parameters never move after the build, so nothing watches them.)"""
    cfg = _cfg()
    params = zoo.build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, EngineConfig(**ECONF), device="cpu")
    with mock.patch.object(torch.cuda, "Stream"), \
            mock.patch.object(torch.cuda, "stream"), \
            mock.patch.object(PA, "arrival_counters"):
        runner = DG.DecodeGraphs(eng)
    captured = []

    def capture(Bb):
        captured.append(Bb)
        runner.graphs[Bb] = f"g{Bb}"
        return runner.graphs[Bb]

    runner._capture = capture
    eng._graphs = runner
    runner.capture()
    assert captured == [8, 4, 2, 1]
    assert runner.get(2) == "g2" and runner.get(8) == "g8"
    assert captured == [8, 4, 2, 1]
    eng._init_paged()                   # a recovery's fresh pool
    assert runner.graphs == {} and runner.pool is None
    assert captured == [8, 4, 2, 1]     # the recovery captures nothing
    assert runner.get(2) == "g2" and runner.get(2) == "g2"
    assert captured == [8, 4, 2, 1, 2]
    with counting.Counter():
        assert runner.get(4) is None
    assert captured == [8, 4, 2, 1, 2]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs of the card's kernels")


def _card_engine(arch="smollm-360m", dtype="float32"):
    cfg = _cfg(arch)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = zoo.build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    return cfg, params, Engine(cfg, params, EngineConfig(**ECONF),
                               device="cuda")


def _random_inputs(rng, eng, Bb):
    """Bb lanes, the last quarter padding (all-scratch rows, position 0,
    token 0) as the engine pads; real lanes on distinct pages >= 1."""
    P, PS = eng._pages_per_req, eng.econf.page_size
    n_pages = eng._leaves[0].shape[0]
    real = Bb - Bb // 4
    tokens = np.zeros(Bb, np.int32)
    pos = np.zeros(Bb, np.int32)
    pt = np.zeros((Bb, P), np.int32)
    pages = rng.permutation(np.arange(1, n_pages))[:real * P]
    for b in range(real):
        tokens[b] = rng.integers(1, eng.model_cfg.vocab_size)
        pos[b] = rng.integers(0, P * PS)
        pt[b] = pages[b * P:(b + 1) * P]
    slots = {(int(pt[b, pos[b] // PS]), int(pos[b] % PS))
             for b in range(Bb)}
    return tokens, pos, pt, slots


def _pool(eng):
    return [a.clone() for a in eng._leaves]


def _set_pool(eng, leaves):
    for a, b in zip(eng._leaves, leaves):
        a.copy_(b)


@pytest.mark.cuda
def test_replay_equals_eager_at_every_bucket(card):
    cfg, _, eng = _card_engine()
    g = torch.Generator(device="cuda").manual_seed(1)
    for a in eng._leaves:
        a.copy_(torch.randn(a.shape, generator=g, device="cuda"))
    runner = eng._graphs
    assert runner is not None
    assert sorted(runner.graphs) == [1, 2, 4, 8]
    assert eng.stats["decode_graph_captures"] == 4
    rng = np.random.default_rng(2)
    for Bb in (8, 4, 2, 1):
        graph = runner.get(Bb)
        assert graph.launches == cfg.n_layers
        for _ in range(2):              # fresh inputs in the same buffers
            tokens, pos, pt, slots = _random_inputs(rng, eng, Bb)
            before = _pool(eng)
            arrays = DG.decode_batch(tokens, pos, pt).arrays()
            n0 = PA.paged_decode_attention.launches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                lower_arrays(arrays, eng.device, out=graph.inputs)
                out = runner.replay(graph)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got = out.cpu()
            assert PA.paged_decode_attention.launches == n0 + cfg.n_layers
            replayed = _pool(eng)
            _set_pool(eng, before)
            views = lower_arrays(arrays, eng.device)
            want, _ = eng.api.decode_paged(
                eng.params, eng.pages, {"tokens": views[4],
                                        "pos": views[5],
                                        "page_table": views[6]})
            assert torch.equal(got, want.cpu()), Bb
            for a, b, c in zip(replayed, eng._leaves, before):
                assert torch.equal(a, b)            # the same KV written
                keep = torch.ones(a.shape[:2], dtype=torch.bool)
                for p, s in slots:
                    keep[p, s] = False
                keep = keep.cuda()
                assert torch.equal(a[keep], c[keep])  # nothing else moved


@pytest.mark.cuda
def test_rebuilt_pool_is_captured_again(card):
    cfg, _, eng = _card_engine()
    runner = eng._graphs
    old = runner.get(2)
    eng._init_paged()
    assert runner.graphs == {}
    assert eng.stats["decode_graph_captures"] == 4
    rng = np.random.default_rng(3)
    tokens, pos, pt, _ = _random_inputs(rng, eng, 2)
    graph = runner.get(2)
    assert graph is not old
    assert sorted(runner.graphs) == [2]
    assert eng.stats["decode_graph_captures"] == 5
    # capture (and its eager warm-up) wrote the scratch page 0 alone
    assert all(not a[1:].any() for a in eng._leaves)
    arrays = DG.decode_batch(tokens, pos, pt).arrays()
    lower_arrays(arrays, eng.device, out=graph.inputs)
    got = runner.replay(graph).cpu()
    written = _pool(eng)
    eng._init_paged()                   # zeros again, eager this time
    eng._graphs = None
    views = lower_arrays(arrays, eng.device)
    want, _ = eng.api.decode_paged(eng.params, eng.pages,
                                   {"tokens": views[4], "pos": views[5],
                                    "page_table": views[6]})
    assert torch.equal(got, want.cpu())
    for a, b in zip(written, eng._leaves):
        assert torch.equal(a[1:], b[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", [("smollm-360m", "float32"),
                                        ("mistral-7b", "float32"),
                                        ("smollm-360m", "bfloat16")])
def test_graph_engine_serves_as_eager(card, arch, dtype):
    """A served engine replaying its decode steps against the same engine
    kept eager on the card (and, in float32, on the CPU): token-identical,
    the same counters but the graphs', every pure-decode dispatch a
    replay."""
    cfg, params, eng = _card_engine(arch, dtype)
    outs = {"graph": _serve(eng, cfg.vocab_size)}
    g = dict(eng.stats)
    assert g["fused_iterations"] > 0
    assert g["decode_graph_replays"] == _pure_decode_dispatches(g) > 0
    eager = Engine(cfg, params, EngineConfig(**ECONF), device="cuda")
    eager._graphs = None
    outs["eager"] = _serve(eager, cfg.vocab_size)
    e = dict(eager.stats)
    assert e["decode_graph_replays"] == 0
    drop = ("decode_graph_replays", "decode_graph_captures")
    assert {k: v for k, v in g.items() if k not in drop} == \
        {k: v for k, v in e.items() if k not in drop}
    assert outs["graph"] == outs["eager"]
    if dtype == "float32":
        cpu = Engine(cfg, params, EngineConfig(**ECONF), device="cpu")
        assert _serve(cpu, cfg.vocab_size) == outs["graph"]
