"""The port's dense data plane and windowed model math against the JAX
package, on the same seeded float32 inputs and bridged parameters:

(a) the naive, blockwise and banded attention forms and the dispatch,
    with a sliding window, causal and with a query offset, and the
    windowed decode and extend attention;
(b) zoo.prefill, zoo.decode and zoo.extend on reduced raw mistral-7b
    (window 16: the decode cache is a ring that wraps) and on reduced
    smollm-360m;
(c) the Engine with paged=False on reduced smollm-360m and mistral-7b,
    and mistral-7b on the automatic plane, on a staggered shared-prefix
    stream (outputs, every stat and the prefix store's keys);
(d) fail() on a dense engine, then serving again;
(e) a 2-instance ClusterRuntime on the dense plane (placements and
    outputs), and the dense plane after a radix node split;
(f) the dense decode reaching the split-K decode kernel's wrapper once
    per layer per decode batch;
(g) the serve CLI with --arch mistral-7b on the CPU.

Tolerances: greedy tokens must be identical. Attention forms agree to
atol 1e-5 / rtol 1e-5 (inputs N(0, 1): float32 summation order only).
Cache leaves agree to an atol of 2e-5 of the leaf's largest |value|:
the JAX package's fan_in init gives K/V entries up to |x| ~ 27 and
scores of hundreds, so the two frameworks' float32 rounding of a score
moves a softmax weight by ~1e-5 relative, which the second layer's K/V
carry (measured up to 9e-6 of the largest entry).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.request import Request as JRequest
from repro.models import attention as jatt
from repro.models import zoo as jzoo
from repro.serving.cluster import ClusterRuntime as JCluster
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.core.cost_model import CostModel, HardwareSpec, \
    cost_model_for
from repro_torch.core.request import Request as TRequest
from repro_torch.models import attention as tatt
from repro_torch.models import zoo as tzoo
from repro_torch.serving.cluster import ClusterRuntime as TCluster
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

torch.set_num_threads(1)

ATT = dict(atol=1e-5, rtol=1e-5)
CACHE_RTOL = 2e-5

# Every JAX engine of this module serves one of two models, and its
# jitted functions depend only on that model and its parameters; later
# engines reuse the first engine's compiled functions, keyed by the
# parameters they close over (tests/test_torch_offload.py does the same).
# The reference's dense plane runs its prefill chunks through the eager
# ``api.extend``, whose group scan recompiles at every call; with
# ``jit_extend`` that function is jitted once per model and shared too
# (one scenario keeps the eager call).
_JIT_ATTRS = ("_decode_fn", "_decode_paged_fn", "_extend_paged_fn",
              "_mixed_paged_fn", "_copy_page_fn")
_JITS = {}


def _share_jits(jeng, jit_extend=True):
    for name in _JIT_ATTRS:
        if hasattr(jeng, name):
            key = (name, id(jeng.params))
            setattr(jeng, name, _JITS.setdefault(
                key, (jeng.params, getattr(jeng, name)))[1])
    if jit_extend:
        key = ("extend", id(jeng.params))
        jeng.api = dataclasses.replace(jeng.api, extend=_JITS.setdefault(
            key, (jeng.params, jax.jit(jeng.api.extend)))[1])
    return jeng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# (a) attention forms
# ---------------------------------------------------------------------------

def _qkv(Sq, Skv, seed, B=2, H=4, KH=2, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KH, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KH, D)).astype(np.float32))


FORMS = {
    "naive causal": (64, 64, "naive_attention",
                     dict(causal=True, window=16)),
    "naive offset": (32, 64, "naive_attention",
                     dict(causal=True, window=16, q_offset=32)),
    "naive full": (64, 64, "naive_attention", dict(causal=False)),
    "blockwise causal": (64, 64, "blockwise_attention",
                         dict(causal=True, window=16, q_block=16,
                              kv_block=16)),
    "blockwise offset": (32, 64, "blockwise_attention",
                         dict(causal=True, window=16, q_offset=32,
                              kv_block=16)),
    "blockwise ragged": (64, 60, "blockwise_attention",
                         dict(causal=True, window=0, kv_block=16)),
    "banded 16": (64, 64, "banded_attention", dict(window=16, q_block=16)),
    "banded 8": (64, 64, "banded_attention", dict(window=16, q_block=8)),
    "auto naive": (64, 64, "attention", dict(window=16)),
    "auto banded": (1536, 1536, "attention", dict(window=16)),
    "auto blockwise": (1536, 1536, "attention", dict()),
    "auto offset": (1024, 1536, "attention", dict(window=16,
                                                  q_offset=512)),
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_attention_forms_match_jax(name):
    Sq, Skv, fn, kw = FORMS[name]
    B = 1 if Skv > 64 else 2
    q, k, v = _qkv(Sq, Skv, seed=len(name), B=B)
    exp = getattr(jatt, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    got = getattr(tatt, fn)(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **ATT)


@pytest.mark.parametrize("window", [0, 8, 40])
def test_windowed_decode_and_extend_attention_match_jax(window):
    """decode with a window narrower than the cache takes the plain form,
    otherwise the kernel wrapper (its plain version on the CPU)."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    _, k, v = _qkv(1, 32, seed=window + 1, B=3)
    for clen in (np.array([1, 20, 32], np.int32), 24):
        np.testing.assert_allclose(
            tatt.decode_attention(_t(q), _t(k), _t(v), torch.as_tensor(clen),
                                  window=window).numpy(),
            np.asarray(jatt.decode_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(clen), window=window)), **ATT)
    qc, _, _ = _qkv(6, 32, seed=window + 2, B=3)
    start = np.array([0, 9, 26], np.int32)
    np.testing.assert_allclose(
        tatt.extend_attention(_t(qc), _t(k), _t(v), _t(start),
                              _t(start + 6), window=window).numpy(),
        np.asarray(jatt.extend_attention(
            jnp.asarray(qc), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(start), jnp.asarray(start + 6), window=window)),
        **ATT)


# ---------------------------------------------------------------------------
# (b) model entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["mistral-7b", "smollm-360m"])
def raw_model(request):
    """The reduced config as is (mistral keeps its window of 16)."""
    jcfg = dataclasses.replace(reduced(ARCHS[request.param]),
                               dtype="float32")
    tcfg = dataclasses.replace(treduced(TARCHS[request.param]),
                               dtype="float32")
    japi = jzoo.build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, japi, jparams, tzoo.build(tcfg), tparams


def _same_cache(tcache, jcache):
    for pj, c in jcache.items():
        for n, a in c.items():
            a = np.asarray(a)
            got = tcache[pj][n].numpy()
            assert got.shape == a.shape, (pj, n)
            np.testing.assert_allclose(
                got, a, rtol=0, atol=CACHE_RTOL * float(np.abs(a).max()))


def test_prefill_decode_extend_match_jax(raw_model):
    """A 40-token prompt, 8 decode steps (scalar pos, then [B] pos), and
    two extend chunks over a linear 64-position cache: for mistral the
    ring cache wraps and the extend crosses the window."""
    jcfg, japi, jparams, tapi, tparams = raw_model
    toks = np.random.default_rng(0).integers(1, 128, (2, 40)).astype(
        np.int32)
    jn, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tn, tc = tapi.prefill(tparams, {"tokens": _t(toks)})
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    ring = 16 if jcfg.sliding_window else 40
    assert tc["p0"]["k"].shape == (jcfg.n_groups, 2, ring, 1, 16)
    _same_cache(tc, jc)
    for i in range(8):
        pos = 40 + i
        if i < 4:
            jb, tb = jnp.int32(pos), pos
        else:
            jb = jnp.full((2,), pos, jnp.int32)
            tb = torch.full((2,), pos, dtype=torch.int32)
        jn, jc = japi.decode(jparams, jc, {"tokens": jn, "pos": jb})
        tn, tc = tapi.decode(tparams, tc, {"tokens": tn, "pos": tb})
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _same_cache(tc, jc)
    jx = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jzoo.build(dataclasses.replace(
                          jcfg, sliding_window=0)).cache_specs(2, 64))
    tx = {pj: {n: torch.zeros(s.shape, dtype=s.dtype)
               for n, s in c.items()}
          for pj, c in tzoo.build(dataclasses.replace(
              tapi.cfg, sliding_window=0)).cache_specs(2, 64).items()}
    assert {pj: {n: tuple(a.shape) for n, a in c.items()}
            for pj, c in tx.items()} == jax.tree.map(lambda a: a.shape, jx)
    for start, n in ((0, 24), (24, 24)):
        chunk = toks[:, start:start + n] if start + n <= 40 else \
            np.concatenate([toks[:, start:], toks[:, :start + n - 40]], 1)
        jn, jx = japi.extend(jparams, jx, {"tokens": jnp.asarray(chunk),
                                           "start": jnp.int32(start)})
        tn, tx = tapi.extend(tparams, tx, {"tokens": _t(chunk),
                                           "start": start})
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _same_cache(tx, jx)
    with pytest.raises(ValueError):
        tapi.extend(tparams, tx, {"tokens": _t(chunk), "start": 48})


def test_cache_specs_and_bytes_match_jax(raw_model):
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    jcfg, _, _, tapi, _ = raw_model
    for b, s in ((1, 8), (2, 64), (3, 1024)):
        jspec = JT.cache_specs(jcfg, b, s)
        tspec = tapi.cache_specs(b, s)
        assert {pj: {n: (x.shape, str(x.dtype).split(".")[-1])
                     for n, x in c.items()} for pj, c in tspec.items()} \
            == jax.tree.map(lambda x: (x.shape, str(x.dtype)), jspec)
        assert TT.cache_bytes(tapi.cfg, b, s) == JT.cache_bytes(jcfg, b, s)


def test_build_admits_windowed_stacks_without_paged_entries():
    api = tzoo.build(TARCHS["mistral-7b"])
    assert api.prefill and api.decode and api.extend
    for name in ("decode_paged", "extend_paged", "paged_cache_specs",
                 "mixed_paged", "mixed_paged_spec"):
        assert getattr(api, name) is None, name
    full = tzoo.build(dataclasses.replace(TARCHS["mistral-7b"],
                                          sliding_window=0))
    assert full.decode_paged is not None
    assert tzoo.build(TARCHS["mixtral-8x22b"]).decode_paged is None
    for arch in ("rwkv6-7b", "jamba-v0.1-52b", "whisper-tiny",
                 "llama-3.2-vision-11b"):
        api = tzoo.build(TARCHS[arch])
        assert api.prefill and api.decode, arch
        assert (api.extend is None) == (arch == "whisper-tiny"), arch
        for name in ("decode_paged", "extend_paged", "paged_cache_specs",
                     "mixed_paged", "mixed_paged_spec"):
            assert getattr(api, name) is None, (arch, name)


# ---------------------------------------------------------------------------
# (c)-(f) the dense plane: engine, failover, cluster, kernel wrapper
# ---------------------------------------------------------------------------

ENGINE_ARCHS = ["smollm-360m", "mistral-7b"]
_MODELS = {}


def _model(arch):
    """Reduced float32 configs of both packages (mistral-7b keeps its
    window: the engines remove it) and bridged parameters, built once."""
    if arch not in _MODELS:
        kw = dict(n_layers=2, dtype="float32")
        jcfg = dataclasses.replace(reduced(ARCHS[arch]), **kw)
        tcfg = dataclasses.replace(treduced(TARCHS[arch]), **kw)
        jparams = jzoo.build(jcfg).init(jax.random.PRNGKey(0))
        tparams = bridge.tree_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[arch] = (jcfg, jparams, tcfg, tparams)
    return _MODELS[arch]


# the engine counters the port has and the reference has not
PORT_ONLY = {"fused_slot_tokens", "decode_graph_replays",
             "decode_graph_captures"}

ECONF = dict(max_context=64, chunk_size=16, max_batch_tokens=64,
             capacity_tokens=4096, page_size=16)


def _stream(seed=1, shared_len=29, n=6, tail=8, out=4):
    """A shared 29-token prefix (not page-aligned) with unique tails: the
    first 2 requests run to completion, then the other n - 2 arrive."""
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, 128, shared_len).tolist())
    return [(shared + tuple(rng.integers(1, 128, tail).tolist()), out)
            for _ in range(n)]


def _serve(eng, Request, prompts, first=2, max_iters=2000):
    done, now = [], 0.0
    for waves in (prompts[:first], prompts[first:]):
        for toks, out in waves:
            eng.scheduler.enqueue(Request(tokens=toks, max_new_tokens=out),
                                  now)
        target = len(done) + len(waves)
        for _ in range(max_iters):
            if len(done) == target:
                break
            done += eng.step(now)
            now += 0.01
        assert len(done) == target, "requests did not finish"
    return {(r.tokens, r.max_new_tokens): list(r.output_tokens)
            for r in done}


def _engines(arch, paged, jit_extend=True):
    jcfg, jparams, tcfg, tparams = _model(arch)
    jeng = _share_jits(JEngine(jcfg, jparams,
                               JEngineConfig(paged=paged, **ECONF)),
                       jit_extend)
    teng = TEngine(tcfg, tparams, TEngineConfig(paged=paged, **ECONF),
                   device="cpu")
    return jeng, teng


def _same_engines(jeng, teng):
    assert teng.paged == jeng.paged
    # the port's counters more: the fused dispatches' slots, the padded
    # share's denominator (the reference counts only the pads), and the
    # pure-decode CUDA graphs' replays and captures
    assert set(teng.stats) - set(jeng.stats) == PORT_ONLY
    for k in teng.stats:
        if k not in PORT_ONLY:
            assert teng.stats[k] == jeng.stats[k], k
    # (its value is held to each fused dispatch's tensors in
    # test_torch_spans.py)
    assert (teng.stats["fused_slot_tokens"] > 0) == \
        (jeng.stats["fused_iterations"] > 0)
    assert teng.stats["fused_slot_tokens"] >= \
        teng.stats["fused_padded_tokens"]
    if not teng.paged:
        assert set(teng.kv_store) == set(jeng.kv_store)
        assert teng.stats["cache_concat_calls"] > 0


@pytest.mark.parametrize("arch,paged", [("smollm-360m", False),
                                        ("mistral-7b", False),
                                        ("mistral-7b", None)])
def test_engine_planes_match_jax_engine(arch, paged):
    """paged=False on both models (smollm-360m against the reference's
    eager prefill chunks); the automatic plane (paged fused, the window
    removed as the reference removes it) on mistral-7b."""
    jeng, teng = _engines(arch, paged, jit_extend=arch != "smollm-360m")
    prompts = _stream()
    assert _serve(teng, TRequest, prompts) == _serve(jeng, JRequest, prompts)
    _same_engines(jeng, teng)
    assert teng.stats["reused_tokens"] > 0
    assert teng.paged == (paged is None)
    teng.pool.check_invariants()


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_dense_fail_then_serve_again(arch):
    """fail() drops the caches, the prefix store and the accounting; the
    engine then serves the stream as the reference does."""
    jeng, teng = _engines(arch, False)
    prompts = _stream(seed=4)
    outs = {}
    for eng, Request in ((jeng, JRequest), (teng, TRequest)):
        for toks, out in prompts[:3]:
            eng.scheduler.enqueue(Request(tokens=toks, max_new_tokens=out),
                                  0.0)
        for i in range(3):
            eng.step(0.01 * i)
        assert eng.kv_store or eng.live
        assert len(eng.fail()) == 3
        assert not eng.kv_store and not eng.live
        assert eng.pool.used_pages == 0
        eng.failed = False
        outs[eng] = _serve(eng, Request, prompts)
    assert outs[teng] == outs[jeng]
    _same_engines(jeng, teng)


def _one_by_one(eng, Request, prompts):
    """Serve each prompt alone; returns [(outputs, tokens reused)]."""
    now, res = 0.0, []
    for toks in prompts:
        r = Request(tokens=toks, max_new_tokens=4)
        reused = eng.stats["reused_tokens"]
        eng.scheduler.enqueue(r, now)
        done = []
        while not done:
            done = eng.step(now)
            now += 0.01
        res.append((list(r.output_tokens), eng.stats["reused_tokens"]
                    - reused))
    return res


def test_dense_plane_follows_the_reference_after_a_split():
    """The reference's dense plane files a node's KV slab under its path
    key, and a split keeps that key on the tail: S+T1 stores one node,
    S+T2 splits it (the new head has no slab, so nothing is reused), and
    S+T1+more then seeds the tail's positions from the pre-split slab,
    which starts at the node's first token. The port follows the
    reference (token-identical, the same reuse), so its dense plane
    reuses and answers differently from its paged plane here (ROADMAP
    queue 3). Fixing the fault changes this test together with the
    reference."""
    jcfg, jparams, tcfg, tparams = _model("smollm-360m")
    rng = np.random.default_rng(0)
    S, T1, T2, more = (tuple(rng.integers(1, 128, n).tolist())
                       for n in (20, 12, 12, 6))
    prompts = [S + T1, S + T2, S + T1 + more]
    jeng = _share_jits(JEngine(jcfg, jparams,
                               JEngineConfig(paged=False, **ECONF)))
    dense = _one_by_one(TEngine(tcfg, tparams,
                                TEngineConfig(paged=False, **ECONF),
                                device="cpu"), TRequest, prompts)
    assert dense == _one_by_one(jeng, JRequest, prompts)
    paged = _one_by_one(TEngine(tcfg, tparams, TEngineConfig(**ECONF),
                                device="cpu"), TRequest, prompts)
    assert [n for _, n in dense] == [0, 0, 32]
    assert [n for _, n in paged] == [0, 20, 32]
    assert dense[2][0] != paged[2][0]


def _run_cluster(cl, Request, prompts):
    """tests/test_torch_cluster.py's scenario: submit all, a few steps,
    fail instance 0 mid-flight, run to the end."""
    reqs = [Request(tokens=p, max_new_tokens=4) for p in prompts]
    for r in reqs:
        cl.submit(r, 0.0)
    placed = [r.instance for r in reqs]
    t = 0.0
    for _ in range(4):
        cl.step(t)
        t += 0.01
    cl.check_invariants()
    cl.fail_instance(0, t)
    for _ in range(1500):
        cl.step(t)
        t += 0.01
        if all(r.state.value == "finished" for r in reqs):
            break
    assert all(r.state.value == "finished" for r in reqs)
    cl.check_invariants()
    return placed, [r.instance for r in reqs], \
        [list(r.output_tokens) for r in reqs]


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_dense_cluster_matches_jax_cluster(arch):
    jcfg, jparams, tcfg, tparams = _model(arch)
    econf = dict(ECONF, capacity_tokens=512, paged=False)
    jcl = JCluster(jcfg, jparams, num_instances=2,
                   engine_cfg=JEngineConfig(**econf))
    for e in jcl.engines.values():
        _share_jits(e)
    cm = CostModel(hw=HardwareSpec(**dataclasses.asdict(JHardwareSpec())),
                   model=cost_model_for("smollm-360m").model)
    tcl = TCluster(tcfg, tparams, num_instances=2,
                   engine_cfg=TEngineConfig(**econf), cost_model=cm,
                   device="cpu")
    rng = np.random.default_rng(11)
    shared = tuple(rng.integers(1, 128, 24).tolist())
    prompts = [shared + tuple(rng.integers(1, 128, 8).tolist())
               for _ in range(8)]
    assert _run_cluster(tcl, TRequest, prompts) \
        == _run_cluster(jcl, JRequest, prompts)
    assert all(not e.paged for e in tcl.engines.values())
    assert not tcl.gs.instances[0].alive


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_dense_decode_calls_the_split_k_kernel_wrapper(arch, monkeypatch):
    """Each decode batch reaches the kernel wrapper once per layer; the
    paged plane never calls it."""
    _, _, tcfg, tparams = _model(arch)
    calls = [0]
    wrapped = tatt._split_k_decode

    def counting(*a, **kw):
        calls[0] += 1
        return wrapped(*a, **kw)
    monkeypatch.setattr(tatt, "_split_k_decode", counting)
    for paged in (False, True):
        calls[0] = 0
        eng = TEngine(tcfg, tparams, TEngineConfig(paged=paged, **ECONF),
                      device="cpu")
        _serve(eng, TRequest, _stream(seed=2))
        want = tcfg.n_layers * eng.stats["decode_batches"] if not paged \
            else 0
        assert calls[0] == want and eng.stats["decode_batches"] > 0


# ---------------------------------------------------------------------------
# (g) the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_runs_mistral_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", "mistral-7b", "--reduced", "--device", "cpu",
                      "--instances", "2", "--requests", "6",
                      "--max-context", "64"])
    assert len(res["done"]) == 6
    assert all(r.state.value == "finished" for r in res["done"])
    assert res["cfg"].sliding_window == 16
    assert "finished=6/6" in capsys.readouterr().out
