"""The port's MoE FFNs against the JAX package, on the same seeded
float32 inputs and bridged parameters:

(a) layers.moe_full (capacity 2E: no drops, and capacity 1.25 with a
    skewed router: drops), moe_step, moe_extend and the ep_decode branch
    of the step tail against ``repro.models.layers`` / ``transformer``;
    the shard-local forms (experts split at TP 2 and 4, expert ff
    columns at TP 8) against moe_step;
(b) moe_a2a.moe_halfexpert against the reference's on conftest's
    8-device mesh, ("data", "model") = (2, 4) and (4, 2), and against
    moe_full;
(c) zoo.prefill, decode and extend on reduced grok-1-314b and
    mixtral-8x22b (window 16: the ring cache wraps) against the JAX
    package, and their own consistency (incremental and chunked ==
    full), as tests/test_consistency.py checks the reference;
(d) the Engine on the paged and the dense plane, and at TP 2 and 4,
    against the JAX engines: outputs and every stat identical;
(e) the serve CLI with both archs on the CPU.

Tolerances: greedy tokens must be identical. The MoE layers agree to
atol 2e-5 x the largest |reference output| (float32: the port sums each
expert's products in another order and its pairs grouped by expert).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core.request import Request as JRequest
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import moe_a2a as jmoe
from repro.models import transformer as jtrans
from repro.models import zoo as jzoo
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.core.request import Request as TRequest
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import moe_a2a as tmoe
from repro_torch.models import transformer as ttrans
from repro_torch.models import zoo as tzoo
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

torch.set_num_threads(1)

MOE_ARCHS = ("grok-1-314b", "mixtral-8x22b")
RTOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, exp):
    exp = np.asarray(exp)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                               atol=RTOL * float(np.abs(exp).max()))


def _cfgs(arch="mixtral-8x22b", **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(reduced(ARCHS[arch]), **kw),
            dataclasses.replace(treduced(TARCHS[arch]), **kw))


def _ffn_params(cfg, seed, skew=0.0):
    """Standard-layout MoE weights (numpy, float32); ``skew`` adds a
    bias towards expert 0 on a constant direction of the router, so
    capacity overflows."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    router = rng.standard_normal((d, E)).astype(np.float32) / np.sqrt(d)
    router[:, 0] += skew / d
    return {"router": router,
            "wg": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(
                np.float32),
            "wu": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(
                np.float32),
            "wd": (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(
                np.float32)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


# ---------------------------------------------------------------------------
# (a) the MoE layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [None, 1.25])
def test_moe_full_matches_jax(capacity):
    """x [3, 16, d] through the capacity dispatch; at capacity 1.25 a
    skewed router overflows expert 0, and the dropped pairs must be the
    reference's ((s, k) order)."""
    kw = {} if capacity is None else {"capacity_factor": capacity}
    jcfg, tcfg = _cfgs(**kw)
    p = _ffn_params(tcfg, 0, skew=0.0 if capacity is None else 40.0)
    x = np.random.default_rng(1).standard_normal(
        (3, 16, tcfg.d_model)).astype(np.float32)
    jp, tp = _both(p)
    exp = jlayers.moe_full(jp, jcfg, jnp.asarray(x))
    _close(tlayers.moe_full(tp, tcfg, _t(x)), exp)
    K, E = tcfg.experts_per_token, tcfg.n_experts
    cap = max(int(tcfg.capacity_factor * 16 * K / E), K)
    top = np.argsort(-(x @ p["router"]), -1)[..., :K]
    per = np.stack([(top == e).sum((1, 2)) for e in range(E)], 1)
    assert (per.max() > cap) == (capacity is not None), (per, cap)


@pytest.mark.parametrize("B", [1, 5])
def test_moe_step_and_extend_match_jax(B):
    jcfg, tcfg = _cfgs()
    p = _ffn_params(tcfg, 2)
    jp, tp = _both(p)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, tcfg.d_model)).astype(np.float32)
    _close(tlayers.moe_step(tp, tcfg, _t(x)),
           jlayers.moe_step(jp, jcfg, jnp.asarray(x)))
    xc = rng.standard_normal((B, 7, tcfg.d_model)).astype(np.float32)
    _close(tlayers.moe_extend(tp, tcfg, _t(xc)),
           jlayers.moe_extend(jp, jcfg, jnp.asarray(xc)))


def test_ep_decode_step_tail_matches_jax():
    """The step tail under ep_decode (moe_full at S = 1) against the
    reference's, and against the routed tail (both dropless)."""
    jcfg, tcfg = _cfgs()
    p = _ffn_params(tcfg, 4)
    norm = np.random.default_rng(5).uniform(0.5, 1.5, tcfg.d_model).astype(
        np.float32)
    x = np.random.default_rng(6).standard_normal(
        (6, tcfg.d_model)).astype(np.float32)
    jp, tp = _both(p)
    jpos = jtrans.PosPlan("attn", "moe")
    tpos = ttrans.PosPlan("attn", "moe")
    routed = ttrans._ffn_step_tail({"norm2": _t(norm), "ffn": tp}, tcfg,
                                   tpos, _t(x))
    try:
        jcommon.set_ep_decode(True)
        tcommon.set_ep_decode(True)
        exp = jtrans._ffn_step_tail({"norm2": jnp.asarray(norm), "ffn": jp},
                                    jcfg, jpos, jnp.asarray(x))
        got = ttrans._ffn_step_tail({"norm2": _t(norm), "ffn": tp}, tcfg,
                                    tpos, _t(x))
    finally:
        jcommon.set_ep_decode(False)
        tcommon.set_ep_decode(False)
    _close(got, exp)
    _close(routed, np.asarray(exp))


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_moe_tp_matches_moe_step(tp):
    """The shard-local MoE on the pieces ``shard_params`` cuts: E 4 at
    TP 2 and 4 splits whole experts, at TP 8 every expert's ff columns
    (serve_policy's arms); the all-reduced output equals moe_step's."""
    from repro_torch.launch import sharding as S
    _, tcfg = _cfgs(n_layers=1)
    params = tzoo.build(tcfg).init(torch.Generator().manual_seed(7), "cpu")
    mesh = tmesh.make_serve_mesh(tp, platform="cpu")
    api = tzoo.build(tcfg)
    shards = S.shard_params(params, api.specs, mesh,
                            S.serve_policy(mesh, api.n_bytes))
    plan = api.shard_plan(mesh, 16, 16)
    assert (plan.experts, plan.expert_ff) == (tp <= 4, tp == 8)
    ffn = [tree["stack"]["p0"]["ffn"] for tree in shards]
    for f in ffn:
        assert f["wg"].shape[1] == (tcfg.n_experts // tp if tp <= 4
                                    else tcfg.n_experts)
    x = torch.randn(2, 5, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(8))
    got = tlayers.moe_tp([{k: v[0] for k, v in f.items()} for f in ffn],
                         tcfg, [x] * tp, plan)
    exp = tlayers.moe_extend({k: v[0] for k, v in
                              params["stack"]["p0"]["ffn"].items()}, tcfg, x)
    assert len(got) == tp
    for g in got:
        torch.testing.assert_close(g, exp, rtol=0,
                                   atol=RTOL * float(exp.abs().max()))


def test_routed_forms_never_gather_expert_weights(monkeypatch):
    """moe_step runs one product per expert hit on that expert's own
    weights (views of the [E, d, f] leaves, never a per-token copy) and
    reads the per-expert counts back once."""
    _, tcfg = _cfgs()
    tp = _both(_ffn_params(tcfg, 9))[1]
    seen = []
    orig = tlayers._expert_ffn

    def spy(x, wg, wu, wd):
        seen.append((x.shape[0], wg.shape, wg.data_ptr()))
        return orig(x, wg, wu, wd)
    monkeypatch.setattr(tlayers, "_expert_ffn", spy)
    before = dict(tlayers.MOE_STATS)
    x = torch.randn(6, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    tlayers.moe_step(tp, tcfg, x)
    base, step = tp["wg"].data_ptr(), tp["wg"][0].numel() * 4
    assert sum(n for n, _, _ in seen) == 6 * tcfg.experts_per_token
    assert all(shape == tp["wg"].shape[1:] and (ptr - base) % step == 0
               for _, shape, ptr in seen)
    assert tlayers.MOE_STATS["host_syncs"] - before["host_syncs"] == 1
    assert (tlayers.MOE_STATS["expert_products"]
            - before["expert_products"]) == len(seen)


# ---------------------------------------------------------------------------
# (b) the half-expert path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_moe_halfexpert_matches_jax(shape):
    """tests/test_moe_a2a.py's case (E 2, K 2, capacity 16): split factors
    s = 2 and 1; the port on an emulated (data, model) mesh of CPU
    devices against the reference on conftest's 8 devices, and against
    the port's own moe_full."""
    jcfg, tcfg = _cfgs(n_experts=2, experts_per_token=2,
                       capacity_factor=16.0)
    p = _ffn_params(tcfg, 10)
    x = np.random.default_rng(11).standard_normal(
        (4, 16, tcfg.d_model)).astype(np.float32)
    dp, tp = shape
    hp = dict(zip(("wg", "wu", "wd"), tmoe.reshape_standard_to_halfexpert(
        _t(p["wg"]), _t(p["wu"]), _t(p["wd"]), tp)))
    jhp = jmoe.reshape_standard_to_halfexpert(
        jnp.asarray(p["wg"]), jnp.asarray(p["wu"]), jnp.asarray(p["wd"]), tp)
    for a, b in zip(("wg", "wu", "wd"), jhp):
        np.testing.assert_array_equal(hp[a].numpy(), np.asarray(b))
    hp["router"] = _t(p["router"])
    jcfg2 = dataclasses.replace(jcfg, moe_impl="halfexpert", moe_tp=tp)
    tcfg2 = dataclasses.replace(tcfg, moe_impl="halfexpert", moe_tp=tp)
    assert tmoe.applicable(tcfg, tp) == jmoe.applicable(jcfg, tp) is True
    assert {k: (v.shape, v.axes, v.dtype or "bfloat16") for k, v in
            tmoe.moe_halfexpert_specs(tcfg, tp).items()} \
        == {k: (v.shape, v.axes, v.dtype) for k, v in
            jmoe.moe_halfexpert_specs(jcfg, tp).items()}
    mesh_kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
               if hasattr(jax.sharding, "AxisType") else {})
    jmesh = jax.make_mesh(shape, ("data", "model"), **mesh_kw)
    exp = jmoe.moe_halfexpert(
        {"router": jnp.asarray(p["router"]), "wg": jhp[0], "wu": jhp[1],
         "wd": jhp[2]}, jcfg2, jnp.asarray(x), jmesh)
    mesh = tmesh.make_mesh(dp, tp, platform="cpu")
    assert mesh.shape == {"data": dp, "model": tp}
    got = tmoe.moe_halfexpert(hp, tcfg2, _t(x), mesh)
    _close(got, exp)
    _close(got, np.asarray(tlayers.moe_full(_both(p)[1], tcfg, _t(x))))


def test_halfexpert_full_forward_on_the_ambient_mesh():
    """forward_full of a half-expert stack runs moe_halfexpert on the
    mesh set in models.common (and refuses without one), giving the
    standard stack's tokens on the same weights; the routed step forms
    refuse the layout loudly."""
    _, std = _cfgs(n_layers=1)
    half = dataclasses.replace(std, moe_impl="halfexpert", moe_tp=4)
    params = tzoo.build(std).init(torch.Generator().manual_seed(0), "cpu")
    f = params["stack"]["p0"]["ffn"]
    split = tmoe.reshape_standard_to_halfexpert(f["wg"][0], f["wu"][0],
                                                f["wd"][0], 4)
    hf = dict(f, **{n: w[None] for n, w in zip(("wg", "wu", "wd"), split)})
    hparams = {"embed": params["embed"],
               "stack": {"p0": dict(params["stack"]["p0"], ffn=hf)}}
    api = tzoo.build(half)
    assert {n: tuple(w.shape) for n, w in hf.items()} == {
        n: s.shape for n, s in api.specs["stack"]["p0"]["ffn"].items()}
    toks = torch.randint(1, std.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError):
        api.prefill(hparams, {"tokens": toks})
    try:
        tcommon.set_mesh(tmesh.make_mesh(2, 4, platform="cpu"))
        nxt, _ = api.prefill(hparams, {"tokens": toks})
    finally:
        tcommon.set_mesh(None)
    ref, _ = tzoo.build(std).prefill(params, {"tokens": toks})
    assert torch.equal(nxt, ref)
    with pytest.raises(NotImplementedError):
        tlayers.moe_step({n: w[0] for n, w in hf.items()}, half,
                         torch.zeros(1, half.d_model))


# ---------------------------------------------------------------------------
# (c) raw model entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def raw_model(request):
    """The reduced config as is (mixtral keeps its window of 16)."""
    jcfg, tcfg = _cfgs(request.param)
    japi = jzoo.build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, japi, jparams, tzoo.build(tcfg), tparams


def test_prefill_decode_extend_match_jax(raw_model):
    """A 40-token prompt and 8 decode steps (for mixtral the ring cache
    wraps), then two 24-token extend chunks on a linear cache: tokens
    identical to the reference's at every step; incremental decode and
    the chunked extend give the one-shot prefill's token."""
    jcfg, japi, jparams, tapi, tparams = raw_model
    toks = np.random.default_rng(0).integers(1, 128, (2, 48)).astype(
        np.int32)
    jn, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :40])})
    tn, tc = tapi.prefill(tparams, {"tokens": _t(toks[:, :40])})
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    ring = 16 if jcfg.sliding_window else 40
    assert tc["p0"]["k"].shape[2] == ring
    if not jcfg.sliding_window:
        tc = {pj: {n: torch.cat([a, torch.zeros_like(a[:, :, :8])], 2)
                   for n, a in c.items()} for pj, c in tc.items()}
        jc = {pj: {n: jnp.pad(a, ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0)))
                   for n, a in c.items()} for pj, c in jc.items()}
    for i in range(8):
        feed = toks[:, 40 + i]
        jn, jc = japi.decode(jparams, jc, {"tokens": jnp.asarray(feed),
                                           "pos": jnp.int32(40 + i)})
        tn, tc = tapi.decode(tparams, tc, {"tokens": _t(feed),
                                           "pos": 40 + i})
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    full, _ = tapi.prefill(tparams, {"tokens": _t(toks)})
    assert torch.equal(tn, full), "decode != prefill"
    lin = dataclasses.replace(tapi.cfg, sliding_window=0)
    tlin = tzoo.build(lin)
    jlin = jzoo.build(dataclasses.replace(jcfg, sliding_window=0))
    full, _ = tlin.prefill(tparams, {"tokens": _t(toks)})
    tx = {pj: {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in c.items()}
          for pj, c in tlin.cache_specs(2, 48).items()}
    jx = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jlin.cache_specs(2, 48))
    for start in (0, 24):
        chunk = toks[:, start:start + 24]
        jn, jx = jlin.extend(jparams, jx, {"tokens": jnp.asarray(chunk),
                                           "start": jnp.int32(start)})
        tn, tx = tlin.extend(tparams, tx, {"tokens": _t(chunk),
                                           "start": start})
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert torch.equal(tn, full), "extend != prefill"


# ---------------------------------------------------------------------------
# (d) engines
# ---------------------------------------------------------------------------

STATS = ("reused_tokens", "prefilled_tokens", "model_dispatches",
         "iterations", "fused_iterations", "fused_padded_tokens",
         "seed_aliased_pages", "seed_copied_pages", "decode_batches",
         "decode_steps")

# The JAX engines of this module jit their dispatches afresh; the first
# engine's functions for given parameters and TP degree are handed to
# later ones (tests/test_torch_spmd.py does the same), and the dense
# plane's eager ``api.extend`` is jitted once per model
# (tests/test_torch_dense.py).
_JIT_ATTRS = ("_decode_fn", "_decode_paged_fn", "_extend_paged_fn",
              "_mixed_paged_fn", "_copy_page_fn", "_gather_pages_fn",
              "_scatter_tokens_fn")
_JITS = {}
_MODELS = {}


def _share_jits(jeng):
    for name in _JIT_ATTRS:
        if hasattr(jeng, name):
            key = (name, id(jeng.params), jeng.chips)
            setattr(jeng, name, _JITS.setdefault(
                key, (jeng.params, getattr(jeng, name)))[1])
    if not jeng.paged:
        key = ("extend", id(jeng.params))
        jeng.api = dataclasses.replace(jeng.api, extend=_JITS.setdefault(
            key, (jeng.params, jax.jit(jeng.api.extend)))[1])
    return jeng


def _model(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch, n_layers=2)
        jparams = jzoo.build(jcfg).init(jax.random.PRNGKey(0))
        tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu")
        _MODELS[arch] = (jcfg, jparams, tcfg, tparams)
    return _MODELS[arch]


def _stream(seed=1, shared_len=29, n=6, tail=8, out=4):
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, 128, shared_len).tolist())
    return [(shared + tuple(rng.integers(1, 128, tail).tolist()), out)
            for _ in range(n)]


def _serve(eng, Request, prompts, first=2, max_iters=2000):
    done, now = [], 0.0
    for wave in (prompts[:first], prompts[first:]):
        for toks, out in wave:
            eng.scheduler.enqueue(Request(tokens=toks, max_new_tokens=out),
                                  now)
        target = len(done) + len(wave)
        for _ in range(max_iters):
            if len(done) == target:
                break
            done += eng.step(now)
            now += 0.01
        assert len(done) == target, "requests did not finish"
    return {(r.tokens, r.max_new_tokens): list(r.output_tokens)
            for r in done}


@pytest.mark.parametrize("arch,paged,chips", [
    ("grok-1-314b", None, 1), ("mixtral-8x22b", None, 1),
    ("mixtral-8x22b", False, 1), ("grok-1-314b", False, 1),
    ("grok-1-314b", None, 2), ("grok-1-314b", None, 4),
    ("mixtral-8x22b", None, 2), ("mixtral-8x22b", None, 4)])
def test_engine_matches_jax_engine(arch, paged, chips):
    """Reduced float32 grok-1-314b and mixtral-8x22b (E 4, top 2) on the
    paged fused plane, the dense plane, and tensor-parallel at TP 2 and
    4 (2 and 1 experts a shard, slot-wise pools): outputs and stats
    identical to the JAX engine's; the TP engines token-identical to
    the single-chip one."""
    jcfg, jparams, tcfg, tparams = _model(arch)
    ec = dict(max_context=64, chunk_size=16, max_batch_tokens=64,
              capacity_tokens=4096 // chips, page_size=16, paged=paged,
              chips_per_instance=chips)
    jeng = _share_jits(JEngine(jcfg, jparams, JEngineConfig(**ec)))
    teng = TEngine(tcfg, tparams, TEngineConfig(**ec), device="cpu")
    prompts = _stream()
    tout = _serve(teng, TRequest, prompts)
    assert tout == _serve(jeng, JRequest, prompts)
    for k in STATS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["reused_tokens"] > 0
    assert teng.paged == (paged is None)
    if chips > 1:
        assert teng.plan.experts and not teng.plan.expert_ff
        assert teng.params[0]["stack"]["p0"]["ffn"]["wg"].shape[1] \
            == tcfg.n_experts // chips
        one = TEngine(tcfg, tparams, TEngineConfig(**dict(
            ec, chips_per_instance=1, capacity_tokens=4096)), device="cpu")
        assert _serve(one, TRequest, prompts) == tout
    teng.pool.check_invariants()


# ---------------------------------------------------------------------------
# (e) the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_runs_moe_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--instances", "2", "--requests", "4",
                      "--max-context", "48"])
    assert len(res["done"]) == 4
    assert res["cfg"].n_experts == 4
    assert "finished=4/4" in capsys.readouterr().out
