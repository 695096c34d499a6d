"""The port's recurrent, hybrid and cross-attention stacks against the JAX
package, on the same seeded float32 inputs and parameters (drawn with
numpy, in the specs' shapes and init kinds):

(a) ``mamba_full`` (S below d_conv - 1, a prime S, S below and above the
    chunk, continued from a cache) and ``mamba_step``; the RWKV-6 time
    and channel forms (full, continued, step); ``cross_attn_full`` /
    ``_extend`` / ``_step``;
(b) zoo.prefill / decode / extend of reduced rwkv6-7b, jamba-v0.1-52b and
    llama-3.2-vision-11b (with vision tokens): incremental decode equals
    a full prefill, chunked extension equals a one-shot prefill, and both
    packages give identical tokens at every step; whisper-tiny's prefill
    and decode the same way;
(c) the dense engines on the snapshot-reuse scenario
    (``tests/test_engine_cluster.py::test_recurrent_state_snapshot_reuse``)
    for jamba and rwkv6, and a VLM dense engine: outputs, every stat and
    the snapshot store's keys identical; a stored snapshot is not changed
    by the requests that reused it;
(d) a 2-instance E2 cluster of reduced rwkv6 with a failover: placements
    and outputs identical;
(e) the serve CLI with --arch rwkv6-7b --reduced on the CPU against the
    JAX CLI's lines (all but the wall clock);
(f) ``ModelAPI.n_bytes``, ``n_params`` and ``n_active_params`` of all 12
    configs at full width, from specs (no weights drawn), and what
    ``build`` gives for the new stacks.

Tolerances: greedy tokens, engine stats, placements and CLI lines must be
identical. The layer functions agree to atol 2e-5 + rtol 2e-5 of the
reference (float32 inputs N(0, 1)): the mamba scan sums its recurrence
sequentially where the reference runs an associative scan, and the RWKV
chunk sums run in another order; measured differences are below 3e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core.request import Request as JRequest
from repro.models import layers as jL
from repro.models import mamba as jM
from repro.models import rwkv6 as jR
from repro.models import zoo as jzoo
from repro.serving.cluster import ClusterRuntime as JCluster
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.core.request import Request as TRequest
from repro_torch.models import layers as tL
from repro_torch.models import mamba as tM
from repro_torch.models import rwkv6 as tR
from repro_torch.models import zoo as tzoo
from repro_torch.serving.cluster import ClusterRuntime as TCluster
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

torch.set_num_threads(1)

# the engine counters the port has and the reference has not
PORT_ONLY = {"fused_slot_tokens", "decode_graph_replays",
             "decode_graph_captures"}

TOL = dict(atol=2e-5, rtol=2e-5)
RECURRENT = ["rwkv6-7b", "jamba-v0.1-52b"]
STACKS = RECURRENT + ["llama-3.2-vision-11b"]
_MODELS = {}


def _np_params(cfg, seed):
    """float32 parameters drawn with numpy from the seed, with the shapes
    and init kinds of the specs (``bridge.param_specs``, which hold the
    JAX package's): the same arrays go to both packages, and no JAX
    init is compiled."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if tree.init in ("zeros", "ones"):
            return np.full(tree.shape, tree.init == "ones", np.float32)
        scale = (1.0 / np.sqrt(tree.shape[-2]) if tree.init == "fan_in"
                 else tree.scale)
        return (scale * rng.standard_normal(tree.shape)).astype(np.float32)

    return walk(bridge.param_specs(cfg))


def _model(arch):
    """Reduced float32 configs of both packages and their parameters
    (``_np_params``), built once."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
        tcfg = dataclasses.replace(treduced(TARCHS[arch]), dtype="float32")
        params = _np_params(tcfg, 0)
        _MODELS[arch] = (jcfg, jax.tree.map(jnp.asarray, params), tcfg,
                         bridge.tree_from_numpy(params, "cpu"))
    return _MODELS[arch]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def _layer(arch, pj, name):
    """Group 0's leaves of one position's sub-tree, both packages."""
    _, jparams, _, tparams = _model(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["stack"][pj][name])
    tp = {k: v[0] for k, v in tparams["stack"][pj][name].items()}
    return jp, tp


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# (a) the mixers and cross-attention
# ---------------------------------------------------------------------------

# (S, split): S tokens, continued from a cache after `split` of them
SCANS = [(2, None), (13, None), (128, None), (40, 39), (20, 1)]


@pytest.mark.parametrize("S,split", SCANS)
def test_mamba_full_matches_jax(S, split):
    """d_conv 4: S 2 is below d_conv - 1 (the conv history is padded);
    13 is prime (chunk 1) and below the 64-token chunk, 128 spans two; a
    split resumes from the first part's cache (its conv history shorter
    than d_conv - 1 when split is 1; 39 and 1 are below the chunk)."""
    jcfg, _, tcfg, _ = _model("jamba-v0.1-52b")
    jp, tp = _layer("jamba-v0.1-52b", "p0", "mamba")
    x = _x(2, S, jcfg.d_model, seed=S)
    if split is None:
        jy, jc = jM.mamba_full(jp, jcfg, jnp.asarray(x))
        ty, tc = tM.mamba_full(tp, tcfg, _t(x))
    else:
        _, jc0 = jM.mamba_full(jp, jcfg, jnp.asarray(x[:, :split]))
        jy, jc = jM.mamba_full(jp, jcfg, jnp.asarray(x[:, split:]),
                               cache=jc0)
        _, tc0 = tM.mamba_full(tp, tcfg, _t(x[:, :split]))
        ty, tc = tM.mamba_full(tp, tcfg, _t(x[:, split:]), cache=tc0)
        assert tc is tc0                        # written in place
        ty_all, tc_all = tM.mamba_full(tp, tcfg, _t(x))
        _close(ty, ty_all[:, split:].detach().numpy())
        _close(tc, {k: v.detach().numpy() for k, v in tc_all.items()})
    _close(ty, jy)
    _close(tc, jc)
    assert tc["ssm"].dtype == torch.float32


def test_mamba_step_matches_jax():
    jcfg, _, tcfg, _ = _model("jamba-v0.1-52b")
    jp, tp = _layer("jamba-v0.1-52b", "p1", "mamba")
    x = _x(3, 9, jcfg.d_model, seed=5)
    _, jc = jM.mamba_full(jp, jcfg, jnp.asarray(x[:, :6]))
    _, tc = tM.mamba_full(tp, tcfg, _t(x[:, :6]))
    for t in range(6, 9):
        jy, jc = jM.mamba_step(jp, jcfg, jnp.asarray(x[:, t]), jc)
        ty, tc = tM.mamba_step(tp, tcfg, _t(x[:, t]), tc)
        _close(ty, jy)
        _close(tc, jc)
    # the steps continue the scan exactly where the chunk form would
    ty_all, tc_all = tM.mamba_full(tp, tcfg, _t(x))
    _close(ty, ty_all[:, -1].detach().numpy())


@pytest.mark.parametrize("S,split", [(1, None), (13, None), (40, 8),
                                     (5, 1)])
def test_rwkv_time_and_channel_full_match_jax(S, split):
    """pick_chunk(S, 16): 1 token, a prime (chunks of 1); splits resume
    from the first part's state and shifts (8 tokens in one chunk, then
    32 in two of 16)."""
    jcfg, _, tcfg, _ = _model("rwkv6-7b")
    jt, tt = _layer("rwkv6-7b", "p0", "time")
    jch, tch = _layer("rwkv6-7b", "p0", "channel")
    x = _x(2, S, jcfg.d_model, seed=S + 100)
    pairs = ((jR.rwkv_time_full, tR.rwkv_time_full, jt, tt),
             (jR.rwkv_channel_full, tR.rwkv_channel_full, jch, tch))
    for jf, tf, jp, tp in pairs:
        if split is None:
            jy, jc = jf(jp, jcfg, jnp.asarray(x))
            ty, tc = tf(tp, tcfg, _t(x))
        else:
            _, jc0 = jf(jp, jcfg, jnp.asarray(x[:, :split]))
            jy, jc = jf(jp, jcfg, jnp.asarray(x[:, split:]), cache=jc0)
            _, tc0 = tf(tp, tcfg, _t(x[:, :split]))
            ty, tc = tf(tp, tcfg, _t(x[:, split:]), cache=tc0)
            assert tc is tc0
        _close(ty, jy)
        _close(tc, jc)


def test_rwkv_steps_match_jax():
    jcfg, _, tcfg, _ = _model("rwkv6-7b")
    jt, tt = _layer("rwkv6-7b", "p0", "time")
    jch, tch = _layer("rwkv6-7b", "p0", "channel")
    x = _x(3, 10, jcfg.d_model, seed=7)
    _, jc = jR.rwkv_time_full(jt, jcfg, jnp.asarray(x[:, :7]))
    _, tc = tR.rwkv_time_full(tt, tcfg, _t(x[:, :7]))
    jcc = {"shift_c": jnp.asarray(x[:, 6])}
    tcc = {"shift_c": _t(x[:, 6])}
    for t in range(7, 10):
        jy, jc = jR.rwkv_time_step(jt, jcfg, jnp.asarray(x[:, t]), jc)
        ty, tc = tR.rwkv_time_step(tt, tcfg, _t(x[:, t]), tc)
        _close(ty, jy)
        _close(tc, jc)
        jy, jcc = jR.rwkv_channel_step(jch, jcfg, jnp.asarray(x[:, t]), jcc)
        ty, tcc = tR.rwkv_channel_step(tch, tcfg, _t(x[:, t]), tcc)
        _close(ty, jy)
        _close(tcc, jcc)
    # a step after the chunk form's first 9 tokens is its 10th output
    _, tc9 = tR.rwkv_time_full(tt, tcfg, _t(x[:, :9]))
    ty, _ = tR.rwkv_time_step(tt, tcfg, _t(x[:, 9]), tc9)
    ty_all, _ = tR.rwkv_time_full(tt, tcfg, _t(x))
    _close(ty, ty_all[:, -1].detach().numpy())


def test_group_norm_uses_the_population_variance():
    y = _x(4, 2 * 8, seed=3)
    w = _x(2 * 8, seed=4)
    _close(tR._group_norm(_t(y).reshape(4, 2, 8), _t(w), 2, 8),
           jR._group_norm(jnp.asarray(y).reshape(4, 2, 8), jnp.asarray(w),
                          2, 8))


def test_cross_attention_forms_match_jax():
    """Queries [B, S, d] or [B, d], keys and values from 16 vision
    tokens; the step reaches the split-K kernel's wrapper (its plain
    version on the CPU) with lens 16."""
    jcfg, _, tcfg, _ = _model("llama-3.2-vision-11b")
    jp, tp = _layer("llama-3.2-vision-11b", "p3", "cross")
    x, src = _x(2, 5, jcfg.d_model, seed=1), _x(2, 16, jcfg.d_model, seed=2)
    jy, jkv = jL.cross_attn_full(jp, jcfg, jnp.asarray(x), jnp.asarray(src))
    ty, tkv = tL.cross_attn_full(tp, tcfg, _t(x), _t(src))
    _close(ty, jy)
    _close(tkv, jkv)
    jy, _ = jL.cross_attn_extend(jp, jcfg, jnp.asarray(x[:, 2:]), jkv)
    ty, tc = tL.cross_attn_extend(tp, tcfg, _t(x[:, 2:]), tkv)
    _close(ty, jy)
    assert tc is tkv
    jy, _ = jL.cross_attn_step(jp, jcfg, jnp.asarray(x[:, 0]), jkv)
    ty, _ = tL.cross_attn_step(tp, tcfg, _t(x[:, 0]), tkv)
    _close(ty, jy)


# ---------------------------------------------------------------------------
# (b) the zoo entry points
# ---------------------------------------------------------------------------

def _inputs(arch, S):
    """Seeded tokens [2, S] and, for the VLM, vision tokens, as both
    packages take them."""
    jcfg = _model(arch)[0]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jx, tx = {}, {}
    if jcfg.cross_attn_period:
        vis = (0.02 * rng.standard_normal(
            (2, jcfg.n_vision_tokens, jcfg.d_model))).astype(np.float32)
        jx["vision"], tx["vision"] = jnp.asarray(vis), _t(vis)
    return toks, jx, tx


def _zeros(api, B, S):
    return {pj: {n: torch.zeros(s.shape, dtype=s.dtype)
                 for n, s in c.items()}
            for pj, c in api.cache_specs(B, S).items()}


def _grow(cache, S, extra, pad):
    return {g: {n: (pad(a, S, extra) if n in ("k", "v") else a)
                for n, a in c.items()} for g, c in cache.items()}


def _jpad(a, S, extra):
    return jnp.pad(a, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0)))


def _tpad(a, S, extra):
    return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, extra))


def _ints(t):
    return np.asarray(t).tolist() if not isinstance(t, torch.Tensor) \
        else t.tolist()


@pytest.mark.parametrize("arch", STACKS)
def test_incremental_equals_full(arch):
    """tests/test_consistency.py::test_incremental_equals_full on both
    packages: prefill 24 tokens, decode 4; every step's tokens
    identical, and the last equals a full prefill's."""
    S, extra = 24, 4
    jcfg, jparams, tcfg, tparams = _model(arch)
    japi, tapi = jzoo.build(jcfg), tzoo.build(tcfg)
    toks, jx, tx = _inputs(arch, S + extra)
    jn, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S]), **jx})
    tn, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]),
                                    **tx})
    assert _ints(tn) == _ints(jn)
    jc, tc = _grow(jc, S, extra, _jpad), _grow(tc, S, extra, _tpad)
    for t in range(S, S + extra):
        jn, jc = japi.decode(jparams, jc, {"tokens": jnp.asarray(toks[:, t]),
                                           "pos": jnp.int32(t)})
        tn, tc = tapi.decode(tparams, tc,
                             {"tokens": torch.from_numpy(toks[:, t]),
                              "pos": t})
        assert _ints(tn) == _ints(jn), f"{arch}: decode at {t}"
    tfull, _ = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                      **tx})
    assert _ints(tn) == _ints(tfull)


@pytest.mark.parametrize("arch", STACKS)
def test_extend_equals_full(arch):
    """tests/test_consistency.py::test_extend_equals_full: 28 tokens in
    two chunks (split 12, 14 and 21; the VLM's first chunk seeds the
    cross KV from its vision tokens) equal a one-shot prefill of both
    packages; the JAX package's chunks run the first split (its jit
    compiles dominate the file's time)."""
    S = 28
    jcfg, jparams, tcfg, tparams = _model(arch)
    japi, tapi = jzoo.build(jcfg), tzoo.build(tcfg)
    toks, jx, tx = _inputs(arch, S)
    tfull, _ = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                      **tx})
    jfull, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks), **jx})
    assert _ints(tfull) == _ints(jfull)
    jext = jax.jit(japi.extend)
    split = 12
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      japi.cache_specs(2, S))
    _, jc = jext(jparams, jc, {"tokens": jnp.asarray(toks[:, :split]),
                               "start": jnp.int32(0), **jx})
    jn, _ = jext(jparams, jc, {"tokens": jnp.asarray(toks[:, split:]),
                               "start": jnp.int32(split)})
    assert _ints(jn) == _ints(jfull)
    for split in (12, 14, 21):
        _, tc = tapi.extend(tparams, _zeros(tapi, 2, S),
                            {"tokens": torch.from_numpy(toks[:, :split]),
                             "start": 0, **tx})
        tn, _ = tapi.extend(tparams, tc,
                            {"tokens": torch.from_numpy(toks[:, split:]),
                             "start": split})
        assert _ints(tn) == _ints(tfull), f"{arch}: extend(split={split})"


def test_forward_full_resumes_from_in_cache():
    """rwkv6's stack over 11 tokens, then 9 more from the first part's
    cache (``in_cache``, every position recurrent): hidden states and
    caches within TOL of the JAX package's, and of one pass over all
    20."""
    from repro.models import transformer as jT
    from repro_torch.models import transformer as tT
    jcfg, jparams, tcfg, tparams = _model("rwkv6-7b")
    x = _x(2, 20, jcfg.d_model, seed=9)
    jh0, jc0 = jT.forward_full(jparams["stack"], jcfg, jnp.asarray(x[:, :11]),
                               want_cache=True)
    jh, jc = jT.forward_full(jparams["stack"], jcfg, jnp.asarray(x[:, 11:]),
                             want_cache=True, in_cache=jc0)
    th0, tc0 = tT.forward_full(tparams["stack"], tcfg, _t(x[:, :11]),
                               want_cache=True)
    th, tc = tT.forward_full(tparams["stack"], tcfg, _t(x[:, 11:]),
                             want_cache=True, in_cache=tc0)
    _close(th0, jh0)
    _close(th, jh)
    _close(tc, jc)
    th_all, tc_all = tT.forward_full(tparams["stack"], tcfg, _t(x),
                                     want_cache=True)
    _close(th, th_all[:, 11:].detach().numpy())
    _close(tc, {pj: {n: a.detach().numpy() for n, a in c.items()}
                for pj, c in tc_all.items()})


def test_whisper_incremental():
    """tests/test_consistency.py::test_whisper_incremental on both
    packages: encode 20 frames, prefill 8 decoder tokens, decode 4; every
    step identical, the last equal to a full prefill's."""
    jcfg = dataclasses.replace(reduced(ARCHS["whisper-tiny"]),
                               dtype="float32")
    tcfg = dataclasses.replace(treduced(TARCHS["whisper-tiny"]),
                               dtype="float32")
    japi, tapi = jzoo.build(jcfg), tzoo.build(tcfg)
    params = _np_params(tcfg, 3)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = bridge.tree_from_numpy(params, "cpu")
    rng = np.random.default_rng(3)
    frames = (0.02 * rng.standard_normal((2, 20, jcfg.d_model))).astype(
        np.float32)
    dec = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jn, jc = japi.prefill(jparams, {"tokens": jnp.asarray(dec[:, :8]),
                                    "frames": jnp.asarray(frames)})
    tn, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(dec[:, :8]),
                                    "frames": _t(frames)})
    assert _ints(tn) == _ints(jn)
    assert {pj: {n: tuple(a.shape) for n, a in c.items()}
            for pj, c in tc.items()} == \
        {pj: {n: a.shape for n, a in c.items()} for pj, c in jc.items()}
    for t in range(8, 12):
        jn, jc = japi.decode(jparams, jc, {"tokens": jnp.asarray(dec[:, t]),
                                           "pos": jnp.int32(t)})
        tn, tc = tapi.decode(tparams, tc,
                             {"tokens": torch.from_numpy(dec[:, t]),
                              "pos": t})
        assert _ints(tn) == _ints(jn)
    tfull, _ = tapi.prefill(tparams, {"tokens": torch.from_numpy(dec),
                                      "frames": _t(frames)})
    assert _ints(tn) == _ints(tfull)
    spec = tapi.cache_specs(2, 20)["p0"]
    assert spec["k"].shape[2] == jcfg.max_target_len
    assert spec["ck"].shape[2] == 20


# ---------------------------------------------------------------------------
# (c)-(e) engines, cluster, serve CLI
# ---------------------------------------------------------------------------

# The reference's dense plane runs its prefill chunks through the eager
# ``api.extend``, whose group scan recompiles at every call; every JAX
# engine of this module gets one jitted extend and decode per model,
# keyed by the parameters they close over (tests/test_torch_dense.py does
# the same).
_JITS = {}


def _share_jits(jeng):
    key = ("_decode_fn", id(jeng.params))
    jeng._decode_fn = _JITS.setdefault(key, (jeng.params,
                                             jeng._decode_fn))[1]
    key = ("extend", id(jeng.params))
    jeng.api = dataclasses.replace(jeng.api, extend=_JITS.setdefault(
        key, (jeng.params, jax.jit(jeng.api.extend)))[1])
    return jeng


ECONF = dict(max_context=64, chunk_size=16, max_batch_tokens=64,
             capacity_tokens=4096, page_size=16)


def _snapshot_scenario(eng, Request, vocab):
    """One request alone, then its repeat and an extension of it."""
    rng = np.random.default_rng(0)
    shared = tuple(rng.integers(1, vocab, 24).tolist())
    reqs = [Request(tokens=shared, max_new_tokens=3),
            Request(tokens=shared, max_new_tokens=3),
            Request(tokens=shared + tuple(rng.integers(1, vocab, 8).tolist()),
                    max_new_tokens=3)]
    now, done = 0.0, []
    eng.scheduler.enqueue(reqs[0], now)
    while len(done) < 1:
        done += eng.step(now)
        now += 0.01
    snaps = {k: {pj: {n: a.clone() for n, a in c.items()}
                 for pj, c in v.items()}
             for k, v in getattr(eng, "state_store", {}).items()
             if isinstance(eng, TEngine)}
    for r in reqs[1:]:
        eng.scheduler.enqueue(r, now)
    while len(done) < 3:
        done += eng.step(now)
        now += 0.01
    return shared, reqs, snaps


@pytest.mark.parametrize("arch", STACKS)
def test_snapshot_reuse_matches_jax_engine(arch):
    """The JAX package's recurrent snapshot scenario on both dense
    engines (the VLM reuses KV slabs instead): outputs, every stat and
    the stores' keys identical; the repeat equals the first request; the
    extension equals the port's own oracle (the whole prompt extended
    from a zero cache, as the engine's VLM cross KV is zero, then
    decoded); and the snapshot taken by the first request is unchanged
    after the two that reused it (it is copied in, never aliased)."""
    jcfg, jparams, tcfg, tparams = _model(arch)
    jeng = _share_jits(JEngine(jcfg, jparams, JEngineConfig(**ECONF)))
    teng = TEngine(tcfg, tparams, TEngineConfig(**ECONF), device="cpu")
    assert not teng.paged and not jeng.paged
    assert teng.has_recurrent == jeng.has_recurrent == (arch in RECURRENT)
    shared, jreqs, _ = _snapshot_scenario(jeng, JRequest, jcfg.vocab_size)
    _, treqs, snaps = _snapshot_scenario(teng, TRequest, tcfg.vocab_size)
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
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
    assert set(teng.state_store) == set(jeng.state_store)
    assert set(teng.kv_store) == set(jeng.kv_store)
    assert treqs[0].output_tokens == treqs[1].output_tokens
    if arch in RECURRENT:
        assert teng.stats["reused_tokens"] >= 2 * (len(shared) - 1)
        assert len(teng.state_store) == 2 and not teng.kv_store
        key = tuple(shared[:-1])
        for pj, c in snaps[key].items():
            for n, a in c.items():
                assert torch.equal(teng.state_store[key][pj][n], a), (pj, n)
    else:
        assert teng.stats["reused_tokens"] > 0 and not teng.state_store
    # the extension against the port's own oracle
    api = tzoo.build(tcfg)
    r3 = treqs[2]
    nxt, cache = api.extend(tparams, _zeros(api, 1, 64),
                            {"tokens": torch.tensor([r3.tokens]),
                             "start": 0})
    outs = [int(nxt[0])]
    for t in range(2):
        nxt, cache = api.decode(tparams, cache,
                                {"tokens": nxt, "pos": len(r3.tokens) + t})
        outs.append(int(nxt[0]))
    assert r3.output_tokens == outs


def test_whisper_engine_refuses_at_construction():
    tcfg = dataclasses.replace(treduced(TARCHS["whisper-tiny"]),
                               dtype="float32")
    params = tzoo.build(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        TEngine(tcfg, params, TEngineConfig(**ECONF), device="cpu")


def _run_cluster(cl, Request, prompts):
    """Submit all, a few steps, fail instance 0 mid-flight, run to the
    end (tests/test_torch_dense.py's scenario)."""
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


def test_rwkv_cluster_matches_jax_cluster():
    from repro.core.cost_model import HardwareSpec as JHardwareSpec
    from repro_torch.core.cost_model import CostModel, HardwareSpec, \
        cost_model_for
    jcfg, jparams, tcfg, tparams = _model("rwkv6-7b")
    econf = dict(ECONF, capacity_tokens=512)
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
               for _ in range(6)]
    got = _run_cluster(tcl, TRequest, prompts)
    assert got == _run_cluster(jcl, JRequest, prompts)
    assert all(not e.paged and e.has_recurrent
               for e in tcl.engines.values())


def _lines(text):
    """The CLI's lines without its wall clock and the port's device."""
    out = []
    for line in text.strip().splitlines():
        if line.startswith("policy="):
            line = line.split(" wall=")[0]
        out.append(line)
    return out


def test_serve_cli_rwkv_matches_the_jax_cli(monkeypatch, capsys):
    import sys
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    args = ["--arch", "rwkv6-7b", "--instances", "2", "--requests", "4",
            "--max-context", "48"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    want = _lines(capsys.readouterr().out)
    res = serve.main(args + ["--reduced", "--device", "cpu"])
    assert _lines(capsys.readouterr().out) == want
    assert "finished=4/4" in want[0]
    assert all(not e.paged for e in res["cluster"].engines.values())


# ---------------------------------------------------------------------------
# (f) sizes from specs, and what build gives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_width_sizes_match_jax(arch):
    japi, tapi = jzoo.build(ARCHS[arch]), tzoo.build(TARCHS[arch])
    assert tapi.n_bytes == japi.n_bytes
    assert tapi.n_params == japi.n_params
    assert tapi.n_active_params == japi.n_active_params


def test_build_gives_the_dense_entries_of_every_stack():
    for arch in STACKS + ["whisper-tiny"]:
        api = tzoo.build(TARCHS[arch])
        assert api.prefill and api.decode and api.cache_specs, arch
        assert (api.extend is None) == (arch == "whisper-tiny"), arch
        for name in ("decode_paged", "extend_paged", "paged_cache_specs",
                     "mixed_paged", "mixed_paged_spec"):
            assert getattr(api, name) is None, (arch, name)
    A_log = bridge.param_specs(TARCHS["jamba-v0.1-52b"])["stack"]["p0"][
        "mamba"]["A_log"]
    assert A_log.dtype == "float32" and A_log.axes[0] == "layers"
