"""The port's training loss (``ModelAPI.loss``) and its gradients against
the JAX package's ``jax.value_and_grad(api.loss)``, on the same seeded
float32 parameters and batches (drawn with numpy):

(a) every family: reduced smollm-360m, mixtral-8x22b (capacity factor
    1.0, so the capacity dispatch drops pairs), grok-1-314b, rwkv6-7b,
    jamba-v0.1-52b, llama-3.2-vision-11b (with "vision") and whisper-tiny
    (with "frames"); smollm also with a "loss_mask";
(b) ``remat`` on and off give the same loss and grads, bit for bit, and
    remat refuses a cache;
(c) ``chunked_ce_loss`` over one, two and three chunks, masked;
(d) the half-expert MoE stack on conftest's emulated ("data", "model")
    meshes (JAX) against the port's emulated mesh of CPU shards;
(e) the loss path makes no host read (no ``.item()`` / ``.tolist()``,
    so no routed-MoE sync).

Tolerances: the loss to 1e-5 relative, every grad leaf to 1e-4 of its
largest |value|.

Parameters: the specs' shapes and init kinds, with the "fan_in" draws at
0.3 of the reference's 1 / sqrt(shape[-2]). At the full scale the reduced
stacks' attention scores reach ~200 (``wq`` is drawn with 1 / sqrt(H) for
H = 2 heads), where the float32 rounding of the projections (~1e-7)
moves the softmax by ~1e-5: the two packages' losses then differ by up
to 1e-5 relative and their grads by up to 3e-2 of a leaf's max (the VLM;
4e-4 for smollm), falling to 2.4e-5 at 0.3 and 1.5e-6 at 0.1 of the
scale. That is the conditioning of the function, not a difference of
the code, which is what this file checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import common as jcommon
from repro.models import zoo as jzoo
from repro.models.common import chunked_ce_loss as jce
from repro.models.moe_a2a import \
    reshape_standard_to_halfexpert as j_to_half
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import zoo as tzoo
from repro_torch.models.common import chunked_ce_loss as tce
from repro_torch.models.moe_a2a import \
    reshape_standard_to_halfexpert as t_to_half
from repro_torch.train.train_loop import value_and_grad

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # of each leaf's largest |value|
FAN_IN_GAIN = 0.3
FAMILIES = {"smollm-360m": {}, "mixtral-8x22b": {"capacity_factor": 1.0},
            "grok-1-314b": {}, "rwkv6-7b": {}, "jamba-v0.1-52b": {},
            "llama-3.2-vision-11b": {}, "whisper-tiny": {}}
_JAX_GRAD = {}


def _np_params(cfg, seed):
    """float32 parameters with the shapes and init kinds of the specs;
    "fan_in" leaves at FAN_IN_GAIN of the reference's scale (module
    doc)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if tree.init in ("zeros", "ones"):
            return np.full(tree.shape, tree.init == "ones", np.float32)
        scale = (FAN_IN_GAIN / np.sqrt(tree.shape[-2])
                 if tree.init == "fan_in" else tree.scale)
        return (scale * rng.standard_normal(tree.shape)).astype(np.float32)

    return walk(bridge.param_specs(cfg))


def _cfgs(arch, **kw):
    kw = {"dtype": "float32", **FAMILIES.get(arch, {}), **kw}
    return (dataclasses.replace(reduced(ARCHS[arch]), **kw),
            dataclasses.replace(treduced(TARCHS[arch]), **kw))


def _batch(cfg, seed, B=2, S=32, mask=False):
    """Next-token batch (numpy): tokens / labels [B, S], "vision" for a
    VLM, "frames" [B, 20, d] (and S capped at max_target_len) for the
    encoder-decoder, a random 0/1 "loss_mask" when asked."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_decoder:
        S = min(S, cfg.max_target_len)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.cross_attn_period and not cfg.encoder_decoder:
        out["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal(
            (B, 20, cfg.d_model)).astype(np.float32)
    if mask:
        out["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _jax_value_and_grad(jcfg):
    """jit(value_and_grad(api.loss)) of a config, shared across cases."""
    if jcfg not in _JAX_GRAD:
        api = jzoo.build(jcfg)
        _JAX_GRAD[jcfg] = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss(p, b, remat=True)))
    return _JAX_GRAD[jcfg]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_match(tl, tg, jl, jg):
    jl = float(jl)
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl), (float(tl), jl)
    ft, fj = _flat(tg), _flat(jg)
    assert set(ft) == set(fj)
    for k, want in fj.items():
        want = np.asarray(want)
        got = ft[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= GRAD_TOL, (k, err)


def _torch_loss(tcfg, params, batch, remat=True):
    api = tzoo.build(tcfg)
    return value_and_grad(lambda p, b: api.loss(p, b, remat=remat),
                          params, batch)


# ---------------------------------------------------------------------------
# (a) every family, (b) remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(FAMILIES))
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    p = _np_params(tcfg, 0)
    batch = _batch(tcfg, 1)
    jl, jg = _jax_value_and_grad(jcfg)(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch))
    tl, tg = _torch_loss(tcfg, bridge.tree_from_numpy(p, "cpu"),
                         _torch_batch(batch))
    assert tl.dtype == torch.float32 and tl.shape == ()
    _assert_match(tl, tg, jl, jg)


def test_mixtral_loss_case_drops_pairs(monkeypatch):
    """The mixtral case overflows its capacity: in some MoE call a
    (sequence, expert) receives more than cap pairs, so the loss runs
    through the drop path."""
    _, tcfg = _cfgs("mixtral-8x22b")
    over = []
    orig = tlayers.moe_full

    def spy(p, cfg, x):
        _, tope = tlayers._route(p, cfg, x)
        S, K, E = x.shape[1], cfg.experts_per_token, cfg.n_experts
        cap = max(int(cfg.capacity_factor * S * K / E), K)
        per = torch.nn.functional.one_hot(tope.reshape(x.shape[0], -1),
                                          E).sum(1)
        over.append(int((per - cap).clamp(min=0).sum()))
        return orig(p, cfg, x)

    monkeypatch.setattr(tlayers, "moe_full", spy)
    _torch_loss(tcfg, bridge.tree_from_numpy(_np_params(tcfg, 0), "cpu"),
                _torch_batch(_batch(tcfg, 1)))
    # each layer in the forward and again in remat's recomputation
    assert len(over) == 2 * tcfg.n_layers and min(over) > 0, over


def test_masked_loss_matches_jax():
    jcfg, tcfg = _cfgs("smollm-360m")
    p = _np_params(tcfg, 2)
    batch = _batch(tcfg, 3, mask=True)
    jl, jg = _jax_value_and_grad(jcfg)(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch))
    tl, tg = _torch_loss(tcfg, bridge.tree_from_numpy(p, "cpu"),
                         _torch_batch(batch))
    _assert_match(tl, tg, jl, jg)
    unmasked, _ = _torch_loss(tcfg, bridge.tree_from_numpy(p, "cpu"),
                              {k: v for k, v in _torch_batch(batch).items()
                               if k != "loss_mask"})
    assert float(unmasked) != float(tl)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_remat_changes_no_value(arch):
    """torch.utils.checkpoint around each group: the loss and every grad
    equal the un-remat'd ones bit for bit."""
    _, tcfg = _cfgs(arch)
    p = bridge.tree_from_numpy(_np_params(tcfg, 4), "cpu")
    batch = _torch_batch(_batch(tcfg, 5))
    l1, g1 = _torch_loss(tcfg, p, batch, remat=True)
    l0, g0 = _torch_loss(tcfg, p, batch, remat=False)
    assert torch.equal(l1, l0)
    f1, f0 = _flat(g1), _flat(g0)
    for k in f0:
        assert torch.equal(f1[k], f0[k]), k


def test_remat_refuses_a_cache():
    """A recomputed group would read the recurrent state its first run
    wrote into the cache: remat takes neither in_cache nor want_cache."""
    from repro_torch.models import transformer as T
    _, tcfg = _cfgs("rwkv6-7b")
    p = bridge.tree_from_numpy(_np_params(tcfg, 6), "cpu")
    x = torch.zeros(1, 4, tcfg.d_model)
    with pytest.raises(ValueError):
        T.forward_full(p["stack"], tcfg, x, remat=True, want_cache=True)
    _, cache = T.forward_full(p["stack"], tcfg, x, want_cache=True)
    with pytest.raises(ValueError):
        T.forward_full(p["stack"], tcfg, x, remat=True, in_cache=cache)


# ---------------------------------------------------------------------------
# (c) the chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,masked", [(40, False), (1100, True),
                                      (1536, False)])
def test_chunked_ce_loss_matches_jax(S, masked):
    """One chunk (S < 512), two of 550 and three of 512: the loss and its
    grads in hidden and w_out."""
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, 32)).astype(np.float32)
    w = (0.2 * rng.standard_normal((32, 96))).astype(np.float32)
    y = rng.integers(0, 96, (2, S)).astype(np.int32)
    m = ((rng.random((2, S)) < 0.7).astype(np.float32) if masked else None)
    jl, jg = jax.value_and_grad(
        lambda a, b: jce(a, b, jnp.asarray(y),
                         None if m is None else jnp.asarray(m)),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    tl = tce(th, tw, torch.from_numpy(y),
             None if m is None else torch.from_numpy(m))
    tl.backward()
    _assert_match(tl.detach(), {"h": th.grad, "w": tw.grad}, jl,
                  {"h": jg[0], "w": jg[1]})


# ---------------------------------------------------------------------------
# (d) the half-expert stack, (e) no host reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_halfexpert_stack_grads_match_jax(shape):
    """A 1-layer reduced mixtral (2 experts, top 2, capacity 16, as
    tests/test_moe_a2a.py) in the half-expert layout at tp = the mesh's
    "model" size: loss and grads on the ambient mesh, JAX on conftest's
    emulated devices, the port on CPU shards."""
    dp, tp = shape
    kw = dict(n_layers=1, n_experts=2, experts_per_token=2,
              capacity_factor=16.0)
    jstd, tstd = _cfgs("mixtral-8x22b", **kw)
    jcfg = dataclasses.replace(jstd, moe_impl="halfexpert", moe_tp=tp)
    tcfg = dataclasses.replace(tstd, moe_impl="halfexpert", moe_tp=tp)
    p = _np_params(tstd, 7)
    f = p["stack"]["p0"]["ffn"]
    std = [f[n][0] for n in ("wg", "wu", "wd")]
    split = t_to_half(*map(torch.from_numpy, std), tp)
    for a, b in zip(split, j_to_half(*map(jnp.asarray, std), tp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    f.update({n: w[None].numpy() for n, w in zip(("wg", "wu", "wd"), split)})
    batch = _batch(tcfg, 8, B=4, S=16)
    mesh_kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
               if hasattr(jax.sharding, "AxisType") else {})
    try:
        jcommon.set_mesh(jax.make_mesh(shape, ("data", "model"), **mesh_kw))
        tcommon.set_mesh(tmesh.make_mesh(dp, tp, platform="cpu"))
        api = jzoo.build(jcfg)
        jl, jg = jax.value_and_grad(lambda q, b: api.loss(q, b))(
            jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch))
        tl, tg = _torch_loss(tcfg, bridge.tree_from_numpy(p, "cpu"),
                             _torch_batch(batch))
    finally:
        jcommon.set_mesh(None)
        tcommon.set_mesh(None)
    _assert_match(tl, tg, jl, jg)


def test_loss_path_reads_nothing_on_the_host(monkeypatch):
    """The loss and its backward read no tensor on the host: the routed
    MoE (``layers._routed``, one host sync a call) is the serving form,
    and the loss never reaches it."""
    _, tcfg = _cfgs("mixtral-8x22b")
    p = bridge.tree_from_numpy(_np_params(tcfg, 9), "cpu")
    batch = _torch_batch(_batch(tcfg, 10))

    def no_host_read(*a, **k):
        raise AssertionError("host read on the loss path")

    before = dict(tlayers.MOE_STATS)
    monkeypatch.setattr(torch.Tensor, "item", no_host_read)
    monkeypatch.setattr(torch.Tensor, "tolist", no_host_read)
    _torch_loss(tcfg, p, batch)
    monkeypatch.undo()
    assert tlayers.MOE_STATS == before
