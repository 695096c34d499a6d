"""The port's model math against the JAX package: the parameter/pool
bridge, the shared building blocks, and the paged entry points
(decode_paged, extend_paged, mixed_paged and its verification variant
mixed_paged_spec) on the same bridged float32 parameters, pools and
batches.

Tolerances: greedy tokens must be identical. Pool leaves agree to an
absolute 1e-5, or 4e-6 of the leaf's largest entry where that is larger
(32 float32 ulps of it): the JAX package's fan_in init gives K/V entries
up to |x| ~ 20, the two frameworks sum in different orders, and an
entry that is a small difference of large terms carries the rounding of
those terms. Page 0 is excluded: padding tokens all write scratch slot 0
and the winner among duplicate scatters is unspecified in both
frameworks.
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
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models import common as tcommon
from repro_torch.models import zoo as tzoo

torch.set_num_threads(1)

N_PAGES, PS = 12, 16


def _cfgs(arch):
    kw = dict(n_layers=2, dtype="float32")
    return (dataclasses.replace(reduced(ARCHS[arch]), **kw),
            dataclasses.replace(reduced(TARCHS[arch]), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["smollm-360m", "command-r-35b",
                                        "internlm2-1.8b"])
def models(request):
    jcfg, tcfg = _cfgs(request.param)
    japi = jzoo.build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = bridge.tree_from_numpy(_np_tree(jparams), "cpu")
    return jcfg, tcfg, japi, jparams, tzoo.build(tcfg), tparams


def _pools(cfg, seed):
    """Random pools as numpy (reads see nontrivial KV everywhere)."""
    rng = np.random.default_rng(seed)
    shape = (N_PAGES, PS, cfg.n_kv_heads, cfg.head_dim)
    return {"p0": {f"g{g}": {n: rng.standard_normal(shape)
                              .astype(np.float32) for n in ("k", "v")}
                    for g in range(cfg.n_groups)}}


def _run_both(models, entry, batch, seed=0):
    jcfg, _, japi, jparams, tapi, tparams = models
    pools = _pools(jcfg, seed)
    jnxt, *jpreds, jpages = getattr(japi, entry)(
        jparams, jax.tree.map(jnp.asarray, pools),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tpages = bridge.tree_from_numpy(pools, "cpu")
    tnxt, *tpreds, tpages = getattr(tapi, entry)(
        tparams, tpages, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
    for t, j in zip(tpreds, jpreds):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    got, exp = bridge.tree_to_numpy(tpages), _np_tree(jpages)
    for g, kv in exp["p0"].items():
        for n, a in kv.items():
            atol = max(1e-5, 4e-6 * float(np.abs(a[1:]).max()))
            np.testing.assert_allclose(got["p0"][g][n][1:], a[1:],
                                       atol=atol, rtol=0)
    return tnxt


def test_decode_paged_matches_jax(models):
    # lanes 0-1 real (private tail pages), lane 2 padding (scratch row)
    pt = np.array([[3, 4, 0, 0], [5, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    batch = {"tokens": np.array([7, 11, 0], np.int32),
             "pos": np.array([20, 40, 0], np.int32), "page_table": pt}
    _run_both(models, "decode_paged", batch)


def test_extend_paged_matches_jax(models):
    pt = np.array([[2, 8, 9, 0]], np.int32)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(1, 100, (1, 8)).astype(np.int32),
             "start": np.array([13], np.int32), "page_table": pt}
    _run_both(models, "extend_paged", batch)


def test_mixed_paged_matches_jax(models):
    """Two chunk lanes (one full, one ragged with pad tokens), one real
    decode lane and one padding decode lane."""
    rng = np.random.default_rng(2)
    batch = {"chunk_tokens": rng.integers(1, 100, (2, 8)).astype(np.int32),
             "chunk_start": np.array([5, 20], np.int32),
             "chunk_len": np.array([8, 3], np.int32),
             "chunk_page_table": np.array([[1, 2, 0, 0], [3, 4, 0, 0]],
                                          np.int32),
             "dec_tokens": np.array([9, 0], np.int32),
             "dec_pos": np.array([33, 0], np.int32),
             "dec_page_table": np.array([[5, 6, 7, 0], [0, 0, 0, 0]],
                                        np.int32)}
    nxt = _run_both(models, "mixed_paged", batch)
    assert nxt.shape == (4,)


def test_mixed_paged_spec_matches_jax(models):
    """The verification head: the same batch as mixed_paged (a ragged
    chunk lane stands in for a K+1-token verify lane); chunk_pred must be
    identical at every position, pad positions included."""
    rng = np.random.default_rng(2)
    batch = {"chunk_tokens": rng.integers(1, 100, (2, 8)).astype(np.int32),
             "chunk_start": np.array([5, 20], np.int32),
             "chunk_len": np.array([8, 3], np.int32),
             "chunk_page_table": np.array([[1, 2, 0, 0], [3, 4, 0, 0]],
                                          np.int32),
             "dec_tokens": np.array([9, 0], np.int32),
             "dec_pos": np.array([33, 0], np.int32),
             "dec_page_table": np.array([[5, 6, 7, 0], [0, 0, 0, 0]],
                                        np.int32)}
    nxt = _run_both(models, "mixed_paged_spec", batch)
    assert nxt.shape == (4,)


def test_build_raises_for_unported_configs():
    """Every config builds now: the recurrent and encoder-decoder stacks
    get the dense entries and no paged ones (None, as the reference's
    build gives them), and whisper no chunk extension."""
    for arch in ("rwkv6-7b", "whisper-tiny"):
        api, japi = tzoo.build(TARCHS[arch]), jzoo.build(ARCHS[arch])
        assert api.prefill and api.decode
        for name in ("extend", "decode_paged", "extend_paged",
                     "paged_cache_specs", "mixed_paged", "mixed_paged_spec"):
            assert (getattr(api, name) is None) \
                == (getattr(japi, name) is None), (arch, name)
        assert (api.extend is None) == (arch == "whisper-tiny")
        assert api.decode_paged is None


def test_bridge_round_trip_keeps_the_moe_router_float32():
    """A bf16 MoE model: its router leaves are float32 (the JAX package's
    pinned dtype) and cross as float32, the experts as uint16 bit views;
    param_bytes counts each leaf in its own dtype, as the JAX package's
    n_bytes (at full width too), and init_params draws the router in
    float32."""
    jcfg, tcfg = _cfgs("grok-1-314b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    jparams = _np_tree(jzoo.build(jcfg).init(jax.random.PRNGKey(1)))
    assert jparams["stack"]["p0"]["ffn"]["router"].dtype == np.float32
    bits = jax.tree.map(lambda a: a.view(np.uint16)
                        if a.dtype != np.float32 else a, jparams)
    t = bridge.tree_from_numpy(bits, "cpu")
    ffn = t["stack"]["p0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["wg"].dtype == torch.bfloat16
    jax.tree.map(np.testing.assert_array_equal, bridge.tree_to_numpy(t),
                 bits)
    assert bridge.param_bytes(tcfg) == jzoo.build(jcfg).n_bytes
    for arch in ("grok-1-314b", "mixtral-8x22b"):
        assert bridge.param_bytes(TARCHS[arch]) \
            == jzoo.build(ARCHS[arch]).n_bytes
        assert tzoo.build(TARCHS[arch]).n_active_params \
            == jzoo.build(ARCHS[arch]).n_active_params
    own = bridge.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert own["stack"]["p0"]["ffn"]["router"].dtype == torch.float32
    assert own["stack"]["p0"]["ffn"]["wd"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    """JAX params -> numpy (bf16 as uint16 bit views, as the JAX
    checkpoints store them) -> port tensors -> numpy, bit-exact."""
    jcfg, tcfg = _cfgs("smollm-360m")
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jparams = _np_tree(jzoo.build(jcfg).init(jax.random.PRNGKey(1)))
    if dtype == "bfloat16":
        jparams = jax.tree.map(lambda a: a.view(np.uint16), jparams)
    t = bridge.tree_from_numpy(jparams, "cpu")
    assert t["stack"]["p0"]["attn"]["wq"].dtype == getattr(torch, dtype)
    back = bridge.tree_to_numpy(t)
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    pools = jax.tree.map(np.asarray, _pools(jcfg, 3))
    jax.tree.map(np.testing.assert_array_equal,
                 bridge.tree_to_numpy(bridge.tree_from_numpy(pools, "cpu")),
                 pools)


def test_init_params_shapes_and_kinds_match_jax_specs():
    jcfg, tcfg = _cfgs("internlm2-1.8b")               # untied head too
    abstract = jzoo.build(jcfg).abstract()
    gen = torch.Generator().manual_seed(0)
    mine = tzoo.build(tcfg).init(gen, "cpu")
    shapes = jax.tree.map(lambda s: tuple(s.shape), abstract)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    assert torch.equal(mine["stack"]["p0"]["norm1"],
                       torch.ones_like(mine["stack"]["p0"]["norm1"]))
    wq = mine["stack"]["p0"]["attn"]["wq"]           # fan_in: 1/sqrt(H)
    assert abs(wq.std().item() * np.sqrt(wq.shape[-2]) - 1.0) < 0.1
    assert abs(mine["embed"]["tok"].std().item() - 0.02) < 0.002


def test_decode_and_extend_attention_match_jax():
    from repro.models import attention as jatt
    from repro_torch.models import attention as tatt
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 6, 16)).astype(np.float32)
    k = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    clen = np.array([1, 9, 20], np.int32)
    for cl in (clen, 12):
        np.testing.assert_allclose(
            tatt.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  torch.as_tensor(cl)).numpy(),
            np.asarray(jatt.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v),
                                             jnp.asarray(cl))),
            atol=3e-5, rtol=1e-4)
    qc = rng.standard_normal((3, 4, 6, 16)).astype(np.float32)
    start = np.array([0, 5, 16], np.int32)
    np.testing.assert_allclose(
        tatt.extend_attention(torch.from_numpy(qc), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(start),
                              torch.from_numpy(start + 4)).numpy(),
        np.asarray(jatt.extend_attention(jnp.asarray(qc), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(start),
                                         jnp.asarray(start + 4))),
        atol=3e-5, rtol=1e-4)


def test_rms_norm_rope_top1_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 500, (3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos),
                     1e4).numpy(),
        np.asarray(jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        atol=1e-5, rtol=1e-5)
    h = rng.standard_normal((6, 32)).astype(np.float32)
    wo = rng.standard_normal((32, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        tcommon.top1_logits(torch.from_numpy(h), torch.from_numpy(wo)).numpy(),
        np.asarray(jcommon.top1_logits(jnp.asarray(h), jnp.asarray(wo))))
