"""The port's attention-kernel library against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, which must match
the Pallas kernel (interpret mode, as tests/test_kernels.py runs it) on
the same inputs, made from a seed with numpy. The CUDA kernels themselves
run only on a card: their tests are in tests/test_torch_cuda.py.

Tolerances: float32 atol 3e-5 / rtol 1e-4 (the JAX package's own kernel
tolerance; the two sides sum in different orders); bfloat16 atol 3e-2 /
rtol 0.05 (as test_flash_attention_dtypes).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.decode_attention import lse_merge as jlse_merge
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.prefix_attention import prefix_attention as jprefix
from repro.kernels.prefix_attention import prefix_partial as jprefix_partial
from repro_torch import kernels as K
from repro_torch.kernels import bench, checks, ops, ref
from repro_torch.kernels.decode_attention import _check_cuda as dec_check
from repro_torch.kernels.flash_attention import _check_cuda as flash_check
from repro_torch.kernels.prefix_attention import _check_cuda as pre_check

torch.set_num_threads(1)

F32 = dict(atol=3e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=0.05)

# full-width smollm-360m heads (G 3, D 64) at a short length
SMOLLM_DEC = (3, 15, 5, 160, 64, 4)          # B, H, KH, S, D, n_splits
SMOLLM_PRE = (4, 15, 5, 192, 24, 64)         # B, H, KH, Sp, Ss, D


def _rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _launches():
    return (K.flash_attention.launches, K.decode_attention.launches,
            K.prefix_partial.launches)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_cases_are_the_jax_packages():
    """chip_smoke.py and the card tests take the JAX package's cases from
    bench.py: they must be the ones tests/test_kernels.py runs (read from
    its source, so that test module is not imported twice)."""
    tree = ast.parse((Path(__file__).parent / "test_kernels.py").read_text())
    cases = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id.endswith("_CASES")}
    assert bench.FLASH_CASES == cases["FLASH_CASES"]
    assert bench.DEC_CASES == cases["DEC_CASES"]
    assert bench.PRE_CASES == cases["PRE_CASES"]


@pytest.mark.parametrize("case", bench.FLASH_CASES)
def test_flash_matches_pallas_kernel(case):
    B, H, KH, Sq, Skv, D, causal, win = case
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = _rnd(rng, B, H, Sq, D), _rnd(rng, B, KH, Skv, D), \
        _rnd(rng, B, KH, Skv, D)
    before = _launches()
    got = K.flash_attention(*_t(q, k, v), causal=causal, window=win,
                            block_q=64, block_k=64)
    assert _launches() == before, \
        "a CPU tensor must take the plain version, never count a launch"
    exp = jflash(*_j(q, k, v), causal=causal, window=win, block_q=64,
                 block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_dtypes_match_pallas_kernel(dt):
    rng = np.random.default_rng(0)
    q, k, v = _rnd(rng, 1, 4, 64, 64), _rnd(rng, 1, 2, 64, 64), \
        _rnd(rng, 1, 2, 64, 64)
    got = K.flash_attention(*(t.to(getattr(torch, dt)) for t in _t(q, k, v)),
                            block_q=32, block_k=32)
    assert got.dtype == getattr(torch, dt)
    exp = jflash(*(a.astype(getattr(jnp, dt)) for a in _j(q, k, v)),
                 interpret=True, block_q=32, block_k=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp.astype(jnp.float32)),
                               **(F32 if dt == "float32" else BF16))


def test_flash_kv_len_and_empty_rows_match_jax_ref():
    """kv_len masks the tail; a window smaller than the gap to kv_len
    leaves rows with no visible key, which return 0 on both sides."""
    rng = np.random.default_rng(3)
    q, k, v = _rnd(rng, 1, 4, 48, 32), _rnd(rng, 1, 2, 48, 32), \
        _rnd(rng, 1, 2, 48, 32)
    got = K.flash_attention(*_t(q, k, v), window=4, kv_len=20).numpy()
    exp = np.asarray(jref.flash_attention_ref(*_j(q, k, v), window=4,
                                              kv_len=20))
    np.testing.assert_allclose(got, exp, **F32)
    assert not got[:, :, 24:].any()                 # no key in (q-4, 20)
    with pytest.raises(ValueError):
        K.flash_attention(*_t(q, k, v), kv_len=49)


@pytest.mark.parametrize("case", bench.DEC_CASES + [SMOLLM_DEC])
def test_decode_matches_pallas_kernel(case):
    B, H, KH, S, D, ns = case
    rng = np.random.default_rng(S)
    q, k, v = _rnd(rng, B, H, D), _rnd(rng, B, KH, S, D), \
        _rnd(rng, B, KH, S, D)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    before = _launches()
    got = K.decode_attention(*_t(q, k, v, lens), n_splits=ns)
    assert _launches() == before
    exp = jdecode(*_j(q, k, v, lens), n_splits=ns, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)


@pytest.mark.parametrize("case", bench.PRE_CASES + [SMOLLM_PRE])
def test_prefix_matches_pallas_kernel(case):
    B, H, KH, Sp, Ss, D = case
    rng = np.random.default_rng(Sp + Ss)
    q = _rnd(rng, B, H, D)
    kp, vp = _rnd(rng, KH, Sp, D), _rnd(rng, KH, Sp, D)
    ks, vs = _rnd(rng, B, KH, Ss, D), _rnd(rng, B, KH, Ss, D)
    lens = rng.integers(1, Ss + 1, B).astype(np.int32)
    before = _launches()
    got = K.prefix_attention(*_t(q, kp, vp, ks, vs, lens))
    assert _launches() == before
    exp = jprefix(*_j(q, kp, vp, ks, vs, lens), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)


@pytest.mark.parametrize("case", bench.PRE_CASES)
def test_prefix_partial_matches_pallas_kernel(case):
    """The raw unnormalised (acc, m, l) of the shared prefix."""
    B, H, KH, Sp, _, D = case
    rng = np.random.default_rng(Sp)
    q = _rnd(rng, B, H, D)
    kp, vp = _rnd(rng, KH, Sp, D), _rnd(rng, KH, Sp, D)
    got = K.prefix_partial(*_t(q, kp, vp))
    exp = jprefix_partial(*_j(q, kp, vp), interpret=True)
    for g, e in zip(got, exp):
        assert g.shape == e.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **F32)


def test_lse_merge_matches_jax():
    """Random partials with empty splits (m -inf, l 0, acc 0) among them,
    and a row whose every split is empty (0 on both sides)."""
    rng = np.random.default_rng(9)
    acc = _rnd(rng, 2, 3, 4, 2, 16)
    m = _rnd(rng, 2, 3, 4, 2, 1)
    l = np.abs(_rnd(rng, 2, 3, 4, 2, 1)) + 0.5
    empty = rng.random((2, 3, 4, 2, 1)) < 0.3
    empty[0, 0, :, 0] = True
    m[empty] = -np.inf
    l[empty] = 0.0
    acc[np.broadcast_to(empty, acc.shape)] = 0.0
    got = K.lse_merge(*_t(acc, m, l)).numpy()
    exp = np.asarray(jlse_merge(*_j(acc, m, l)))
    np.testing.assert_allclose(got, exp, **F32)
    assert np.isfinite(got).all() and not got[0, 0, 0].any()


def test_lse_merge_degenerate():
    """One side fully masked (-inf m): the merge is the other side, as
    the JAX package's test_lse_merge_degenerate."""
    acc = np.stack([np.zeros((1, 1, 2, 4)), np.ones((1, 1, 2, 4))], 2)
    m = np.stack([np.full((1, 1, 2, 1), -np.inf), np.zeros((1, 1, 2, 1))], 2)
    l = np.stack([np.zeros((1, 1, 2, 1)), np.ones((1, 1, 2, 1))], 2)
    arrays = [a.astype(np.float32) for a in (acc, m, l)]
    got = K.lse_merge(*_t(*arrays)).numpy()
    exp = np.asarray(jlse_merge(*_j(*arrays)))
    np.testing.assert_allclose(got, exp, atol=1e-6)
    np.testing.assert_allclose(got, np.ones((1, 1, 2, 4)), atol=1e-6)


def test_ops_flash_matches_jax_ops():
    rng = np.random.default_rng(4)
    q, k, v = _rnd(rng, 2, 32, 4, 16), _rnd(rng, 2, 32, 2, 16), \
        _rnd(rng, 2, 32, 2, 16)
    got = ops.flash_attention(*_t(q, k, v), block_q=16, block_k=16)
    assert got.shape == (2, 32, 4, 16) and got.is_contiguous()
    exp = jops.flash_attention(*_j(q, k, v), block_q=16, block_k=16,
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)


def test_ops_decode_matches_jax_ops():
    rng = np.random.default_rng(5)
    B, H, KH, S, D = 3, 8, 2, 96, 32
    q, kc, vc = _rnd(rng, B, H, D), _rnd(rng, B, S, KH, D), \
        _rnd(rng, B, S, KH, D)
    lens = np.array([1, 50, 96], np.int32)
    got = ops.decode_attention(*_t(q, kc, vc, lens), n_splits=4)
    exp = jops.decode_attention(*_j(q, kc, vc, lens), n_splits=4,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)


def test_ops_prefix_matches_jax_ops():
    rng = np.random.default_rng(6)
    B, H, KH, Sp, Ss, D = 3, 6, 2, 128, 16, 32
    q = _rnd(rng, B, H, D)
    kp, vp = _rnd(rng, Sp, KH, D), _rnd(rng, Sp, KH, D)
    ks, vs = _rnd(rng, B, Ss, KH, D), _rnd(rng, B, Ss, KH, D)
    lens = np.array([16, 1, 9], np.int32)
    got = ops.prefix_attention(*_t(q, kp, vp, ks, vs, lens))
    exp = jops.prefix_attention(*_j(q, kp, vp, ks, vs, lens),
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)


def test_refs_match_jax_refs():
    rng = np.random.default_rng(7)
    q, k, v = _rnd(rng, 2, 6, 40, 16), _rnd(rng, 2, 3, 56, 16), \
        _rnd(rng, 2, 3, 56, 16)
    for kw in (dict(), dict(causal=False), dict(window=8),
               dict(kv_len=30)):
        np.testing.assert_allclose(
            ref.flash_attention_ref(*_t(q, k, v), **kw).numpy(),
            np.asarray(jref.flash_attention_ref(*_j(q, k, v), **kw)), **F32)
    qd = _rnd(rng, 2, 6, 16)
    kp, vp = _rnd(rng, 3, 20, 16), _rnd(rng, 3, 20, 16)
    ks, vs = _rnd(rng, 2, 3, 8, 16), _rnd(rng, 2, 3, 8, 16)
    lens = np.array([3, 8], np.int32)
    np.testing.assert_allclose(
        ref.prefix_attention_ref(*_t(qd, kp, vp, ks, vs, lens)).numpy(),
        np.asarray(jref.prefix_attention_ref(*_j(qd, kp, vp, ks, vs, lens))),
        **F32)


def test_bench_runs_on_cpu():
    before = _launches()
    rows = bench.run(device="cpu", quick=True)
    assert _launches() == before
    assert {r["kernel"] for r in rows} == {"flash", "decode", "prefix"}
    assert all(r["ok"] for r in rows)
    assert set(rows[0]) == {"kernel", "case", "max_err", "ok", "flops",
                            "intensity"}


def _cpu_dec(dtype=torch.float32, G=2, D=32, lens_dtype=torch.int32):
    B, KH, S = 2, 2, 16
    q = torch.zeros(B, G * KH, D, dtype=dtype)
    k = torch.zeros(B, KH, S, D, dtype=dtype)
    return q, k, k.clone(), torch.ones(B, dtype=lens_dtype)


@pytest.mark.parametrize("bad,err", [
    (dict(dtype=torch.float16), TypeError),
    (dict(lens_dtype=torch.int64), TypeError),
    (dict(G=5), ValueError),
    (dict(D=48), ValueError),
])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        dec_check(*_cpu_dec(**bad))


def test_wrappers_take_strided_views_and_reject_misaligned_ones():
    q, k, v, lens = _cpu_dec()
    dec_check(q, k, v, lens)
    # the model layout read in place through a transposed view
    kc = torch.zeros(2, 16, 2, 32)
    dec_check(q, kc.transpose(1, 2), kc.clone().transpose(1, 2), lens)
    with pytest.raises(ValueError):            # last dim not contiguous
        dec_check(q, k.transpose(2, 3), v.transpose(2, 3), lens)
    odd = torch.zeros(2, 2, 16, 33)[..., :32]  # 132-byte row stride
    with pytest.raises(ValueError):
        dec_check(q, odd, odd.clone()[..., :32], lens)
    with pytest.raises(ValueError):            # k and v strides differ
        dec_check(q, kc.transpose(1, 2), v, lens)
    with pytest.raises(ValueError):            # devices differ
        dec_check(q, k.to("meta"), v, lens)
    # meta tensors (shapes only): an empty output of the kernel's shape
    out = K.decode_attention(*(t.to("meta") for t in (q, k, v, lens)))
    assert out.device.type == "meta" and out.shape == q.shape
    qf, kf = torch.zeros(1, 4, 64, 16), torch.zeros(1, 2, 64, 16)
    flash_check(qf, kf, kf.clone(), torch.empty_like(qf))
    with pytest.raises(TypeError):
        flash_check(qf, kf.bfloat16(), kf.bfloat16(), torch.empty_like(qf))
    with pytest.raises(ValueError):
        flash_check(qf, kf, kf.clone(), torch.empty(1, 4, 64, 32)[..., ::2])
    qp, kp = torch.zeros(2, 6, 64), torch.zeros(3, 128, 64)
    ks, sl = torch.zeros(2, 3, 8, 64), torch.ones(2, dtype=torch.int32)
    pre_check(qp, kp, kp.clone(), (ks, ks.clone(), sl))
    with pytest.raises(ValueError):            # suffix heads differ
        pre_check(qp, kp, kp.clone(), (ks[:, :2], ks[:, :2], sl))
    with pytest.raises(ValueError):            # G 5 is not built
        pre_check(torch.zeros(2, 15, 64), kp, kp.clone())
    assert checks.GROUPS == (1, 2, 3, 4, 6, 8)
