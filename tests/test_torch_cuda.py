"""The port's CUDA kernels against their plain PyTorch versions, on the
card: paged decode, then the kernel library (split-K decode, shared-prefix
decode, flash). Needs an NVIDIA GPU and nvcc (the kernels build at first use):
every test carries the ``cuda`` marker and skips elsewhere. This file
imports no JAX, so it runs on a machine that has only the port (where
tests/conftest.py, which imports JAX, is skipped):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances: float32 atol 3e-5 / rtol 1e-4 (summation order only);
bfloat16 2e-2 absolute, about one bf16 ulp at |x| < 4, since kernel and
plain version round the same f32 result once to bf16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.bench import DEC_CASES, FLASH_CASES, PRE_CASES
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.prefix_attention import (
    prefix_attention, prefix_attention_plain, prefix_partial,
    prefix_partial_plain)

torch.set_num_threads(1)

# (B, H, KH, page, P, n_pages, D): the JAX package's paged cases, then
# the decode half of full-width smollm-360m (G 3, D 64, page 16)
CASES = [(3, 8, 2, 16, 4, 32, 64), (2, 4, 4, 8, 6, 24, 32),
         (1, 16, 8, 32, 3, 16, 128),
         (1, 15, 5, 16, 128, 400, 64), (8, 15, 5, 16, 128, 1100, 64)]


def _cuda_inputs(B, H, KH, page, P, n_pages, D, seed, dtype):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_pages, page, KH, D)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, KH, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pt = np.stack([rng.choice(n_pages, P, replace=False)
                   for _ in range(B)]).astype(np.int32)
    lens = rng.integers(1, page * P + 1, B).astype(np.int32)
    t = [torch.from_numpy(a).cuda() for a in (q, k, v, pt, lens)]
    return [t[0].to(dtype), t[1].to(dtype), t[2].to(dtype), t[3], t[4]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ for sm_90a")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(card, case, dtype):
    inp = _cuda_inputs(*case, seed=case[0], dtype=dtype)
    n0 = PA.paged_decode_attention.launches
    got = PA.paged_decode_attention(*inp)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.launches == n0 + 1
    exp = PA.paged_decode_attention_plain(*inp)
    tol = dict(atol=3e-5, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=0.0)
    torch.testing.assert_close(got.float(), exp.float(), **tol)


@pytest.mark.cuda
def test_paged_decode_kernel_rejects_cpu_mix(card):
    q, k, v, pt, lens = _cuda_inputs(*CASES[0], seed=0,
                                     dtype=torch.float32)
    with pytest.raises(ValueError):
        PA.paged_decode_attention(q, k, v, pt.cpu(), lens)


# ---------------------------------------------------------------------------
# the attention-kernel library: decode (split-K), prefix (Hydragen), flash
# ---------------------------------------------------------------------------

F32 = dict(atol=3e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=0.0)


def _tol(dtype):
    return F32 if dtype == torch.float32 else BF16


def _card(rng, dtype, *shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)


def _lens(rng, n, hi):
    lens = rng.integers(1, hi + 1, n)
    lens[0] = hi                                 # one full lane
    return torch.from_numpy(lens.astype(np.int32)).cuda()


# (B, H, KH, S, D, n_splits): the JAX package's cases, then full-width
# smollm-360m (G 3, D 64) and mistral-7b (G 4, D 128) decode at B 8
DEC_CARD = DEC_CASES + [(8, 15, 5, 2048, 64, 8), (8, 32, 8, 8192, 128, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEC_CARD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(card, case, dtype):
    B, H, KH, S, D, ns = case
    rng = np.random.default_rng(S)
    q, k, v = (_card(rng, dtype, B, H, D), _card(rng, dtype, B, KH, S, D),
               _card(rng, dtype, B, KH, S, D))
    lens = _lens(rng, B, S)
    n0 = decode_attention.launches
    got = decode_attention(q, k, v, lens, n_splits=ns)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    exp = decode_attention_plain(q, k, v, lens, n_splits=ns)
    torch.testing.assert_close(got.float(), exp.float(), **_tol(dtype))


# (B, H, KH, Sp, Ss, D): the JAX package's cases, then full-width
# smollm-360m and mistral-7b at B 32, prefix 4096, suffixes <= 256
PRE_CARD = PRE_CASES + [(32, 15, 5, 4096, 256, 64),
                        (32, 32, 8, 4096, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PRE_CARD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_kernel_matches_plain(card, case, dtype):
    B, H, KH, Sp, Ss, D = case
    rng = np.random.default_rng(Sp + Ss)
    q = _card(rng, dtype, B, H, D)
    kp, vp = _card(rng, dtype, KH, Sp, D), _card(rng, dtype, KH, Sp, D)
    ks, vs = _card(rng, dtype, B, KH, Ss, D), _card(rng, dtype, B, KH, Ss, D)
    lens = _lens(rng, B, Ss)
    n0 = prefix_partial.launches
    got = prefix_attention(q, kp, vp, ks, vs, lens)
    torch.cuda.synchronize()
    assert prefix_partial.launches == n0 + 1
    exp = prefix_attention_plain(q, kp, vp, ks, vs, lens)
    torch.testing.assert_close(got.float(), exp.float(), **_tol(dtype))
    # the raw partial of the prefix alone, f32 in both versions: acc and l
    # are unnormalised sums over up to Sp keys, so the summation-order
    # tolerance is relative, with an absolute floor for acc entries near 0
    parts = prefix_partial(q, kp, vp)
    assert prefix_partial.launches == n0 + 2
    for g, e in zip(parts, prefix_partial_plain(q, kp, vp)):
        torch.testing.assert_close(g, e, atol=1e-3, rtol=1e-4)


# (B, H, KH, Sq, Skv, D, causal, window): the JAX package's cases, then
# full-width smollm-360m causal prefill and mistral-7b's sliding window
FLASH_CARD = FLASH_CASES + [(1, 15, 5, 2048, 2048, 64, True, 0),
                            (1, 32, 8, 2048, 2048, 128, True, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CARD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(card, case, dtype):
    B, H, KH, Sq, Skv, D, causal, win = case
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (_card(rng, dtype, B, H, Sq, D),
               _card(rng, dtype, B, KH, Skv, D),
               _card(rng, dtype, B, KH, Skv, D))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    exp = flash_attention_plain(q, k, v, causal=causal, window=win)
    torch.testing.assert_close(got.float(), exp.float(), **_tol(dtype))


@pytest.mark.cuda
def test_flash_kv_len_and_rows_without_keys(card):
    rng = np.random.default_rng(1)
    q, k, v = (_card(rng, torch.float32, 2, 4, 100, 32),
               _card(rng, torch.float32, 2, 2, 130, 32),
               _card(rng, torch.float32, 2, 2, 130, 32))
    got = flash_attention(q, k, v, window=16, kv_len=70)
    exp = flash_attention_plain(q, k, v, window=16, kv_len=70)
    torch.testing.assert_close(got, exp, **F32)
    assert not got[:, :, 85:].any()              # no key in (q-16, 70)


@pytest.mark.cuda
def test_model_layout_wrappers_read_strided_views(card):
    """ops.* hand the kernels transposed views of the model layout."""
    rng = np.random.default_rng(2)
    f32 = torch.float32
    q, k, v = (_card(rng, f32, 2, 96, 6, 64), _card(rng, f32, 2, 96, 2, 64),
               _card(rng, f32, 2, 96, 2, 64))
    got = ops.flash_attention(q, k, v)
    exp = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, exp, **F32)
    qd, kc, vc = (_card(rng, f32, 3, 8, 32), _card(rng, f32, 3, 300, 2, 32),
                  _card(rng, f32, 3, 300, 2, 32))
    lens = _lens(rng, 3, 300)
    torch.testing.assert_close(
        ops.decode_attention(qd, kc, vc, lens),
        decode_attention_plain(qd, kc.transpose(1, 2), vc.transpose(1, 2),
                               lens), **F32)
    kp, vp = _card(rng, f32, 200, 2, 32), _card(rng, f32, 200, 2, 32)
    ks, vs = _card(rng, f32, 3, 20, 2, 32), _card(rng, f32, 3, 20, 2, 32)
    slen = _lens(rng, 3, 20)
    torch.testing.assert_close(
        ops.prefix_attention(qd, kp, vp, ks, vs, slen),
        prefix_attention_plain(qd, kp.transpose(0, 1), vp.transpose(0, 1),
                               ks.transpose(1, 2), vs.transpose(1, 2), slen),
        **F32)


@pytest.mark.cuda
def test_attention_kernels_reject_cpu_mix(card):
    rng = np.random.default_rng(3)
    f32 = torch.float32
    q, k = _card(rng, f32, 2, 4, 32), _card(rng, f32, 2, 2, 64, 32)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, _lens(rng, 2, 64).cpu())
    kp = _card(rng, f32, 2, 64, 32)
    with pytest.raises(ValueError):
        prefix_attention(q, kp, kp.cpu(), k, k, _lens(rng, 2, 64))
    with pytest.raises(ValueError):
        prefix_partial(q, kp.cpu(), kp)
    qf = _card(rng, f32, 1, 4, 64, 32)
    with pytest.raises(ValueError):
        flash_attention(qf, k[:1].cpu(), k[:1])
