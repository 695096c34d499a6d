"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc (the kernels build at first use):
every test carries the ``cuda`` marker and skips elsewhere. This file
imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 atol 3e-5 / rtol 1e-4 (summation order only);
bfloat16 2e-2 absolute, about one bf16 ulp at |x| < 4, since kernel and
plain version round the same f32 result once to bf16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA

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
