"""The port's CUDA kernels against their plain PyTorch versions, on the
card: paged decode, then the kernel library (split-K decode, shared-prefix
decode, flash); then the serving planes on the card against the CPU. Needs an NVIDIA GPU and nvcc (the kernels build at first use):
every test carries the ``cuda`` marker and skips elsewhere. This file
imports no JAX, so it runs on a machine that has only the port (where
tests/conftest.py, which imports JAX, is skipped):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances: float32 atol 3e-5 / rtol 1e-4 (summation order only).
bfloat16: kernel and plain version round nearly the same f32 result once
to bf16, so an element may differ by one bf16 ulp (at most 2^-7 |x|) plus
their f32 difference (flash and the prefix half of shared-prefix decode
round P to bf16 before P V, the plain versions do not), which is held to
2^-6 of the rms of the element's output row (its last dimension). A tile
of keys lost, stale or read twice moves a row by a large share of its rms
and fails. prefix_partial's raw (acc, m, l): see _assert_partial_close.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.bench import DEC_CASES, FLASH_CASES, PRE_CASES
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain)
from repro_torch.kernels.checks import GROUPS, HEAD_DIMS
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.prefix_attention import (
    prefix_attention, prefix_attention_plain, prefix_partial,
    prefix_partial_plain)

# the kernel modules (the package's names of the same spelling are the
# functions)
DA = importlib.import_module("repro_torch.kernels.decode_attention")
PF = importlib.import_module("repro_torch.kernels.prefix_attention")

torch.set_num_threads(1)

F32 = dict(atol=3e-5, rtol=1e-4)
BF16_RTOL, BF16_ROW_RTOL = 2 ** -7, 2 ** -6


def _assert_close(got, exp, dtype):
    """got within the tolerance of exp for dtype (module doc)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got.float(), exp.float(), **F32)
        return
    g, e = got.float(), exp.float()
    assert torch.isfinite(g).all()
    err = (g - e).abs()
    bound = BF16_RTOL * e.abs() \
        + BF16_ROW_RTOL * e.pow(2).mean(-1, keepdim=True).sqrt()
    bad = err > bound
    assert not bad.any(), (
        f"{int(bad.sum())} of {err.numel()} elements over the bound, first "
        f"at {tuple(bad.nonzero()[0].tolist())}; max |err| "
        f"{err.max().item():.3e}, "
        f"{torch.where(err == 0, 0.0, err / bound).max().item():.3g}x "
        "the bound")

# (B, H, KH, page, P, n_pages, D): the JAX package's paged cases, then
# the decode half of full-width smollm-360m (G 3, D 64, page 16), then of
# full-width mistral-7b at its serve context 1024 (G 4, D 128, page 16)
CASES = [(3, 8, 2, 16, 4, 32, 64), (2, 4, 4, 8, 6, 24, 32),
         (1, 16, 8, 32, 3, 16, 128),
         (1, 15, 5, 16, 128, 400, 64), (8, 15, 5, 16, 128, 1100, 64),
         (8, 32, 8, 16, 64, 600, 128)]


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
    _assert_close(got, exp, dtype)


def _paged_split_edges(dtype, G, D, seed, KH=2, PS=16, P=32):
    """Seven lanes whose lens sit at the edges of the plan's pages and
    splits (1, PS - 1, PS, chunk - 1, chunk, chunk + 1, P * PS), lanes 5
    and 6 aliasing lane 4's first pages as prefix reuse makes them."""
    rng = np.random.default_rng(seed)
    n_pages = 8 * P
    q = _card(rng, dtype, 7, G * KH, D)
    k, v = (_card(rng, dtype, n_pages, PS, KH, D),
            _card(rng, dtype, n_pages, PS, KH, D))
    pt = np.stack([rng.choice(n_pages, P, replace=False) for _ in range(7)])
    pt[5:, :P // 2] = pt[4, :P // 2]
    pt = torch.from_numpy(pt.astype(np.int32)).cuda()
    n_splits, pps = PA.plan_for(q, k, pt)
    chunk = pps * PS
    lens = [1, PS - 1, PS, chunk - 1, chunk, min(chunk + 1, P * PS), P * PS]
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return (q, k, v, pt, lens), n_splits


@pytest.mark.cuda
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_split_edges(card, dtype, G, D):
    inp, n_splits = _paged_split_edges(dtype, G, D, seed=G * 1000 + D)
    got = PA.paged_decode_attention(*inp)
    exp = PA.paged_decode_attention_plain(*inp)
    _assert_close(got, exp, dtype)
    assert PA.occupancy(dtype, G, D)[3] == PA.tile_tokens(dtype, D)
    if dtype == torch.bfloat16 and D == 64:
        assert n_splits > 1, "the edge case must cut rows into splits"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_one_full_lane(card, dtype):
    """B 1 at full length: the plan spreads the row over many splits."""
    rng = np.random.default_rng(5)
    q = _card(rng, dtype, 1, 15, 64)
    k, v = _card(rng, dtype, 200, 16, 5, 64), _card(rng, dtype, 200, 16, 5, 64)
    pt = torch.from_numpy(rng.choice(200, (1, 128), replace=False)
                          .astype(np.int32)).cuda()
    lens = torch.tensor([2048], dtype=torch.int32, device="cuda")
    assert PA.plan_for(q, k, pt)[0] > 1
    _assert_close(PA.paged_decode_attention(q, k, v, pt, lens),
                  PA.paged_decode_attention_plain(q, k, v, pt, lens), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [50, 25])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_splits_wrap_the_ring(card, dtype, G, D, B):
    """Splits of more tiles than the cp.async ring has stages: B * KH 400
    lanes plan one split a row, 200 two; a row holds 9 or more tiles, and
    lens run from 0 to the full row."""
    rng = np.random.default_rng(G * 1000 + D + B)
    KH, PS = 8, 16
    tile = PA.tile_tokens(dtype, D)
    P = 2 * -(-9 * tile // (2 * PS))
    n_pages = B * P + 1
    q = _card(rng, dtype, B, G * KH, D)
    k = _card(rng, dtype, n_pages, PS, KH, D)
    v = _card(rng, dtype, n_pages, PS, KH, D)
    pt = torch.from_numpy(rng.permutation(n_pages)[:B * P].reshape(B, P)
                          .astype(np.int32)).cuda()
    lens = rng.integers(0, P * PS + 1, B)
    lens[:4] = [P * PS, 0, P * PS // 2 + 1, 3 * tile + 1]
    lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    n_splits, pps = PA.plan_for(q, k, pt)
    assert pps * PS > 3 * tile, "a split must hold more tiles than stages"
    _assert_close(PA.paged_decode_attention(q, k, v, pt, lens),
                  PA.paged_decode_attention_plain(q, k, v, pt, lens), dtype)


@pytest.mark.cuda
def test_paged_decode_kernel_rejects_cpu_mix(card):
    q, k, v, pt, lens = _cuda_inputs(*CASES[0], seed=0,
                                     dtype=torch.float32)
    with pytest.raises(ValueError):
        PA.paged_decode_attention(q, k, v, pt.cpu(), lens)


# ---------------------------------------------------------------------------
# the attention-kernel library: decode (split-K), prefix (Hydragen), flash
# ---------------------------------------------------------------------------

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
    _assert_close(got, exp, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [7, 9])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_splits_wrap_the_ring(card, dtype, G, D, n_tiles):
    """400 (lane, head) pairs: rows of 7 tiles plan one split a row (the
    block normalises and writes q's dtype), 9 tiles two splits of 5 (f32
    partials and the merge); either holds more tiles than the 3-stage
    cp.async ring. Lanes of length S, 1 and 0 (0 returns 0 in both
    versions, as the Pallas kernel's guard does)."""
    rng = np.random.default_rng(G * 1000 + D + n_tiles)
    B, KH = 50, 8
    S = n_tiles * DA.tile_tokens(dtype, D)
    q = _card(rng, dtype, B, G * KH, D)
    k, v = _card(rng, dtype, B, KH, S, D), _card(rng, dtype, B, KH, S, D)
    lens = rng.integers(1, S + 1, B)
    lens[:3] = [S, 1, 0]
    lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    ns, split_len = DA.plan_for(q, k)
    assert ns == (1 if n_tiles == 7 else 2)
    assert split_len > 3 * DA.tile_tokens(dtype, D)
    got = decode_attention(q, k, v, lens)
    _assert_close(got, decode_attention_plain(q, k, v, lens), dtype)
    assert not got[2].any()
    assert DA.occupancy(dtype, G, D)[3] == DA.tile_tokens(dtype, D)


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_ignores_the_pallas_split_count(card, dtype, n_splits):
    """The plain version splits as the Pallas kernel does; the card's
    kernel uses its own plan, and the merged output agrees whatever the
    keyword. Full-width smollm-360m heads, lanes of length 1 and S."""
    rng = np.random.default_rng(n_splits)
    B, H, KH, S, D = 8, 15, 5, 2048, 64
    q = _card(rng, dtype, B, H, D)
    k, v = _card(rng, dtype, B, KH, S, D), _card(rng, dtype, B, KH, S, D)
    lens = _lens(rng, B, S)
    lens[1] = 1
    ns, _ = DA.plan_for(q, k)
    assert ns > 1
    _assert_close(decode_attention(q, k, v, lens, n_splits=n_splits),
                  decode_attention_plain(q, k, v, lens, n_splits=n_splits),
                  dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_reads_the_model_layout(card, dtype):
    """ops.decode_attention hands the kernel transposed views of
    [B, S, KH, D] caches: mistral-7b's heads, splits that wrap the ring."""
    rng = np.random.default_rng(11)
    B, H, KH, S, D = 4, 32, 8, 1100, 128
    q = _card(rng, dtype, B, H, D)
    kc, vc = _card(rng, dtype, B, S, KH, D), _card(rng, dtype, B, S, KH, D)
    lens = _lens(rng, B, S)
    lens[1] = 1
    ns, split_len = DA.plan_for(q, kc.transpose(1, 2))
    assert split_len > 3 * DA.tile_tokens(dtype, D)
    _assert_close(ops.decode_attention(q, kc, vc, lens),
                  decode_attention_plain(q, kc.transpose(1, 2),
                                         vc.transpose(1, 2), lens), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 6, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_the_dense_serve_shapes(card, dtype, B):
    """The dense plane's decode at full mistral-7b width: 1024-position
    caches in the model layout, lens of 313-341-token prompts and their
    new tokens (its serve in chip_smoke.py decodes 2 and 6 lanes); one
    launch counted per call."""
    rng = np.random.default_rng(B)
    q = _card(rng, dtype, B, 32, 128)
    kc, vc = _card(rng, dtype, B, 1024, 8, 128), _card(rng, dtype, B, 1024,
                                                       8, 128)
    lens = torch.from_numpy(rng.integers(313, 350, B).astype(
        np.int32)).cuda()
    n0 = DA.decode_attention.launches
    got = ops.decode_attention(q, kc, vc, lens)
    assert DA.decode_attention.launches == n0 + 1
    _assert_close(got, decode_attention_plain(q, kc.transpose(1, 2),
                                              vc.transpose(1, 2), lens),
                  dtype)


# (B, H, KH, S, D, full): the split-K decode's calls on the recurrent,
# hybrid and cross-attention stacks' paths in chip_smoke.py: the VLM's
# cross step (every one of its 1600 vision keys valid) and self-attention
# over a 4096-position cache, jamba's attention positions (its 4096
# cache), whisper-tiny's cross step (G 1, D 64, 1500 encoder frames) and
# its self-attention (448 positions, 8 to 16 valid)
SERVE_SHAPES = [(1, 32, 8, 1600, 128, True), (2, 32, 8, 1600, 128, True),
                (1, 32, 8, 4096, 128, False), (1, 6, 6, 1500, 64, True),
                (1, 6, 6, 448, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_the_cross_and_recurrent_serve_shapes(card, dtype,
                                                              case):
    B, H, KH, S, D, full = case
    rng = np.random.default_rng(S + B)
    q = _card(rng, dtype, B, H, D)
    kc, vc = _card(rng, dtype, B, S, KH, D), _card(rng, dtype, B, S, KH, D)
    lens = (np.full(B, S) if full else
            rng.integers(8, 17, B) if S == 448 else
            rng.integers(1800, 2600, B))
    lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    n0 = DA.decode_attention.launches
    got = ops.decode_attention(q, kc, vc, lens)
    assert DA.decode_attention.launches == n0 + 1
    _assert_close(got, decode_attention_plain(q, kc.transpose(1, 2),
                                              vc.transpose(1, 2), lens),
                  dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,masked", [(1, 1), (2, 0), (8, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_at_the_mistral_serve_shapes(card, dtype, B,
                                                         masked):
    """The paged plane's decode at full mistral-7b width as its serve in
    chip_smoke.py runs it: 64-page rows (context 1024), live lanes of
    313-349 tokens holding only their own pages (zeros past them), and
    masked lanes (a prefill-only dispatch's dummy lane, a bucket's
    padding): an all-zero row, len 1."""
    rng = np.random.default_rng(100 + B)
    P, PS, n_pages = 64, 16, 1041
    q = _card(rng, dtype, B, 32, 128)
    k, v = (_card(rng, dtype, n_pages, PS, 8, 128),
            _card(rng, dtype, n_pages, PS, 8, 128))
    lens = rng.integers(313, 350, B)
    pt = np.zeros((B, P), np.int32)
    pages = rng.permutation(np.arange(1, n_pages))
    for b in range(B - masked):
        n = -(-int(lens[b]) // PS)
        pt[b, :n], pages = pages[:n], pages[n:]
    lens[B - masked:] = 1
    pt = torch.from_numpy(pt).cuda()
    lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    _assert_close(PA.paged_decode_attention(q, k, v, pt, lens),
                  PA.paged_decode_attention_plain(q, k, v, pt, lens), dtype)


def _assert_partial_close(got, q, kp, vp):
    """prefix_partial's raw (acc, m, l) against the plain version's. m and
    l are f32 on both sides from the same scores (summation order only).
    acc: the bf16 kernel rounds each probability p to bf16 before P V, as
    the Pallas kernel does, an error of at most 2^-8 p, so |acc - plain|
    <= 2^-8 sum_k p_k |v_k|; held to 2^-7 of that sum (the f32 sums' own
    rounding on top), plus the f32 tolerance. A lost or doubled key tile
    moves l far past its tolerance."""
    acc_p, m_p, l_p = prefix_partial_plain(q, kp, vp)
    for g, e in zip(got[1:], (m_p, l_p)):
        torch.testing.assert_close(g, e, atol=1e-3, rtol=1e-4)
    tol = 1e-3 + 1e-4 * acc_p.abs()
    if q.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * prefix_partial_plain(q, kp, vp.abs())[0]
    err = (got[0] - acc_p).abs()
    assert torch.isfinite(got[0]).all()
    assert (err <= tol).all(), f"{(err / tol).max().item():.3g}x the bound"


# (B, G, D): B * G folded rows 1, 64, 128 and 129 (two row tiles), at
# every head width
PREFIX_ROWS = [(1, 1), (16, 4), (32, 4), (43, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("rows", PREFIX_ROWS)
def test_prefix_bf16_folded_rows(card, rows, D):
    """The wgmma prefix half at 1, 64, 128 and 129 folded rows, a prefix
    of 1100 keys (not a multiple of the 64-key tile, more tiles than the
    4-stage ring), then the suffix and the merge."""
    B, G = rows
    rng = np.random.default_rng(B * G + D)
    KH, Sp, Ss, bf = 2, 1100, 40, torch.bfloat16
    q = _card(rng, bf, B, G * KH, D)
    kp, vp = _card(rng, bf, KH, Sp, D), _card(rng, bf, KH, Sp, D)
    ks, vs = _card(rng, bf, B, KH, Ss, D), _card(rng, bf, B, KH, Ss, D)
    lens = _lens(rng, B, Ss)
    assert PF.plan_for(q, kp, ks, 64)[0][0] > 1
    for block_k in (64, 4096):           # many splits, then one
        _assert_close(prefix_attention(q, kp, vp, ks, vs, lens,
                                       block_k=block_k),
                      prefix_attention_plain(q, kp, vp, ks, vs, lens), bf)
        _assert_partial_close(prefix_partial(q, kp, vp, block_k=block_k),
                              q, kp, vp)


# (Sp, block_k): prefixes one key short of, at and one past a tile or a
# split's end, and one split for the whole prefix
PREFIX_EDGES = [(63, 64), (64, 64), (65, 64), (255, 128), (257, 128),
                (1000, 256), (1024, 256), (1025, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", PREFIX_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_kernel_chunk_edges(card, dtype, edge):
    Sp, block_k = edge
    rng = np.random.default_rng(Sp)
    B, H, KH, Ss, D = 6, 12, 3, 33, 64
    q = _card(rng, dtype, B, H, D)
    kp, vp = _card(rng, dtype, KH, Sp, D), _card(rng, dtype, KH, Sp, D)
    ks, vs = _card(rng, dtype, B, KH, Ss, D), _card(rng, dtype, B, KH, Ss, D)
    lens = _lens(rng, B, Ss)
    (n_pre, chunk), _ = PF.plan_for(q, kp, ks, block_k)
    assert (n_pre - 1) * chunk < Sp <= n_pre * chunk and chunk % 64 == 0
    _assert_close(prefix_attention(q, kp, vp, ks, vs, lens, block_k=block_k),
                  prefix_attention_plain(q, kp, vp, ks, vs, lens), dtype)
    _assert_partial_close(prefix_partial(q, kp, vp, block_k=block_k), q, kp,
                          vp)


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
    _assert_close(got, exp, dtype)
    # the raw partial of the prefix alone (_assert_partial_close)
    parts = prefix_partial(q, kp, vp)
    assert prefix_partial.launches == n0 + 2
    _assert_partial_close(parts, q, kp, vp)


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
    _assert_close(got, exp, dtype)


# masks of the redesigned bf16 path: (causal, window, kv_len) at Sq 100
# (not a multiple of any query tile), Skv 130
FLASH_MASKS = [(True, 0, None), (False, 0, None), (True, 40, None),
               (False, 0, 77), (True, 24, 111)]


@pytest.mark.cuda
@pytest.mark.parametrize("mask", FLASH_MASKS)
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_flash_bf16_head_groups_and_masks(card, G, D, mask):
    causal, win, kv_len = mask
    rng = np.random.default_rng(G * 100 + D)
    KH = 2
    bf = torch.bfloat16
    q = _card(rng, bf, 2, G * KH, 100, D)
    k, v = _card(rng, bf, 2, KH, 130, D), _card(rng, bf, 2, KH, 130, D)
    got = flash_attention(q, k, v, causal=causal, window=win, kv_len=kv_len)
    exp = flash_attention_plain(q, k, v, causal=causal, window=win,
                                kv_len=kv_len)
    _assert_close(got, exp, torch.bfloat16)


# masks at Sq = Skv = 461: up to 8 key tiles of 64 a row (6 under the
# window or kv_len), more than the ring's 4 stages
FLASH_RING_MASKS = [(True, 0, None), (False, 0, None), (True, 330, None),
                    (False, 0, 333), (True, 300, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("mask", FLASH_RING_MASKS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_flash_bf16_key_tiles_wrap_the_ring(card, G, D, mask):
    causal, win, kv_len = mask
    rng = np.random.default_rng(G * 100 + D + 7)
    KH = 2
    bf = torch.bfloat16
    q = _card(rng, bf, 2, G * KH, 461, D)
    k, v = _card(rng, bf, 2, KH, 461, D), _card(rng, bf, 2, KH, 461, D)
    got = flash_attention(q, k, v, causal=causal, window=win, kv_len=kv_len)
    exp = flash_attention_plain(q, k, v, causal=causal, window=win,
                                kv_len=kv_len)
    _assert_close(got, exp, bf)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_flash_bf16_model_layout_views(card, G):
    """The bf16 path reads and writes transposed views of [B, S, H, D]."""
    rng = np.random.default_rng(G)
    bf = torch.bfloat16
    q = _card(rng, bf, 2, 150, 2 * G, 64)
    k, v = _card(rng, bf, 2, 150, 2, 64), _card(rng, bf, 2, 150, 2, 64)
    got = ops.flash_attention(q, k, v, window=50)
    exp = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), window=50).transpose(1, 2)
    _assert_close(got, exp, torch.bfloat16)


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


# ---------------------------------------------------------------------------
# the serving plane on the card: host tier, prefetch, speculation
# ---------------------------------------------------------------------------

def _small_engine_model(dtype="float32"):
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import ARCHS, reduced
    cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), n_layers=2,
                              dtype=dtype)
    return cfg, bridge.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")


def _tier_econf(**kw):
    from repro_torch.serving.engine import EngineConfig
    base = dict(max_context=64, chunk_size=16, max_batch_tokens=16,
                capacity_tokens=160, page_size=8,
                host_capacity_tokens=4096, prefetch_budget_tokens=128)
    base.update(kw)
    return EngineConfig(**base)


def _thrash(eng, vocab, seed=3):
    """Warm two shared prefixes, then three times: thrash them
    host-side with unique prompts and re-hit them queued behind a busy
    unique (the prefetch window), then thrash again and re-hit them on
    an idle engine (admission restores)."""
    from repro_torch.core.request import Request
    rng = np.random.default_rng(seed)
    shared = [tuple(rng.integers(1, vocab, 36).tolist()) for _ in range(2)]
    now, done, n = 0.0, [], 0

    def put(tokens, out):
        nonlocal n
        eng.scheduler.enqueue(Request(tokens=tokens, max_new_tokens=out),
                              now)
        n += 1

    def drain():
        nonlocal now
        for _ in range(3000):
            if len(done) >= n:
                return
            done.extend(eng.step(now))
            now += 0.01
        raise AssertionError("engine did not converge")

    for s in shared:
        put(s + tuple(rng.integers(1, vocab, 5).tolist()), 3)
    drain()
    for _ in range(3):
        for _ in range(3):
            put(tuple(rng.integers(1, vocab, int(rng.integers(38, 50)))
                      .tolist()), 2)
        drain()
        put(tuple(rng.integers(1, vocab, 45).tolist()), 2)
        done.extend(eng.step(now))
        now += 0.01
        for s in shared:
            put(s + tuple(rng.integers(1, vocab, 4).tolist()), 3)
        drain()
        for _ in range(3):
            put(tuple(rng.integers(1, vocab, 44).tolist()), 2)
            drain()
        for s in shared:
            put(s + tuple(rng.integers(1, vocab, 4).tolist()), 3)
        drain()
    return {tuple(r.tokens): list(r.output_tokens) for r in done}


TIER_STATS = ("demoted_tokens", "restored_tokens", "prefetch_issued",
              "prefetch_hit", "restore_dispatches", "demote_batches",
              "reused_tokens", "prefilled_tokens", "model_dispatches")


@pytest.mark.cuda
def test_host_tier_thrash_card_matches_cpu(card):
    """Demote, restore and prefetch on the card (copy stream, pinned
    buffers) against the same engine on the CPU: token-identical, same
    tier stats."""
    from repro_torch.serving.engine import Engine
    cfg, params = _small_engine_model()
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, params, _tier_econf(), device=dev)
        eng.attach_copy_log()
        runs[dev] = (_thrash(eng, cfg.vocab_size), eng)
    (cout, ceng), (gout, geng) = runs["cpu"], runs["cuda"]
    assert gout == cout
    for k in TIER_STATS:
        assert geng.stats[k] == ceng.stats[k], k
    for k in ("demoted_tokens", "restored_tokens", "prefetch_issued"):
        assert geng.stats[k] > 0, k
    geng._drain_demotes()
    geng.host_store.check_invariants()
    t = geng.copy_log.fold(block=True)
    assert t["d2h_bytes"] > 0 and t["h2d_bytes"] > 0


@pytest.mark.cuda
def test_speculation_card_matches_cpu(card):
    """A perfect draft on the card: acceptance exactly 1.0 and the CPU
    engine's tokens."""
    from repro_torch.core.request import Request
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.speculative import SpeculativeConfig
    cfg, params = _small_engine_model()
    outs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        spec = SpeculativeConfig(draft_cfg=cfg, k=4, draft_params=params)
        eng = Engine(cfg, params, EngineConfig(
            max_context=96, chunk_size=16, max_batch_tokens=128,
            max_batch_requests=16, capacity_tokens=4096, page_size=16,
            speculative=spec), device=dev)
        rng = np.random.default_rng(5)
        reqs = [Request(tokens=tuple(rng.integers(1, cfg.vocab_size,
                                                  int(rng.integers(8, 20)))
                                     .tolist()), max_new_tokens=24)
                for _ in range(6)]
        for r in reqs:
            eng.scheduler.enqueue(r, 0.0)
        now, done = 0.0, []
        while len(done) < len(reqs):
            done += eng.step(now)
            now += 0.01
        outs[dev] = [list(r.output_tokens) for r in reqs]
        stats[dev] = dict(eng.stats)
        assert not eng.draft.pool.tables
        eng.draft.pool.check_invariants()
    assert outs["cuda"] == outs["cpu"]
    g = stats["cuda"]
    assert g["spec_proposed_tokens"] > 0
    assert g["spec_acceptance_frac"] == 1.0
    assert g["model_dispatches"] == g["iterations"]
    for k in ("spec_proposed_tokens", "spec_accepted_tokens", "iterations"):
        assert g[k] == stats["cpu"][k], k


def _served_nodes(eng, vocab):
    """Serve one 40-token prompt; return its radix path with each node's
    span and the pool pages/bits that hold it."""
    from repro_torch.core.request import Request
    r = Request(tokens=tuple(np.random.default_rng(1)
                             .integers(1, vocab, 40).tolist()),
                max_new_tokens=2)
    eng.scheduler.enqueue(r, 0.0)
    now, done = 0.0, []
    while not done:
        done = eng.step(now)
        now += 0.01
    out = []
    for node in eng.scheduler.tree.match(r.tokens).path:
        t = eng.pool.tables[("node", node.path_key)]
        end = node.depth_tokens()
        start = end - len(node.tokens)
        bits = [_as_bits(a[t.pages].reshape(-1, *a.shape[2:])[start:end])
                .cpu() for a in eng._leaves]
        out.append((node, start, end, list(t.pages), bits))
    return out


def _as_bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.cuda
def test_demote_snapshot_survives_page_overwrite(card):
    """demote_many gathers the pages on the compute stream and copies
    them to the host on the copy stream; the pages are released and
    overwritten on the compute stream (behind a spin, so the copy would
    lose a race it was not ordered for) before drain. The store must
    hold the pre-overwrite bytes."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_offload import tree_leaves
    cfg, params = _small_engine_model()
    eng = Engine(cfg, params, _tier_econf(prefetch_budget_tokens=0),
                 device="cuda")
    spans = _served_nodes(eng, cfg.vocab_size)
    tier = eng.scheduler.host_tier
    torch.cuda._sleep(50_000_000)            # keep the compute stream busy
    got = tier.demote_many([n for n, *_ in spans])
    pages = sorted({p for *_, ps, _ in spans for p in ps})
    idx = torch.tensor(pages, device="cuda")
    for a in eng._leaves:
        a.index_fill_(0, idx, 7.0)           # overwrite, compute stream
    assert tier.pending_has(spans[0][0].path_key)
    tier.drain()
    assert all(bool((a[idx] == 7.0).all()) for a in eng._leaves)
    for node, start, end, _, bits in spans:
        assert got[node.path_key] == end - start
        e = eng.host_store.get(node.path_key)
        assert (e.start, e.length) == (start, end - start)
        for (_, leaf), want in zip(tree_leaves(e.kv), bits):
            np.testing.assert_array_equal(leaf, want.numpy())


@pytest.mark.cuda
def test_bf16_demote_restore_bytes_round_trip(card):
    """A bfloat16 span demoted through the scheduler's eviction and
    scattered back into fresh pages reads back bit-identical."""
    from repro_torch.serving.engine import Engine
    cfg, params = _small_engine_model("bfloat16")
    eng = Engine(cfg, params, _tier_econf(prefetch_budget_tokens=0),
                 device="cuda")
    spans = _served_nodes(eng, cfg.vocab_size)
    sch, pool = eng.scheduler, eng.pool
    sch.apply_eviction(sch.tree.plan_eviction(0, sch.used_tokens + 1), 1.0)
    eng._drain_demotes()
    pool.create(("req", -1))
    pool.append(("req", -1), spans[-1][2])
    dst = pool.tables[("req", -1)]
    for node, start, end, _, bits in spans:
        entry = eng.host_store.get(node.path_key)
        assert (entry.start, entry.length) == (start, end - start)
        pidx, sidx = eng._token_page_slots(dst, pool.page_size, start, end)
        eng._scatter_staged([(pidx, sidx, entry.kv)])
        for a, want in zip(eng._leaves, bits):
            back = a[dst.pages].reshape(-1, *a.shape[2:])[start:end]
            assert back.dtype == torch.bfloat16
            assert torch.equal(_as_bits(back).cpu(), want)


def _dense_stream(vocab):
    rng = np.random.default_rng(1)
    shared = tuple(rng.integers(1, vocab, 29).tolist())
    return [shared + tuple(rng.integers(1, vocab, 8).tolist())
            for _ in range(6)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "mistral-7b", "rwkv6-7b",
                                  "jamba-v0.1-52b", "llama-3.2-vision-11b"])
def test_dense_engine_card_matches_cpu(card, arch):
    """The dense plane (paged=False) on the card against the same engine
    on the CPU, float32 reduced config (2 layers for the attention-only
    stacks; jamba keeps its two 8-position groups): token-identical, the
    same stats, and on the card the split-K decode kernel once per
    attention position and cross-attention sub-block per decode batch
    (none for RWKV). A recurrent stack reuses only a stored snapshot (a
    whole earlier prompt but its last token), so its second wave also
    repeats the first prompt."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.request import Request
    from repro_torch.models.transformer import layer_plan
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    if cfg.group_size == 1 and not cfg.attention_free:
        cfg = dataclasses.replace(cfg, n_layers=2)
    calls = cfg.n_groups * sum((p.mixer == "attn") + p.cross
                               for p in layer_plan(cfg))
    prompts = _dense_stream(cfg.vocab_size)
    if any(p.mixer != "attn" for p in layer_plan(cfg)):
        prompts.append(prompts[0])
    params = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    outs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, params, EngineConfig(
            max_context=64, chunk_size=16, max_batch_tokens=64,
            capacity_tokens=4096, page_size=16, paged=False), device=dev)
        reqs = [Request(tokens=p, max_new_tokens=4) for p in prompts]
        n0 = DA.decode_attention.launches
        now, done = 0.0, []
        for wave in (reqs[:2], reqs[2:]):
            for r in wave:
                eng.scheduler.enqueue(r, now)
            target = len(done) + len(wave)
            while len(done) < target:
                done += eng.step(now)
                now += 0.01
        launched = DA.decode_attention.launches - n0
        want = calls * eng.stats["decode_batches"] if dev == "cuda" else 0
        assert launched == want and eng.stats["decode_batches"] > 0
        outs[dev] = [list(r.output_tokens) for r in reqs]
        stats[dev] = dict(eng.stats)
    assert outs["cuda"] == outs["cpu"]
    assert stats["cuda"] == stats["cpu"]
    assert stats["cuda"]["reused_tokens"] > 0


# ---------------------------------------------------------------------------
# tensor-parallel instances: slot-shard partials, their merge, TP engines
# ---------------------------------------------------------------------------

# (B, H, KH, slot shard's page, P, n_pages, D): full-width smollm-360m's
# slot shards at TP 2 and 4 (page 16 split in 8 or 4 slots), the reduced
# config's (H 2, KH 1, D 16), and a wide table
SLOT_CASES = [(8, 15, 5, 8, 64, 300, 64), (8, 15, 5, 4, 64, 300, 64),
              (4, 2, 1, 8, 6, 40, 16), (2, 32, 8, 8, 128, 300, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SLOT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_partials_and_merge_match_plain(card, case, dtype):
    """The partials entry (split kernel, merge skipped) against its plain
    version on the kernel's own split plan, lanes of len 0 (an empty slot
    shard: m -inf, l 0) included; the merge wrapper against the torch
    lse_merge on the same partials, and both against the plain paged
    attention."""
    B, H, KH, page, P, n_pages, D = case
    q, kp, vp, pt, lens = _cuda_inputs(*case, seed=21, dtype=dtype)
    lens[0] = 0
    n_splits, pps = PA.plan_for(q, kp, pt)
    n0 = PA.paged_decode_partials.launches
    acc, m, l = PA.paged_decode_partials(q, kp, vp, pt, lens)
    assert PA.paged_decode_partials.launches == n0 + 1
    pacc, pm, pl = PA.paged_decode_partials_plain(q, kp, vp, pt, lens,
                                                  n_splits, pps)
    assert acc.shape == pacc.shape == (B, KH, n_splits, H // KH, D)
    assert torch.isinf(m[0]).all() and (l[0] == 0).all()
    torch.testing.assert_close(m, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, pl, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(acc, pacc, atol=1e-4, rtol=1e-4)
    n1 = PA.lse_merge_partials.launches
    out = PA.lse_merge_partials(acc, m, l, dtype)
    assert PA.lse_merge_partials.launches == n1 + 1
    _assert_close(out, PA.lse_merge_partials_plain(acc, m, l, dtype), dtype)
    _assert_close(out, PA.paged_decode_attention_plain(q, kp, vp, pt, lens),
                  dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,heads,kv_heads,tp", [
    ("smollm-360m", 2, 1, 2), ("smollm-360m", 2, 1, 4),
    ("smollm-360m", 2, 2, 2), ("mistral-7b", 2, 1, 2)])
def test_tp_engine_card_matches_cpu(card, arch, heads, kv_heads, tp):
    """A tensor-parallel engine with its shards on one card against the
    same engine with its shards on the CPU, float32 reduced configs:
    token-identical, the same stats; on the card the slot shards run the
    partials entry and one merge per layer and dispatch, head shards the
    paged kernel once per shard, layer and dispatch."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.request import Request
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = dataclasses.replace(reduced(ARCHS[arch]), n_layers=2,
                              dtype="float32", n_heads=heads,
                              n_kv_heads=kv_heads)
    params = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    outs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, params, EngineConfig(
            max_context=64, chunk_size=16, max_batch_tokens=64,
            capacity_tokens=4096 // tp, page_size=16,
            chips_per_instance=tp), device=dev,
            devices=[dev] * tp if dev == "cuda" else None)
        reqs = [Request(tokens=p, max_new_tokens=4)
                for p in _dense_stream(cfg.vocab_size)]
        n0 = (PA.paged_decode_attention.launches,
              PA.paged_decode_partials.launches,
              PA.lse_merge_partials.launches)
        now, done = 0.0, []
        for wave in (reqs[:2], reqs[2:]):
            for r in wave:
                eng.scheduler.enqueue(r, now)
            target = len(done) + len(wave)
            while len(done) < target:
                done += eng.step(now)
                now += 0.01
        got = (PA.paged_decode_attention.launches - n0[0],
               PA.paged_decode_partials.launches - n0[1],
               PA.lse_merge_partials.launches - n0[2])
        n = cfg.n_layers * eng.stats["model_dispatches"]
        if dev == "cpu":
            assert got == (0, 0, 0)
        elif eng.plan.pool == "head":
            assert got == (n * tp, 0, 0)
        else:
            assert eng.plan.pool == "slot" and got == (0, n * tp, n)
        eng.pool.check_invariants()
        outs[dev] = [list(r.output_tokens) for r in reqs]
        stats[dev] = {k: v for k, v in eng.stats.items()
                      if not k.endswith("_seconds")}
    assert outs["cuda"] == outs["cpu"]
    assert stats["cuda"] == stats["cpu"]
    assert stats["cuda"]["reused_tokens"] > 0


# ---------------------------------------------------------------------------
# MoE models: G 6 kernels (48/8 heads and their TP shards), MoE engines
# ---------------------------------------------------------------------------

# (B, H, KH, page, P, n_pages, D): grok-1-314b / mixtral-8x22b decode
# (48 / 8 heads, D 128) at one chip and their head shards at TP 2 and 4
MOE_PAGED = [(8, 48, 8, 16, 64, 600, 128), (2, 24, 4, 16, 64, 300, 128),
             (8, 12, 2, 16, 64, 600, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_PAGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_g6_paged_partials_and_decode_match_plain(card, case, dtype):
    """G 6 at D 128: paged decode and its partials entry on ragged lanes
    (one of them empty), and the split-K decode on the model-layout view
    of a dense cache of the same lanes, each against its plain version."""
    B, H, KH, page, P, n_pages, D = case
    q, kp, vp, pt, lens = _cuda_inputs(*case, seed=31, dtype=dtype)
    lens[1] = 0
    _assert_close(PA.paged_decode_attention(q, kp, vp, pt, lens),
                  PA.paged_decode_attention_plain(q, kp, vp, pt, lens),
                  dtype)
    n_splits, pps = PA.plan_for(q, kp, pt)
    acc, m, l = PA.paged_decode_partials(q, kp, vp, pt, lens)
    pacc, pm, pl = PA.paged_decode_partials_plain(q, kp, vp, pt, lens,
                                                  n_splits, pps)
    assert acc.shape == (B, KH, n_splits, 6, D)
    torch.testing.assert_close(m, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, pl, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(acc, pacc, atol=1e-4, rtol=1e-4)
    rng = np.random.default_rng(32)
    S = P * page
    k = _card(rng, dtype, B, S, KH, D).transpose(1, 2)
    v = _card(rng, dtype, B, S, KH, D).transpose(1, 2)
    n0 = decode_attention.launches
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    _assert_close(got, decode_attention_plain(q, k, v, lens), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,paged,tp", [
    ("mixtral-8x22b", None, 1), ("grok-1-314b", False, 1),
    ("grok-1-314b", None, 2), ("mixtral-8x22b", None, 4)])
def test_moe_engine_card_matches_cpu(card, arch, paged, tp):
    """Reduced float32 MoE engines (E 4, top 2) on the card against the
    same engines on the CPU: token-identical, the same stats, the routed
    MoE reading its expert counts back once a call, and the data plane's
    kernel launched once per layer (and shard) per dispatch or decode
    batch."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.request import Request
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = dataclasses.replace(reduced(ARCHS[arch]), n_layers=2,
                              dtype="float32")
    params = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    outs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, params, EngineConfig(
            max_context=64, chunk_size=16, max_batch_tokens=64,
            capacity_tokens=4096 // tp, page_size=16, paged=paged,
            chips_per_instance=tp), device=dev,
            devices=[dev] * tp if dev == "cuda" and tp > 1 else None)
        reqs = [Request(tokens=p, max_new_tokens=4)
                for p in _dense_stream(cfg.vocab_size)]
        n0 = (PA.paged_decode_attention.launches,
              PA.paged_decode_partials.launches,
              DA.decode_attention.launches)
        m0 = dict(L.MOE_STATS)
        now, done = 0.0, []
        for wave in (reqs[:2], reqs[2:]):
            for r in wave:
                eng.scheduler.enqueue(r, now)
            target = len(done) + len(wave)
            while len(done) < target:
                done += eng.step(now)
                now += 0.01
        got = (PA.paged_decode_attention.launches - n0[0],
               PA.paged_decode_partials.launches - n0[1],
               DA.decode_attention.launches - n0[2])
        calls = L.MOE_STATS["calls"] - m0["calls"]
        assert calls > 0 and L.MOE_STATS["host_syncs"] - m0["host_syncs"] \
            == calls
        if dev == "cuda":
            n = cfg.n_layers * tp
            if paged is False:
                assert got == (0, 0, n * eng.stats["decode_batches"])
            elif eng.plan is None or eng.plan.pool == "head":
                assert got == (n * eng.stats["model_dispatches"], 0, 0)
            else:
                assert got == (0, n * eng.stats["model_dispatches"], 0)
        outs[dev] = [list(r.output_tokens) for r in reqs]
        stats[dev] = {k: v for k, v in eng.stats.items()
                      if not k.endswith("_seconds")}
    assert outs["cuda"] == outs["cpu"]
    assert stats["cuda"] == stats["cpu"]
    assert stats["cuda"]["reused_tokens"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b",
                                  "rwkv6-7b", "jamba-v0.1-52b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_train_step_card_matches_cpu(card, arch):
    """One make_train_step step of a reduced float32 family on the card
    and on the CPU, same parameters and batch, lr 3e-3 from step 0: loss
    and grad norm within 1e-4 relative, every updated parameter within
    2.1 lr (an Adam step on a gradient near 0 is +-lr either way). The
    parameters are drawn in the specs' init kinds with "fan_in" at 0.3 of
    the reference's scale (tests/test_torch_loss.py: at the full scale
    float32 rounding moves a reduced stack's grads by up to 3e-2)."""
    import dataclasses
    import math
    from repro_torch import bridge
    from repro_torch import train as T
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import zoo
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    g = torch.Generator().manual_seed(0)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        if t.init in ("zeros", "ones"):
            return torch.full(t.shape, float(t.init == "ones"))
        scale = (0.3 / math.sqrt(t.shape[-2]) if t.init == "fan_in"
                 else t.scale)
        return scale * torch.randn(t.shape, generator=g)

    params = draw(bridge.param_specs(cfg))
    S = cfg.max_target_len if cfg.encoder_decoder else 32
    toks = torch.randint(0, cfg.vocab_size, (2, S + 1), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.cross_attn_period and not cfg.encoder_decoder:
        batch["vision"] = torch.randn(2, cfg.n_vision_tokens, cfg.d_model,
                                      generator=g)
    if cfg.encoder_decoder:
        batch["frames"] = torch.randn(2, 20, cfg.d_model, generator=g)
    tc = T.TrainConfig(adamw=T.AdamWConfig(lr=3e-3), warmup_steps=0,
                       total_steps=10)
    step = T.make_train_step(zoo.build(cfg), tc)
    res = {}
    for dev in ("cpu", "cuda"):
        state = T.init_state(bridge.tree_to(params, dev), tc)
        new, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        res[dev] = (bridge.tree_to(new.params, "cpu"), m)
    (pc, mc), (pg, mg) = res["cpu"], res["cuda"]
    for k in ("loss", "grad_norm"):
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * abs(float(mc[k]))
    lr = float(mc["lr"])

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
            return
        assert (a - b).abs().max().item() <= 2.1 * lr

    walk(pc, pg)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b"])
@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("opts", [{}, dict(grad_accum=2,
                                           compress_grads=True,
                                           quant_moments=True)],
                         ids=["default", "all-switches"])
def test_sharded_train_step_card_matches_cpu(card, arch, shape, opts):
    """One make_sharded_train_step step of reduced float32 smollm-360m
    and mixtral-8x22b, every shard of the mesh on the card, against the
    one-device make_train_step on the CPU from the same parameters and
    batch: loss and grad norm within 1e-4 relative, parameters within
    2.1 lr (test_train_step_card_matches_cpu's tolerances); the state
    round-trips through a sharded checkpoint onto one card shard."""
    import dataclasses
    import math
    import tempfile
    from repro_torch import bridge
    from repro_torch import train as T
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import mesh as M
    from repro_torch.models import zoo
    from repro_torch.train import sharded as SH
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    g = torch.Generator().manual_seed(0)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        if t.init in ("zeros", "ones"):
            return torch.full(t.shape, float(t.init == "ones"))
        scale = (0.3 / math.sqrt(t.shape[-2]) if t.init == "fan_in"
                 else t.scale)
        return scale * torch.randn(t.shape, generator=g)

    params = draw(bridge.param_specs(cfg))
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = T.TrainConfig(adamw=T.AdamWConfig(lr=3e-3), warmup_steps=0,
                       total_steps=10, **opts)
    api = zoo.build(cfg)
    ref, mc = T.make_train_step(api, tc)(T.init_state(params, tc), batch)
    mesh = M.make_mesh(*shape, devices=["cuda"] * (shape[0] * shape[1]))
    step = SH.make_sharded_train_step(api, tc, mesh)
    shards = SH.shard_state(T.init_state(bridge.tree_to(params, "cuda"),
                                         tc), step.sharding)
    new, mg = step(shards, {k: v.cuda() for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * abs(float(mc[k]))
    lr = float(mc["lr"])
    got = SH.unshard_state(new, step.sharding, "cpu")
    for a, b in zip(T.optimizer.leaves(ref.params),
                    T.optimizer.leaves(got.params)):
        assert (a - b).abs().max().item() <= 2.1 * lr
    with tempfile.TemporaryDirectory() as d:
        T.save_checkpoint(d, [s.as_dict() for s in new], 1,
                          shardings=step.sharding)
        one = M.make_mesh(1, 1, devices=["cuda"])
        back = T.restore_checkpoint(
            d, shardings=SH.state_sharding(api.specs, one, tc))
    assert len(back) == 1
    for a, b in zip(T.optimizer.leaves(got.as_dict()),
                    T.optimizer.leaves(back[0])):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu())


# ---------------------------------------------------------------------------
# the split merge: inside the last split block, and the standalone kernel
# ---------------------------------------------------------------------------

def _counters_clean(dev="cuda"):
    """Every arrival counter of the current stream's workspace is back at
    0 (the last block of each (lane, head) resets its own)."""
    torch.cuda.synchronize()
    return bool((PA.arrival_counters(torch.device(dev), 0) == 0).all())


def _paged_lanes(rng, dtype, G, D, lens, P, KH=2, PS=16):
    """q, a pool of distinct pages for len(lens) lanes, and their lens."""
    B = len(lens)
    n_pages = B * P + 1
    q = _card(rng, dtype, B, G * KH, D)
    k, v = (_card(rng, dtype, n_pages, PS, KH, D),
            _card(rng, dtype, n_pages, PS, KH, D))
    pt = (rng.permutation(n_pages - 1)[:B * P] + 1).reshape(B, P)
    pt = torch.from_numpy(pt.astype(np.int32)).cuda()
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, pt, lens


def _paged_one_launch_is_partials_plus_merge(inp, dtype):
    """The one-launch call equals the partials entry merged by the
    standalone kernel, bit for bit, launching once; and it agrees with
    the plain version."""
    n0 = PA.paged_decode_attention.launches
    got = PA.paged_decode_attention(*inp)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.launches == n0 + 1
    two = PA.lse_merge_partials(*PA.paged_decode_partials(*inp), dtype)
    assert torch.equal(got, two), \
        f"max |one - two| {(got.float() - two.float()).abs().max().item()}"
    _assert_close(got, PA.paged_decode_attention_plain(*inp), dtype)
    assert _counters_clean()


def _dense_one_launch_is_partials_plus_merge(inp, plan, dtype):
    n0 = decode_attention.launches
    got = DA._launch(*inp, plan)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    acc, m, l = DA._launch(*inp, plan, partials=True)
    assert acc.shape[2] == plan[0]
    two = PA.lse_merge_partials(acc, m, l, dtype)
    assert torch.equal(got, two), \
        f"max |one - two| {(got.float() - two.float()).abs().max().item()}"
    _assert_close(got, decode_attention_plain(*inp), dtype)
    assert _counters_clean()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_launch_paged_equals_partials_plus_merge(card, dtype, G, D):
    """Lanes of len 0, 1, one page, one tile plus one, and a full one;
    then lanes that all end in the table's first third, so that its last
    splits are past every lane's end."""
    rng = np.random.default_rng(G * D)
    P, PS = 32, 16
    tile = PA.tile_tokens(dtype, D)
    for lens in ([0, 1, PS, tile + 1, P * PS], [0, 5, P * PS // 3, 40]):
        inp = _paged_lanes(rng, dtype, G, D, lens, P)
        n_splits, pps = PA.plan_for(inp[0], inp[1], inp[3])
        assert n_splits > 2
        if lens[-1] != P * PS:
            assert (n_splits - 1) * pps * PS > max(lens)
        _paged_one_launch_is_partials_plus_merge(inp, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_launch_dense_equals_partials_plus_merge(card, dtype, G, D):
    """The split-K decode on the model-layout view, its own plan, lanes
    of len 0 and lanes that end before the cache's last splits."""
    rng = np.random.default_rng(G * D + 1)
    B, KH, S = 4, 2, 1500
    q = _card(rng, dtype, B, G * KH, D)
    k = _card(rng, dtype, B, S, KH, D).transpose(1, 2)
    v = _card(rng, dtype, B, S, KH, D).transpose(1, 2)
    for lens in ([0, 1, 700, S], [0, 3, 100, 350]):
        inp = (q, k, v, torch.tensor(lens, dtype=torch.int32,
                                     device="cuda"))
        plan = DA.plan_for(q, k)
        assert plan[0] > 2
        _dense_one_launch_is_partials_plus_merge(inp, plan, dtype)


# split counts of the main path's plans (PERF.md §6), one, and past 32
SPLITS = [1, 2, 7, 16, 22, 32, 33, 50]


@pytest.mark.cuda
@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_launch_at_every_split_count(card, dtype, n):
    """Paged (one lane a KV head's plan of n splits: a table of n whole
    splits of one tile) and dense (n splits of one tile through _launch)
    at G 4, D 128 and G 3, D 64, lanes of len 0 and lanes that end early."""
    rng = np.random.default_rng(n)
    for G, D in ((4, 128), (3, 64)):
        tile = PA.tile_tokens(dtype, D)
        min_pages = -(-tile // 16)
        inp = _paged_lanes(rng, dtype, G, D, [n * tile, 0], n * min_pages)
        assert PA.plan_for(inp[0], inp[1], inp[3])[0] == n
        _paged_one_launch_is_partials_plus_merge(inp, dtype)
        S = n * tile
        B, KH = 3, 2
        q = _card(rng, dtype, B, G * KH, D)
        k, v = (_card(rng, dtype, B, KH, S, D), _card(rng, dtype, B, KH, S, D))
        lens = torch.tensor([S, 0, max(1, S // 3)], dtype=torch.int32,
                            device="cuda")
        _dense_one_launch_is_partials_plus_merge((q, k, v, lens), (n, tile),
                                                 dtype)


@pytest.mark.cuda
def test_counter_workspace_back_to_back_and_on_a_second_stream(card):
    """Calls of different shapes queued back to back share the current
    stream's counters with no sync between them; a call on a second
    stream takes that stream's own workspace. Each output equals the
    plain version, and every counter is left at 0."""
    rng = np.random.default_rng(99)
    bf = torch.bfloat16
    calls = []
    for G, D, lens, P in ((3, 64, [0, 700, 1024, 9], 64),
                          (4, 128, [2048], 128), (8, 64, [5, 300], 32)):
        inp = _paged_lanes(rng, bf, G, D, lens, P)
        calls.append((PA.paged_decode_attention, PA.paged_decode_attention_plain,
                      inp))
        S = P * 16
        B = len(lens)
        q = _card(rng, bf, B, G * 2, D)
        k, v = _card(rng, bf, B, 2, S, D), _card(rng, bf, B, 2, S, D)
        calls.append((decode_attention, decode_attention_plain,
                      (q, k, v, inp[4])))
    outs = [fn(*inp) for fn, _, inp in calls]          # no sync between
    for (_, plain, inp), got in zip(calls, outs):
        _assert_close(got, plain(*inp), bf)
    assert _counters_clean()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs = [fn(*inp) for fn, _, inp in calls]
        ws_side = PA.arrival_counters(torch.device("cuda"), 0)
    side.synchronize()
    assert ws_side.data_ptr() != PA.arrival_counters(
        torch.device("cuda"), 0).data_ptr()
    for (_, plain, inp), got in zip(calls, outs):
        _assert_close(got, plain(*inp), bf)
    assert bool((ws_side == 0).all()) and _counters_clean()


# slot counts around a warp's 32 lanes (the merge loads 32 slots' m and l
# at a time)
MERGE_SLOTS = [1, 31, 32, 33, 50]


@pytest.mark.cuda
@pytest.mark.parametrize("n", MERGE_SLOTS)
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_standalone_merge_matches_plain(card, dtype, D, n):
    """lse_merge_partials (normalised output in dtype) against its plain
    version on partials with empty slots and a row whose every slot is
    empty (0 on both sides)."""
    rng = np.random.default_rng(n * D)
    B, KH, G = 3, 2, 3
    acc = rng.standard_normal((B, KH, n, G, D)).astype(np.float32)
    m = (3 * rng.standard_normal((B, KH, n, G))).astype(np.float32)
    l = (np.abs(rng.standard_normal((B, KH, n, G))) + 0.5).astype(np.float32)
    empty = rng.random((B, KH, n, G)) < 0.3
    empty[0, 0, :, 0] = True
    m[empty], l[empty], acc[empty] = -np.inf, 0.0, 0.0
    acc, m, l = (torch.from_numpy(a).cuda() for a in (acc, m, l))
    n0 = PA.lse_merge_partials.launches
    got = PA.lse_merge_partials(acc, m, l, dtype)
    torch.cuda.synchronize()
    assert PA.lse_merge_partials.launches == n0 + 1
    exp = PA.lse_merge_partials_plain(acc, m, l, dtype)
    _assert_close(got, exp, dtype)
    assert not got[0, 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", MERGE_SLOTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_standalone_merge_combined_partial_matches_plain(card, dtype, n):
    """The merge's other mode, the combined unnormalised partial (acc, m,
    l), as prefix_partial runs it over n prefix splits of one 64-key
    tile, against the plain prefix partial."""
    rng = np.random.default_rng(n + 7)
    B, H, KH, D = 5, 12, 3, 64
    Sp = n * 64 - 5
    q = _card(rng, dtype, B, H, D)
    kp, vp = _card(rng, dtype, KH, Sp, D), _card(rng, dtype, KH, Sp, D)
    got = PF._launch(q, kp, vp, None, ((n, 64), (0, 0)))
    torch.cuda.synchronize()
    _assert_partial_close(got, q, kp, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_count_equals_the_card_count(card, kind):
    """One reduced bf16 smollm-360m step counted on the card (the split-K
    kernel by its formula) equals its count on meta tensors exactly."""
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.launch import dryrun, mesh
    cfg = reduced(get_config("smollm-360m"))
    shape = {"train": ShapeSpec("t", 64, 2, "train"),
             "prefill": ShapeSpec("p", 128, 2, "prefill"),
             "decode": ShapeSpec("d", 128, 4, "decode")}[kind]
    counts = {}
    for dev in ("meta", "cuda"):
        cell = dryrun.build_cell(cfg, shape, mesh=mesh.make_mesh(1, 1, [dev]),
                                 device=dev)
        c = dryrun.count_cell(cell)
        counts[dev] = (c.dot_flops, c.dot_bytes, c.dots, c.kernels)
    assert counts["cuda"] == counts["meta"]
    assert counts["cuda"][0] > 0
    assert bool(counts["cuda"][3]) == (kind == "decode")


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_slot_decode_count_is_the_same_on_meta_and_the_card(card, tp):
    """A tensor-parallel paged decode on a slot-wise pool (tp shards on
    the one card, bf16) splits each shard's partials ns > 1 ways on the
    card and one way on meta; its count is the same on both, the merge
    charged one f32 slot a shard (``counting.merge_cost``)."""
    from repro_torch.analysis import counting
    from repro_torch.launch import mesh as tmesh, sharding as tsh
    from repro_torch.models import attention as tatt
    B, H, KH, D, PS, P, N = 3, 8, 2, 64, 16, 32, 80
    g = torch.Generator().manual_seed(7)
    q = torch.randn(B, H, D, generator=g).to(torch.bfloat16)
    kp, vp = (torch.randn(N, PS, KH, D, generator=g).to(torch.bfloat16)
              for _ in range(2))
    pt = torch.randint(1, N, (B, P), generator=g, dtype=torch.int32)
    lens = torch.full((B,), P * PS, dtype=torch.int32)
    sl, hs = PS // tp, H // tp
    counts = {}
    for dev in ("meta", "cuda"):
        plan = tsh.ShardPlan(mesh=tmesh.make_mesh(1, tp, [dev] * tp),
                             heads=True, kv_heads=False, ff=True, vocab=True,
                             pool="slot", n_pages=N, page_size=PS)
        qs = [q[:, s * hs:(s + 1) * hs].contiguous().to(dev)
              for s in range(tp)]
        pages = [{n: t[:, s * sl:(s + 1) * sl].contiguous().to(dev)
                  for n, t in (("k", kp), ("v", vp))} for s in range(tp)]
        if dev == "cuda":
            assert PA.plan_for(q.to(dev), pages[0]["k"], pt.to(dev))[0] > 1
        with counting.Counter() as c:
            out = tatt.paged_attention_tp(qs, pages, [pt.to(dev)] * tp,
                                          [lens.to(dev)] * tp, plan, H)
        counts[dev] = (c.dot_flops, c.dot_bytes, c.kernels,
                       c.collective_bytes, c.collective_counts)
    torch.cuda.synchronize()
    assert all(torch.isfinite(o.float()).all() for o in out)
    assert counts["cuda"] == counts["meta"]
    assert counts["cuda"][2]["paged_decode_partials"]["calls"] == tp
