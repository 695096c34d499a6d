"""The split merge that the card's decode kernels are held to, against the
JAX package.

The paged and split-K decode kernels merge their splits' f32 partials in
the last split block of each (lane, KV head), and the standalone
``lse_merge_kernel`` merges the slot shards of a tensor-parallel pool; on
the card both are checked against the port's plain ``lse_merge`` and
``lse_merge_partials_plain`` (tests/test_torch_cuda.py, chip_smoke.py).
Here, on the CPU, those plain merges are held to the JAX package's
``lse_merge`` at the slot counts the split plans produce, the plain
per-split partials at a plan's own splits merged by them to the Pallas
paged kernel (interpret mode, as tests/test_kernels.py runs it), and the
split plans to the table they cover. Inputs are made from a seed with
numpy.

Tolerance: float32 atol 3e-5 / rtol 1e-4 (the JAX package's own kernel
tolerance; the two sides sum in different orders).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import lse_merge as jlse_merge
from repro.kernels.paged_attention import paged_decode_attention as jpaged
from repro_torch.kernels import paged_attention as PA

DA = importlib.import_module("repro_torch.kernels.decode_attention")

torch.set_num_threads(1)

F32 = dict(atol=3e-5, rtol=1e-4)

# the JAX side, jitted once and shared by every case (a jit caches one
# compile per shape)
_jmerge = jax.jit(jlse_merge)
_jpaged = jax.jit(functools.partial(jpaged, interpret=True))

# slot counts of the plans on the main path (PERF.md §6: smollm serve 10,
# smollm B 1 16, mistral B 8 7 and B 2 22, the masked dummy lane 32, the
# dense plan at B 1 about 50), one slot, and one chunk of 32 lanes past a
# warp's width
SLOTS = [1, 2, 7, 10, 16, 22, 32, 33, 50]


def _partials(rng, B, KH, n, G, D, p_empty=0.3):
    """acc [B, KH, n, G, D], m and l [B, KH, n, G] with empty slots (m
    -inf, l 0, acc 0) among them and lane 0 / head 0 / row 0 empty in
    every slot (the merge gives 0 there)."""
    acc = rng.standard_normal((B, KH, n, G, D)).astype(np.float32)
    m = (3 * rng.standard_normal((B, KH, n, G))).astype(np.float32)
    l = (np.abs(rng.standard_normal((B, KH, n, G))) + 0.5).astype(np.float32)
    empty = rng.random((B, KH, n, G)) < p_empty
    empty[0, 0, :, 0] = True
    m[empty] = -np.inf
    l[empty] = 0.0
    acc[empty] = 0.0
    return acc, m, l


@pytest.mark.parametrize("n", SLOTS)
def test_plain_merges_match_jax_lse_merge(n):
    """The port's ``lse_merge`` and ``lse_merge_partials_plain`` against
    the JAX ``lse_merge`` on the same partials: empty slots weigh
    nothing, a row whose every slot is empty gives 0 on both sides."""
    B, KH, G, D = 2, 3, 4, 16
    acc, m, l = _partials(np.random.default_rng(n), B, KH, n, G, D)
    exp = np.asarray(_jmerge(jnp.asarray(acc), jnp.asarray(m[..., None]),
                             jnp.asarray(l[..., None])))        # [B,KH,G,D]
    got = DA.lse_merge(torch.from_numpy(acc), torch.from_numpy(m[..., None]),
                       torch.from_numpy(l[..., None])).numpy()
    np.testing.assert_allclose(got, exp, **F32)
    flat = PA.lse_merge_partials_plain(
        *(torch.from_numpy(a) for a in (acc, m, l)), torch.float32).numpy()
    assert flat.shape == (B, KH * G, D)
    np.testing.assert_allclose(flat, exp.reshape(B, KH * G, D), **F32)
    assert np.isfinite(flat).all() and not flat[0, 0].any()
    # the CPU wrapper takes the plain version and counts no launch
    n0 = PA.lse_merge_partials.launches
    wrapped = PA.lse_merge_partials(
        *(torch.from_numpy(a) for a in (acc, m, l)), torch.float32).numpy()
    assert PA.lse_merge_partials.launches == n0
    np.testing.assert_array_equal(wrapped, flat)


# (B, H, KH, PS, P, D, tile, sms): grids of the Pallas kernel (B x KH x P)
# of at most 80 steps; a small ``sms`` makes split_plan cut the table into
# 8-16 splits as the card's 132 SMs do at the served shapes
PAGED_PLANS = [(2, 4, 2, 4, 16, 16, 4, 22),      # 16 splits of 1 page
               (2, 6, 2, 4, 16, 32, 8, 12),      # 8 of 2
               (2, 8, 2, 8, 20, 16, 16, 14),     # 10 of 2
               (3, 3, 1, 4, 24, 16, 4, 10),      # 8 of 3
               (2, 16, 2, 4, 12, 16, 4, 16)]     # G 8: 12 of 1


@pytest.mark.parametrize("case", PAGED_PLANS)
def test_plan_partials_merged_match_pallas_kernel(case):
    """``paged_decode_partials_plain`` at the plan's (n_splits, pps),
    merged by ``lse_merge_partials_plain``, against the JAX
    ``paged_decode_attention`` (interpret mode). Lane 0 has len 0 (0 on
    both sides), the last lane is full and, of three, lane 1 ends one
    token into a page."""
    B, H, KH, PS, P, D, tile, sms = case
    n, pps = PA.split_plan(B, KH, P, PS, tile, sms)
    assert 8 <= n <= 16 and n * pps >= P
    rng = np.random.default_rng(sum(case))
    n_pages = B * P + 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((n_pages, PS, KH, D)).astype(np.float32)
    v = rng.standard_normal((n_pages, PS, KH, D)).astype(np.float32)
    pt = (rng.permutation(n_pages - 1)[:B * P] + 1).reshape(B, P)
    pt = pt.astype(np.int32)
    lens = rng.integers(1, P * PS + 1, B)
    lens[0] = 0
    lens[-1] = P * PS
    if B > 2:
        lens[1] = 3 * PS + 1
    lens = lens.astype(np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, pt, lens)]
    acc, m, l = PA.paged_decode_partials_plain(*t, n, pps)
    assert acc.shape == (B, KH, n, H // KH, D)
    got = PA.lse_merge_partials_plain(acc, m, l, torch.float32).numpy()
    exp = np.asarray(_jpaged(*(jnp.asarray(a) for a in (q, k, v, pt, lens))))
    np.testing.assert_allclose(got, exp, **F32)
    assert not got[0].any()
    # and the plain one-launch function the card's kernel is held to
    np.testing.assert_allclose(PA.paged_decode_attention_plain(*t).numpy(),
                               exp, **F32)


# (B, KH, P, PS, sms): the served shapes (smollm KH 5, mistral KH 8, page
# 16, 132 SMs), tables shorter than a tile, one SM, single pages, many lanes
PLAN_GRID = [(B, KH, P, PS, sms)
             for B, KH, sms in ((1, 5, 132), (1, 8, 132), (2, 8, 132),
                                (8, 5, 132), (8, 8, 132), (32, 5, 132),
                                (1, 1, 16), (2, 5, 16), (8, 1, 1))
             for P, PS in ((1, 16), (3, 8), (64, 16), (128, 16))]


@pytest.mark.parametrize("case", PLAN_GRID)
def test_split_plans_cover_the_table(case):
    """For every tile the kernels use (bf16 and f32 at D 64 and 128), the
    paged plan covers the table (n x pps >= P) with no split wholly past
    it, and the dense plan covers a cache of P x PS keys the same way."""
    B, KH, P, PS, sms = case
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            tile = PA.tile_tokens(dtype, D)
            n, pps = PA.split_plan(B, KH, P, PS, tile, sms)
            assert n >= 1 and pps >= 1
            assert n * pps >= P and (n - 1) * pps < P
            S = P * PS
            ns, split_len = DA.split_plan(B, KH, S, tile, sms)
            assert ns >= 1 and split_len % tile == 0
            assert ns * split_len >= S and (ns - 1) * split_len < S
