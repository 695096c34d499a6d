"""Split-K decode attention (flash-decoding): the hand-written Hopper
kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py::
decode_attention`` (grid (B, KH, n_splits) of per-chunk softmax partials
merged by the jnp ``lse_merge``). The CUDA source is
``csrc/decode_attention.cu``, built on the split-KV body of
``csrc/split_kv.cuh``; its header says what bounds the kernel on an H100
(memory: the valid KV bytes) and what its design does about that (K/V
tiles staged by a cp.async ring, lanes of a warp splitting D with the G
query rows in registers, per-lane-group softmax state, f32 partials in
one scratch buffer merged in the same launch by the last split block of
each (lane, KV head), through the arrival counters of
``paged_attention.arrival_counters``).

``split_plan`` chooses the splits on the host from B, KH, S, the tile and
the SM count only, never from ``lens`` (reading them back would sync).
The public ``n_splits`` keeps its meaning for the plain version
(``split_layout`` is the Pallas clamp, so the CPU result matches the JAX
kernel's split for split); on the card the kernel uses its own plan,
since the merged output does not depend on the split beyond f32
rounding.

``decode_attention`` takes the plain version only for tensors that lie
on the CPU. For CUDA tensors it launches the kernel or raises; it never
falls back. For meta tensors it returns an empty output. While an
``analysis.counting.Counter`` is active, each call counts the kernel's
work by its formula (``counting.decode_cost``) on every device.
``decode_attention.launches`` counts calls that launched the kernel (one
launch a call, whatever the split count), never plain-version calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..analysis import counting
from . import build, checks
from .paged_attention import arrival_counters, tile_tokens

NEG_INF = float("-inf")
_LIB = "decode_attention"
BLOCKS_PER_SM = 8        # the split plan's aim: two waves of ~4 blocks/SM
MIN_TILES = 4            # tiles a split holds when the card is full anyway


def split_layout(S: int, n_splits: int) -> Tuple[int, int]:
    """(splits, keys per split) exactly as the Pallas wrapper clamps
    ``n_splits`` (at most one split per 128 keys) and pads S."""
    n = max(min(n_splits, S // max(1, min(S, 128))), 1)
    block_k = max(-(-S // n), 8)
    return -(-S // block_k), block_k


def lse_merge(acc, m, l, axis: int = 2):
    """Combine split-K softmax partials: acc [..., ns, G, D],
    m/l [..., ns, G, 1] -> [..., G, D]. A row whose every split is empty
    (m -inf) gives 0."""
    m_max = m.amax(dim=axis, keepdim=True)
    m_safe = torch.where(m_max == NEG_INF, 0.0, m_max)
    w = torch.exp(m - m_safe)                    # [..., ns, G, 1]
    l_tot = (l * w).sum(dim=axis)                # [..., G, 1]
    o = (acc * w).sum(dim=axis)                  # [..., G, D]
    return o / torch.clamp(l_tot, min=1e-30)


def decode_partials_plain(q, k, v, lens, n_split: int, block_k: int):
    """Per-split partials in f32 as the Pallas kernel computes them:
    acc [B, KH, ns, G, D], m and l [B, KH, ns, G, 1]."""
    B, H, D = q.shape
    KH, S = k.shape[1], k.shape[2]
    G = H // KH
    pad = n_split * block_k - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    kf = kf.reshape(B, KH, n_split, block_k, D)
    vf = vf.reshape(B, KH, n_split, block_k, D)
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bhnkd->bhngk", qg, kf) * (D ** -0.5)
    pos = torch.arange(n_split * block_k, device=q.device).reshape(
        n_split, block_k)
    valid = torch.clamp(lens.to(q.device).long(), max=S)
    mask = pos[None] < valid[:, None, None]              # [B, ns, bk]
    s = s.masked_fill(~mask[:, None, :, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhngk,bhnkd->bhngd", p, vf)
    return acc, m, l


def decode_attention_plain(q, k, v, lens, *, n_splits: int = 8):
    """The kernel's function in plain PyTorch, f32 throughout: q [B, H, D];
    k/v [B, KH, S, D]; lens [B] -> [B, H, D] in q's dtype. A lane with
    len 0 returns 0, as the Pallas kernel does."""
    B, H, D = q.shape
    ns, block_k = split_layout(k.shape[2], n_splits)
    acc, m, l = decode_partials_plain(q, k, v, lens, ns, block_k)
    return lse_merge(acc, m, l).reshape(B, H, D).to(q.dtype)


def split_plan(B: int, KH: int, S: int, tile: int,
               sms: int) -> Tuple[int, int]:
    """(n_splits, keys per split) of the kernel for a batch of B lanes of
    S keys: each split a whole number of ``tile``-key tiles; about
    BLOCKS_PER_SM blocks on each of ``sms`` SMs, so that the block
    scheduler evens out ragged lanes; no split shorter than MIN_TILES
    tiles unless that leaves less than one block per SM (B 1), and then
    down to one tile. Host-known values only: no lane length is read."""
    n_tiles = -(-S // tile)
    lanes = max(1, B * KH)
    want = -(-sms * BLOCKS_PER_SM // lanes)
    wave = -(-sms // lanes)
    most = max(n_tiles // MIN_TILES, min(wave, n_tiles), 1)
    n = max(1, min(want, most))
    per = -(-n_tiles // n)                   # tiles a split
    if -(-n_tiles // per) * lanes < sms:     # short of a wave: round down
        per = max(1, n_tiles // n)
    return -(-n_tiles // per), per * tile


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.repro_decode_attention
    if fn.argtypes is None:             # first load: declare the C types
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.repro_decode_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
        occ.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return _declare(build.load(_LIB))


def _check_cuda(q, k, v, lens) -> None:
    """Raise on anything the kernel does not take."""
    fn = "decode_attention"
    checks.same_device_and_dtype(fn, q, int32=("lens",), k=k, v=v, lens=lens)
    if q.dim() != 3 or k.dim() != 4 or lens.dim() != 1:
        raise ValueError(f"{fn}: expected q [B,H,D], k/v [B,KH,S,D], "
                         "lens [B]")
    B, H, D = q.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D \
            or lens.shape[0] != B:
        raise ValueError(f"{fn}: k {tuple(k.shape)} / v {tuple(v.shape)} / "
                         f"lens {tuple(lens.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[2] <= 0:
        raise ValueError(f"{fn}: empty cache")
    checks.heads(fn, H, k.shape[1], D)
    checks.contiguous(fn, q=q, lens=lens)
    if k.stride() != v.stride():
        raise ValueError(f"{fn}: k and v must share strides")
    checks.rows_readable(fn, q=q, k=k, v=v)


@functools.lru_cache(maxsize=None)
def _plan(B: int, KH: int, S: int, dtype: torch.dtype, D: int,
          device: torch.device) -> Tuple[int, int]:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_plan(B, KH, S, tile_tokens(dtype, D), sms)


def plan_for(q, k) -> Tuple[int, int]:
    """The (n_splits, keys per split) that ``decode_attention`` launches
    for these CUDA tensors (cached per shape, dtype and card)."""
    return _plan(q.shape[0], k.shape[1], k.shape[2], q.dtype, q.shape[2],
                 q.device)


def decode_attention(q, k, v, lens, *, n_splits: int = 8):
    """Split-K decode attention; see the module doc. q [B, H, D]; k/v
    [B, KH, S, D], any strides with the last dim contiguous (a transposed
    view of the model layout [B, S, KH, D] is read in place); lens [B]
    int32. Returns [B, H, D] in q's dtype. ``n_splits``: the Pallas
    kernel's split count, followed by the plain version; the card's
    kernel uses ``plan_for``."""
    if counting.ACTIVE is not None:
        counting.ACTIVE.kernel("decode_attention",
                               counting.decode_cost(q, k, lens))
    if not checks.on_cuda("decode_attention", q):
        if q.device.type == "meta":
            return torch.empty_like(q)
        with counting.paused():
            return decode_attention_plain(q, k, v, lens, n_splits=n_splits)
    _check_cuda(q, k, v, lens)
    return _launch(q, k, v, lens, plan_for(q, k))


def _launch(q, k, v, lens, plan: Tuple[int, int], partials: bool = False):
    """Run the kernel with ``plan`` = (n_splits, keys per split), checked
    CUDA tensors (the plan of ``plan_for``, or another for measuring it).
    ``partials``: no merge; returns every split's f32 partial, acc
    [B, KH, ns, G, D], m and l [B, KH, ns, G] (m in natural log units),
    which ``paged_attention.lse_merge_partials`` merges as the kernel's
    last blocks do."""
    B, H, D = q.shape
    KH, S = k.shape[1], k.shape[2]
    G = H // KH
    ns, split_len = plan
    f32 = dict(dtype=torch.float32, device=q.device)
    if partials:
        res = (torch.empty(B, KH, ns, G, D, **f32),
               torch.empty(B, KH, ns, G, **f32),
               torch.empty(B, KH, ns, G, **f32))
    else:
        res = torch.empty_like(q)
    if B == 0:
        return res
    if partials:
        ptrs = tuple(t.data_ptr() for t in res) + (None, None)
    elif ns > 1:
        # one scratch buffer: acc [B, KH, ns, G, D], then m and l
        # [B, KH, ns, G]; the (lane, head) arrival counters
        rows = B * H * ns
        scratch = torch.empty(rows * (D + 2), **f32)
        base = scratch.data_ptr()
        ptrs = (base, base + rows * D * 4, base + rows * (D + 1) * 4,
                arrival_counters(q.device, B * KH).data_ptr(),
                res.data_ptr())
    else:
        ptrs = (None, None, None, None, res.data_ptr())
    lib = _lib()
    err = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), *ptrs,
        B, H, KH, D, S, ns, split_len, k.stride(0), k.stride(1),
        k.stride(2), checks.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attention launch")
    decode_attention.launches += 1
    return res


decode_attention.launches = 0


def occupancy(dtype: torch.dtype, G: int, D: int) -> Tuple[int, int, int, int]:
    """(resident blocks per SM, registers per thread, shared bytes, tile
    tokens) of the split kernel instantiated for (dtype, G, D) on the
    current card."""
    lib = _lib()
    blocks, regs, smem, tile = (ctypes.c_int(), ctypes.c_int(),
                                ctypes.c_int(), ctypes.c_int())
    err = lib.repro_decode_occupancy(
        checks.DTYPE_CODE[dtype], G, D, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(tile))
    build.check(lib, err, "decode_attention occupancy")
    return blocks.value, regs.value, smem.value, tile.value
