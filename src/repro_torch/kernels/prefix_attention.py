"""Shared-prefix (Hydragen) decode attention: the hand-written Hopper
kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/prefix_attention.py::
prefix_partial`` (all B*G query rows of a KV head against the one shared
prefix copy, so the prefix is read once per KV head and not once per
request) and the jnp suffix partial and ``lse_merge`` that
``prefix_attention`` adds to it. The CUDA source is
``csrc/prefix_attention.cu``; its header says what bounds the kernel on an
H100 (memory: the prefix once, the valid suffix rows, and the f32 partials
of the prefix splits) and what its design does about that (bf16: the
batch folded into the 128 rows of a block of two warpgroups, 64-key K/V
tiles by TMA, products on wgmma; f32 on the CUDA cores; the prefix split
into key ranges across blocks; the suffix on the split-KV body of
``csrc/split_kv.cuh``; one merge kernel).

``split_plan`` chooses the prefix splits on the host from shapes and the
SM count; the suffix takes ``decode_attention.split_plan``. Neither reads
``lens``. The two halves run side by side: the prefix half on a second,
high-priority stream of the card, the suffix on the caller's stream,
joined before the merge.

``prefix_partial`` and ``prefix_attention`` take the plain version only
for tensors that lie on the CPU. For CUDA tensors they launch the kernel
or raise; they never fall back. For meta tensors they return empty
outputs. While an ``analysis.counting.Counter`` is active, each call
counts the kernels' work by its formula (``counting.prefix_cost``) on
every device. ``prefix_partial.launches`` counts the
calls of either that launched the prefix kernel, never plain-version
calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..analysis import counting
from . import build, checks
from . import decode_attention as _dec
from .decode_attention import NEG_INF, lse_merge
from .paged_attention import tile_tokens

TILE_K = 64                          # the kernel's key tile
_LIB = "prefix_attention"


ROWS = 128                           # folded rows (b, g) a block takes


def split_plan(Sp: int, KH: int, rows: int, block_k: int,
               sms: int) -> Tuple[int, int]:
    """(prefix splits, keys per split) for ``rows`` = B * G folded rows a
    KV head: splits of whole 64-key tiles, at least ``block_k`` keys each;
    enough blocks (splits x KH x row tiles) to put one on each of ``sms``
    SMs, unless the f32 partials the splits write and the merge reads
    back (2 x splits x rows x 4 bytes a KV head and column) would exceed
    the prefix's own bf16 bytes (4 x Sp): at B 32 that cap, not the SM
    count, sets the plan (the split sweep of PERF.md §6). Host-known
    values only."""
    tiles = -(-Sp // TILE_K)
    most = max(1, tiles // max(1, -(-block_k // TILE_K)))
    wave = -(-sms // max(1, KH * -(-rows // ROWS)))
    cap = max(1, Sp // (2 * max(1, rows)))
    n = max(1, min(wave, cap, most))
    per = -(-tiles // n)
    if -(-tiles // per) < n:            # rounding lost splits: take the
        alt = max(1, tiles // n)        # shorter split if the cap allows
        if -(-tiles // alt) <= cap:
            per = alt
    return -(-tiles // per), per * TILE_K


def prefix_partial_plain(q, kp, vp):
    """Phase 1 in plain PyTorch, f32: q [B, H, D] against the shared
    prefix kp/vp [KH, Sp, D]. Returns the unnormalised (acc [B, KH, G, D],
    m [B, KH, G, 1], l [B, KH, G, 1])."""
    B, H, D = q.shape
    KH = kp.shape[0]
    G = H // KH
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,hkd->bhgk", qg, kp.float()) * (D ** -0.5)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgk,hkd->bhgd", p, vp.float())
    return acc, m, l


def _suffix_partial_plain(q, ks, vs, lens):
    """Phase 2: one partial over each request's suffix ks/vs
    [B, KH, Ss, D] (first ``lens`` rows valid), f32."""
    B, H, D = q.shape
    KH, Ss = ks.shape[1], ks.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, ks.float()) * (D ** -0.5)
    mask = torch.arange(Ss, device=q.device)[None, :] \
        < lens.to(q.device)[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgk,bhkd->bhgd", p, vs.float())
    return acc, m, l


def prefix_attention_plain(q, kp, vp, ks, vs, lens):
    """The kernels' function in plain PyTorch: attention of q [B, H, D]
    over [shared prefix ++ its own suffix], as phase 1 + phase 2 + merge.
    Returns [B, H, D] in q's dtype."""
    B, H, D = q.shape
    parts = zip(prefix_partial_plain(q, kp, vp),
                _suffix_partial_plain(q, ks, vs, lens))
    acc, m, l = (torch.stack(pair, dim=2) for pair in parts)
    return lse_merge(acc, m, l, axis=2).reshape(B, H, D).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.repro_prefix_attention
    if fn.argtypes is None:             # first load: declare the C types
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 \
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.repro_prefix_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
        occ.restype = ctypes.c_int
    return lib


def _check_cuda(q, kp, vp, suffix=None) -> None:
    """Raise on anything the kernels do not take."""
    fn = "prefix_attention"
    checks.same_device_and_dtype(fn, q, kp=kp, vp=vp)
    if q.dim() != 3 or kp.dim() != 3:
        raise ValueError(f"{fn}: expected q [B,H,D], kp/vp [KH,Sp,D]")
    B, H, D = q.shape
    if vp.shape != kp.shape or kp.shape[2] != D or kp.shape[1] <= 0:
        raise ValueError(f"{fn}: prefix {tuple(kp.shape)} / "
                         f"{tuple(vp.shape)} does not match q "
                         f"{tuple(q.shape)}")
    checks.heads(fn, H, kp.shape[0], D)
    checks.contiguous(fn, q=q)
    if kp.stride() != vp.stride():
        raise ValueError(f"{fn}: kp and vp must share strides")
    checks.rows_readable(fn, q=q, kp=kp, vp=vp)
    if suffix is not None:
        ks, vs, lens = suffix
        checks.same_device_and_dtype(fn, q, int32=("lens",), ks=ks, vs=vs,
                                     lens=lens)
        if ks.dim() != 4 or vs.shape != ks.shape or lens.shape != (B,) \
                or ks.shape[0] != B or ks.shape[1] != kp.shape[0] \
                or ks.shape[3] != D or ks.shape[2] <= 0:
            raise ValueError(f"{fn}: suffix {tuple(ks.shape)} / "
                             f"{tuple(vs.shape)} / lens "
                             f"{tuple(lens.shape)} does not match q "
                             f"{tuple(q.shape)} and the prefix")
        checks.contiguous(fn, lens=lens)
        if ks.stride() != vs.stride():
            raise ValueError(f"{fn}: ks and vs must share strides")
        checks.rows_readable(fn, ks=ks, vs=vs)


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, KH: int, Sp: int, Ss: int, D: int,
          dtype: torch.dtype, block_k: int, device: torch.device):
    """((prefix splits, keys a split), (suffix splits, keys a split))."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    pre = split_plan(Sp, KH, B * (H // KH), block_k, sms)
    sfx = _dec.split_plan(B, KH, Ss, tile_tokens(dtype, D), sms) \
        if Ss else (0, 0)
    return pre, sfx


def plan_for(q, kp, ks=None, block_k: int = 128):
    """The ((prefix splits, keys a split), (suffix splits, keys a split))
    that ``prefix_attention`` (or, without ``ks``, ``prefix_partial``)
    launches for these CUDA tensors (cached per shape, dtype and card)."""
    B, H, D = q.shape
    return _plan(B, H, kp.shape[0], kp.shape[1],
                 0 if ks is None else ks.shape[2], D, q.dtype, block_k,
                 q.device)


def _launch(q, kp, vp, suffix, plan):
    """Run the kernels on checked CUDA tensors with ``plan`` = ((prefix
    splits, keys a split), (suffix splits, keys a split)), the plan of
    ``plan_for`` or another for measuring it: with ``suffix`` (ks, vs,
    lens) the normalised [B, H, D]; without, the prefix's combined
    (acc, m, l)."""
    B, H, D = q.shape
    KH, Sp = kp.shape[0], kp.shape[1]
    G = H // KH
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    if suffix is not None:
        ks, vs, lens = suffix
        res = (torch.empty_like(q),)
        sfx = (ks.data_ptr(), vs.data_ptr(), lens.data_ptr())
        outs = (res[0].data_ptr(), None, None, None)
    else:
        res = (torch.empty(B, KH, G, D, **f32),
               torch.empty(B, KH, G, 1, **f32),
               torch.empty(B, KH, G, 1, **f32))
        sfx = (None, None, None)
        outs = (None,) + tuple(t.data_ptr() for t in res)
    if B == 0:
        return res
    (n_pre, chunk), (n_sfx, sfx_len) = plan
    if suffix is not None:
        sfx_shape = (ks.shape[2], n_sfx, sfx_len, ks.stride(0), ks.stride(1),
                     ks.stride(2))
    else:
        n_sfx, sfx_shape = 0, (0, 0, 0, 0, 0, 0)
    n_slots = n_pre + n_sfx
    if n_slots > 1:
        # one scratch buffer: acc [B, KH, n_slots, G, D], then m and l
        # [B, KH, n_slots, G]
        rows = B * H * n_slots
        scratch = torch.empty(rows * (D + 2), **f32)
        base = scratch.data_ptr()
        ptrs = (base, base + rows * D * 4, base + rows * (D + 1) * 4)
    else:                  # prefix_partial with one split: no scratch
        ptrs = (None, None, None)
    lib = _lib()
    err = lib.repro_prefix_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *sfx, *ptrs, *outs,
        B, H, KH, D, Sp, n_pre, chunk, kp.stride(0), kp.stride(1),
        *sfx_shape, checks.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "prefix_attention launch")
    prefix_partial.launches += 1
    return res


def prefix_partial(q, kp, vp, *, block_k: int = 128):
    """Phase 1: q [B, H, D] against the shared prefix kp/vp [KH, Sp, D]
    (any strides, last dim contiguous). Returns the unnormalised
    (acc [B, KH, G, D], m [B, KH, G, 1], l [B, KH, G, 1]) in f32.
    ``block_k``: the least number of prefix keys one block takes."""
    if block_k < 1:
        raise ValueError(f"prefix_partial: block_k {block_k} < 1")
    if counting.ACTIVE is not None:
        counting.ACTIVE.kernel("prefix_partial", counting.prefix_cost(q, kp))
    if not checks.on_cuda("prefix_partial", q):
        if q.device.type == "meta":
            B, H, D = q.shape
            G = H // kp.shape[0]
            return tuple(torch.empty(B, kp.shape[0], G, n,
                                     dtype=torch.float32, device="meta")
                         for n in (D, 1, 1))
        with counting.paused():
            return prefix_partial_plain(q, kp, vp)
    _check_cuda(q, kp, vp)
    return _launch(q, kp, vp, None, plan_for(q, kp, None, block_k))


def prefix_attention(q, kp, vp, ks, vs, lens, *, block_k: int = 128):
    """Full shared-prefix decode attention: q [B, H, D]; kp/vp [KH, Sp, D]
    the shared prefix KV (one copy for the whole batch); ks/vs
    [B, KH, Ss, D] per-request suffixes (any strides, last dim
    contiguous); lens [B] int32 valid suffix lengths. Equals attention
    over [prefix ++ suffix]. Returns [B, H, D] in q's dtype."""
    if block_k < 1:
        raise ValueError(f"prefix_attention: block_k {block_k} < 1")
    if counting.ACTIVE is not None:
        counting.ACTIVE.kernel("prefix_attention",
                               counting.prefix_cost(q, kp, ks, lens))
    if not checks.on_cuda("prefix_attention", q):
        if q.device.type == "meta":
            return torch.empty_like(q)
        with counting.paused():
            return prefix_attention_plain(q, kp, vp, ks, vs, lens)
    _check_cuda(q, kp, vp, (ks, vs, lens))
    return _launch(q, kp, vp, (ks, vs, lens),
                   plan_for(q, kp, ks, block_k))[0]


prefix_partial.launches = 0


def occupancy(dtype: torch.dtype, D: int, rows: int
              ) -> Tuple[int, int, int, int]:
    """(resident blocks per SM, registers per thread, shared bytes,
    threads a block) of the prefix kernel that a call with ``rows`` = B*G
    folded rows launches for (dtype, D) on the current card: wgmma for
    bf16, the CUDA-core kernel with 4 (up to 64 rows) or 8 rows a thread
    for f32."""
    lib = _lib()
    blocks, regs, smem, threads = (ctypes.c_int(), ctypes.c_int(),
                                   ctypes.c_int(), ctypes.c_int())
    err = lib.repro_prefix_occupancy(
        checks.DTYPE_CODE[dtype], D, rows, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(threads))
    build.check(lib, err, "prefix_attention occupancy")
    return blocks.value, regs.value, smem.value, threads.value
