"""Shared-prefix (Hydragen) decode attention: the hand-written Hopper
kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/prefix_attention.py::
prefix_partial`` (all B*G query rows of a KV head against the one shared
prefix copy, so the prefix is read once per KV head and not once per
request) and the jnp suffix partial and ``lse_merge`` that
``prefix_attention`` adds to it. The CUDA source is
``csrc/prefix_attention.cu``; its header says what bounds the kernel on an
H100 (memory: the prefix once, the valid suffix rows) and what its design
does about that (the batch folded into one block's rows, the prefix split
into chunks across blocks, the suffix as a one-split decode partial, one
merge kernel).

``prefix_partial`` and ``prefix_attention`` take the plain version only
for tensors that lie on the CPU. For CUDA tensors they launch the kernel
or raise; they never fall back. ``prefix_partial.launches`` counts the
calls of either that launched the prefix kernel, never plain-version
calls.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build, checks
from .decode_attention import NEG_INF, lse_merge

TILE_K = 64                          # the kernel's key tile
_LIB = "prefix_attention"


def split_layout(Sp: int, KH: int, block_k: int, sms: int) -> Tuple[int, int]:
    """(prefix splits, keys per split). A split is at least ``block_k``
    keys, and long enough that the KH * splits blocks make about one
    wave on ``sms`` SMs; rounded up to the 64-key tile."""
    want = max(block_k, -(-Sp * KH // sms))
    chunk = -(-want // TILE_K) * TILE_K
    return -(-Sp // chunk), chunk


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
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] \
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.repro_prefix_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
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


def _launch(q, kp, vp, suffix, block_k):
    """Run the kernels: with ``suffix`` (ks, vs, lens) the normalised
    [B, H, D]; without, the prefix's combined (acc, m, l)."""
    B, H, D = q.shape
    KH, Sp = kp.shape[0], kp.shape[1]
    G = H // KH
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    if suffix is not None:
        ks, vs, lens = suffix
        res = (torch.empty_like(q),)
        sfx = (ks.data_ptr(), vs.data_ptr(), lens.data_ptr())
        sfx_shape = (ks.shape[2], ks.stride(0), ks.stride(1), ks.stride(2))
        outs = (res[0].data_ptr(), None, None, None)
    else:
        res = (torch.empty(B, KH, G, D, **f32),
               torch.empty(B, KH, G, 1, **f32),
               torch.empty(B, KH, G, 1, **f32))
        sfx = (None, None, None)
        sfx_shape = (0, 0, 0, 0)
        outs = (None,) + tuple(t.data_ptr() for t in res)
    if B == 0:
        return res
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, chunk = split_layout(Sp, KH, block_k, sms)
    n_slots = n_split + (suffix is not None)
    acc = torch.empty(B, KH, n_slots, G, D, **f32)
    m = torch.empty(B, KH, n_slots, G, **f32)
    l = torch.empty_like(m)
    lib = _lib()
    err = lib.repro_prefix_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *sfx, acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), *outs, B, H, KH, D, Sp, n_split, chunk,
        kp.stride(0), kp.stride(1), *sfx_shape,
        checks.DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
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
    if not checks.on_cuda("prefix_partial", q):
        return prefix_partial_plain(q, kp, vp)
    _check_cuda(q, kp, vp)
    return _launch(q, kp, vp, None, block_k)


def prefix_attention(q, kp, vp, ks, vs, lens, *, block_k: int = 128):
    """Full shared-prefix decode attention: q [B, H, D]; kp/vp [KH, Sp, D]
    the shared prefix KV (one copy for the whole batch); ks/vs
    [B, KH, Ss, D] per-request suffixes (any strides, last dim
    contiguous); lens [B] int32 valid suffix lengths. Equals attention
    over [prefix ++ suffix]. Returns [B, H, D] in q's dtype."""
    if block_k < 1:
        raise ValueError(f"prefix_attention: block_k {block_k} < 1")
    if not checks.on_cuda("prefix_attention", q):
        return prefix_attention_plain(q, kp, vp, ks, vs, lens)
    _check_cuda(q, kp, vp, (ks, vs, lens))
    return _launch(q, kp, vp, (ks, vs, lens), block_k)[0]


prefix_partial.launches = 0


def occupancy(dtype: torch.dtype, D: int, rows_per_thread: int
              ) -> Tuple[int, int, int]:
    """(resident blocks per SM, registers per thread, shared bytes) of
    the prefix kernel for (dtype, D) with 4 (up to 64 folded rows) or 8
    (up to 128) rows per thread, on the current card."""
    lib = _lib()
    blocks, regs, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.repro_prefix_occupancy(
        checks.DTYPE_CODE[dtype], D, rows_per_thread, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(smem))
    build.check(lib, err, "prefix_attention occupancy")
    return blocks.value, regs.value, smem.value
