"""Split-K decode attention (flash-decoding): the hand-written Hopper
kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py::
decode_attention`` (grid (B, KH, n_splits) of per-chunk softmax partials
merged by the jnp ``lse_merge``). The CUDA source is
``csrc/decode_attention.cu``; its header says what bounds the kernel on an
H100 (memory: the valid KV bytes) and what its design does about that
(one block per (split, KV head, lane), the G query rows of a head sharing
each K row read, partials in an f32 scratch buffer, a second small kernel
for the merge).

``decode_attention`` takes the plain version only for tensors that lie on
the CPU. For CUDA tensors it launches the kernel or raises; it never falls
back. ``decode_attention.launches`` counts calls that launched the kernel
(the partial kernel and its merge), never plain-version calls.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build, checks

NEG_INF = float("-inf")
_LIB = "decode_attention"


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


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.repro_decode_attention
    if fn.argtypes is None:             # first load: declare the C types
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.repro_decode_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
        occ.restype = ctypes.c_int
    return lib


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


def decode_attention(q, k, v, lens, *, n_splits: int = 8):
    """Split-K decode attention; see the module doc. q [B, H, D]; k/v
    [B, KH, S, D], any strides with the last dim contiguous (a transposed
    view of the model layout [B, S, KH, D] is read in place); lens [B]
    int32. Returns [B, H, D] in q's dtype."""
    if not checks.on_cuda("decode_attention", q):
        return decode_attention_plain(q, k, v, lens, n_splits=n_splits)
    _check_cuda(q, k, v, lens)
    B, H, D = q.shape
    KH, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    ns, block_k = split_layout(S, n_splits)
    acc = torch.empty(B, KH, ns, H // KH, D, dtype=torch.float32,
                      device=q.device)
    m = torch.empty(B, KH, ns, H // KH, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _lib()
    err = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
        B, H, KH, D, S, ns, block_k, k.stride(0), k.stride(1), k.stride(2),
        checks.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attention launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def occupancy(dtype: torch.dtype, G: int, D: int) -> Tuple[int, int, int]:
    """(resident blocks per SM, registers per thread, shared bytes) of
    the partial kernel instantiated for (dtype, G, D) on the current
    card."""
    lib = _lib()
    blocks, regs, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.repro_decode_occupancy(
        checks.DTYPE_CODE[dtype], G, D, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(smem))
    build.check(lib, err, "decode_attention occupancy")
    return blocks.value, regs.value, smem.value
