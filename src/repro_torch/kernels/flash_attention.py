"""Causal GQA flash attention: the hand-written Hopper kernel and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (grid (B, H, nq, nk), online softmax over KV blocks,
causal and sliding-window block skipping). The CUDA source is
``csrc/flash_attention.cu``; its header says what bounds the kernel on an
H100 (operations: 4 * D flops per visible (query, key) pair) and what its
design does about that (bf16: one block of two warpgroups per query tile
and group of ``head_group(G)`` query heads of a KV head, their (head,
position) rows folded into 128, so each 64-key K/V tile is loaded once for
the group, by TMA into a ring paced by mbarriers, on the tensor cores with
wgmma; f32 on the CUDA cores; only the key tiles that hold a visible key,
longest query tiles first, strided reads of either layout).

``flash_attention`` takes the plain version only for tensors that lie on
the CPU. For CUDA tensors it launches the kernel or raises; it never
falls back. For meta tensors it returns an empty output. While an
``analysis.counting.Counter`` is active, each call counts the kernel's
work by its formula (``counting.flash_cost``) on every device.
``flash_attention.launches`` counts kernel launches, never plain-version
calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..analysis import counting
from . import build, checks

NEG_INF = float("-inf")
_LIB = "flash_attention"
_PLAIN_Q_BLOCK = 256     # query rows per step of the plain version


def _mask(q0: int, n: int, Skv: int, causal: bool, window: int,
          kv_len: int, device) -> torch.Tensor:
    """[n, Skv] visibility of keys to queries q0 .. q0 + n - 1."""
    q_pos = torch.arange(q0, q0 + n, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          kv_len: Optional[int] = None):
    """The kernel's function in plain PyTorch, f32: q [B, H, Sq, D];
    k/v [B, KH, Skv, D] -> [B, H, Sq, D] in q's dtype. A row with no
    visible key returns 0. Walks the queries in blocks, which bounds the
    f32 scores held at once and does not change the result."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    kv_len = Skv if kv_len is None else kv_len
    kf, vf = k.float(), v.float()
    out = torch.empty(B, H, Sq, D, dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, _PLAIN_Q_BLOCK):
        n = min(_PLAIN_Q_BLOCK, Sq - q0)
        qg = q[:, :, q0:q0 + n].reshape(B, KH, G, n, D).float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * (D ** -0.5)
        mask = _mask(q0, n, Skv, causal, window, kv_len, q.device)
        s = s.masked_fill(~mask, NEG_INF)
        w = torch.softmax(s, dim=-1)
        w = torch.where(mask.any(-1)[:, None], w, 0.0)
        o = torch.einsum("bhgqk,bhkd->bhgqd", w, vf)
        out[:, :, q0:q0 + n] = o.reshape(B, H, n, D).to(q.dtype)
    return out


def head_group(G: int) -> int:
    """Query heads that one bf16 block holds, all sharing its K/V tiles:
    the largest of 4, 3, 2, 1 that divides G (G itself for G <= 4, a
    group of 4 for G 8, so two blocks per KV head)."""
    return next(d for d in (4, 3, 2, 1) if G % d == 0)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give the library's entry points their C types (once)."""
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
            + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.repro_flash_occupancy
        occ.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
        occ.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return _declare(build.load(_LIB))


def _check_args(q, k, v, window, kv_len) -> int:
    """Raise on a shape or option no version takes; return kv_len."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: expected q [B,H,Sq,D], k/v "
                         f"[B,KH,Skv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    Skv = k.shape[2]
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"[0, {Skv}]")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    return kv_len


def _check_cuda(q, k, v, out) -> None:
    """Raise on anything the kernel does not take."""
    fn = "flash_attention"
    checks.same_device_and_dtype(fn, q, k=k, v=v, out=out)
    B, H, Sq, D = q.shape
    if out.shape != q.shape:
        raise ValueError(f"{fn}: out {tuple(out.shape)} is not q's shape "
                         f"{tuple(q.shape)}")
    KH = k.shape[1]
    if KH <= 0 or H % KH or D not in checks.HEAD_DIMS:
        raise ValueError(f"{fn}: H {H} / KH {KH}, D {D} not built (KH "
                         f"dividing H, D in {checks.HEAD_DIMS})")
    if k.stride() != v.stride():
        raise ValueError(f"{fn}: k and v must share strides")
    checks.rows_readable(fn, q=q, k=k, v=v, out=out)


def _run_into(out, q, k, v, causal: bool, window: int, kv_len) -> None:
    """Attention of q [B, H, Sq, D] over k/v [B, KH, Skv, D] written into
    out [B, H, Sq, D]: any of them may be a strided view with the last dim
    contiguous (``ops`` passes the model layout transposed)."""
    kv_len = _check_args(q, k, v, window, kv_len)
    if counting.ACTIVE is not None:
        counting.ACTIVE.kernel("flash_attention", counting.flash_cost(
            q, k, causal, window, kv_len))
    if not checks.on_cuda("flash_attention", q):
        if q.device.type == "meta":
            return
        with counting.paused():
            out.copy_(flash_attention_plain(q, k, v, causal=causal,
                                            window=window, kv_len=kv_len))
        return
    _check_cuda(q, k, v, out)
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if B == 0 or H == 0 or Sq == 0:
        return
    if Skv == 0:                         # no key at all: every row is 0
        out.zero_()
        return
    lib = _lib()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KH, D, Sq, Skv, kv_len, int(bool(causal)), int(window),
        head_group(H // KH), *q.stride()[:3], *k.stride()[:3],
        *out.stride()[:3],
        checks.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, block_q: int = 128,
                    block_k: int = 128):
    """q [B, H, Sq, D]; k/v [B, KH, Skv, D] (GQA, G = H // KH) ->
    [B, H, Sq, D] in q's dtype. Keys at or past ``kv_len`` are masked;
    ``causal`` and ``window`` mask as the Pallas kernel does, with
    positions from 0 on both sides. ``block_q`` and ``block_k`` are the
    Pallas kernel's tile sizes, kept for its signature: the CUDA kernel's
    tiles are fixed (64 keys; 64 queries for f32, 128 / head_group(G)
    positions of each head for bf16) and no result depends on them."""
    if block_q < 1 or block_k < 1:
        raise ValueError("flash_attention: block_q and block_k must be >= 1")
    B, H, Sq, D = q.shape
    out = torch.empty(B, H, Sq, D, dtype=q.dtype, device=q.device)
    _run_into(out, q, k, v, causal, window, kv_len)
    return out


flash_attention.launches = 0


def occupancy(dtype: torch.dtype, D: int) -> Tuple[int, int, int, int]:
    """(resident blocks per SM, registers per thread, shared bytes,
    threads per block) of the kernel instantiated for (dtype, D) on the
    current card."""
    lib = _lib()
    blocks, regs, smem, threads = (ctypes.c_int(), ctypes.c_int(),
                                   ctypes.c_int(), ctypes.c_int())
    err = lib.repro_flash_occupancy(
        checks.DTYPE_CODE[dtype], D, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(threads))
    build.check(lib, err, "flash_attention occupancy")
    return blocks.value, regs.value, smem.value, threads.value
