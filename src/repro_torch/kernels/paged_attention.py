"""Paged decode attention: the hand-written Hopper kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_decode_attention`` (grid (B, KH, P) of per-page softmax partials
merged by ``lse_merge``). The CUDA source is ``csrc/paged_attention.cu``;
its header says what bounds the kernel on an H100 (memory: the KV bytes
the lanes need, sum_b len_b * KH * D * 2 * itemsize) and what its design
does about that (split-KV grid (n_splits, KH, B) of whole-page splits,
pages staged through shared memory by a cp.async ring, the G query rows
sharing every K/V row read, per-warp softmax state merged once a split).
The splits' f32 partials are merged inside the same launch by the last
split block of each (lane, KV head) to finish: a merge costs latency and
a launch, not bytes, so it rides on the split kernel. Its arrival
counters live in a workspace per (card, stream) that every launch leaves
at 0 (``arrival_counters``).

``split_plan`` chooses the splits on the host from host-known values
only (B, KH, the table width, the SM count), never from ``lens``, which
live on the card: reading them would cost a host sync on every layer.

``paged_decode_attention`` takes the plain version only for tensors that
lie on the CPU. For CUDA tensors it launches the kernel or raises; it
never falls back. For meta tensors it, and the two calls below, return
empty outputs. While an ``analysis.counting.Counter`` is active, each
call of the three counts its kernel's work by its formula
(``counting.paged_cost``, ``partials_cost``, ``merge_cost``) on every
device.
``paged_decode_attention.launches`` counts calls that went through the
kernel, one launch each whatever the split count. Plain-version calls
never count. ``paged_decode_partials`` (the kernel's partials, unmerged)
and ``lse_merge_partials`` (the standalone merge, one warp a row) serve
the slot shards of a tensor-parallel pool.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..analysis import counting
from . import build
from .checks import DTYPE_CODE as _DTYPE_CODE
from .checks import GROUPS, HEAD_DIMS  # the built (G, D)

_LIB = "paged_attention"
BLOCKS_PER_SM = 3        # the split plan's aim: about 3 blocks on each SM
_COUNTERS = {}           # (card, stream) -> int32 arrival counters, at 0


def tile_tokens(dtype: torch.dtype, D: int) -> int:
    """Tokens in one pipeline tile of the kernel for (dtype, D): 4 warps
    x 4 steps x the tokens a warp takes at once (32 lanes over D / (16 B)
    lanes a row). A tile's K and V are 16 KB whatever the dtype and D."""
    return 16 * 32 * (16 // dtype.itemsize) // D


def split_plan(B: int, KH: int, P: int, PS: int, tile: int,
               sms: int) -> Tuple[int, int]:
    """(n_splits, pages per split) for a batch of B lanes of P table
    entries of PS tokens: every split a whole number of pages covering at
    least one tile of ``tile`` tokens (or all P pages when the row is
    shorter), and n_splits * B * KH about BLOCKS_PER_SM blocks on each of
    ``sms`` SMs. Host-known values only: no lane length is read."""
    min_pages = max(1, -(-tile // PS))
    most = max(1, P // min_pages)
    want = -(-sms * BLOCKS_PER_SM // max(1, B * KH))
    n = max(1, min(want, most))
    pps = -(-P // n)
    return -(-P // pps), pps


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lens):
    """The kernel's function in plain PyTorch, f32 throughout.

    q: [B, H, D]; k/v_pages: [n_pages, PS, KH, D]; page_table: [B, P]
    page ids (entries past a lane's length may point anywhere, they are
    masked); lens: [B] valid token counts. Returns [B, H, D] in q's
    dtype. A lane with len 0 returns 0, as the Pallas kernel does."""
    B, H, D = q.shape
    _, PS, KH, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // KH
    idx = page_table.long()
    k = k_pages[idx].reshape(B, P * PS, KH, D).float()
    v = v_pages[idx].reshape(B, P * PS, KH, D).float()
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * (D ** -0.5)
    mask = (torch.arange(P * PS, device=q.device)[None, :]
            < lens.to(q.device)[:, None])                     # [B, S]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(-1)[:, None, None, None], w, 0.0)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v)
    return o.reshape(B, H, D).to(q.dtype)


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters, all 0, for a split kernel
    launched on the current stream of ``device``: one per (lane, KV head),
    which the last split block to arrive sets back to 0. So the workspace
    is zeroed only when it is made or grown, never per call; and there is
    one per stream, so that launches on two streams never share one."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    ws = _COUNTERS.get(key)
    if ws is None or ws.numel() < n:
        # made on the stream that uses it: a grown workspace frees the old
        # one only after that stream's queued launches. 1024 covers every
        # served B * KH (32 lanes x 8 KV heads at most)
        ws = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = ws
    return ws


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.repro_paged_decode_attention
    if fn.argtypes is None:             # first load: declare the C types
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        part = lib.repro_paged_decode_partials
        part.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        part.restype = ctypes.c_int
        merge = lib.repro_lse_merge
        merge.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        merge.restype = ctypes.c_int
        occ = lib.repro_paged_decode_occupancy
        occ.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
        occ.restype = ctypes.c_int
    return lib


def _check_cuda(q, k_pages, v_pages, page_table, lens) -> None:
    """Raise on anything the kernel does not take."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, "
                             f"q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention: dtype {q.dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q, k_pages and v_pages "
                        "must share one dtype")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table and lens must "
                        "be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or page_table.dim() != 2 \
            or lens.dim() != 1:
        raise ValueError("paged_decode_attention: expected q [B,H,D], pages "
                         "[n_pages,PS,KH,D], page_table [B,P], lens [B]")
    B, H, D = q.shape
    _, _, KH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"paged_decode_attention: pages {tuple(k_pages.shape)}"
                         f"/{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.shape[0] != B or lens.shape[0] != B:
        raise ValueError("paged_decode_attention: page_table/lens batch "
                         "differs from q")
    if H % KH or H // KH not in GROUPS or D not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: G = {H}/{KH}, D = {D} not "
                         f"built (G in {GROUPS}, D in {HEAD_DIMS})")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} not contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} not 16-byte "
                             "aligned")


@functools.lru_cache(maxsize=None)
def _plan(B: int, KH: int, P: int, PS: int, dtype: torch.dtype, D: int,
          device: torch.device) -> Tuple[int, int]:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_plan(B, KH, P, PS, tile_tokens(dtype, D), sms)


def plan_for(q, k_pages, page_table) -> Tuple[int, int]:
    """The (n_splits, pages per split) that ``paged_decode_attention``
    launches for these CUDA tensors (cached per shape, dtype and card:
    every layer of an engine step asks for the same plan)."""
    _, PS, KH, D = k_pages.shape
    return _plan(q.shape[0], KH, page_table.shape[1], PS, q.dtype, D,
                 q.device)


def paged_decode_attention(q, k_pages, v_pages, page_table, lens):
    """Decode attention over the shared page pool; see the module doc.
    Same arguments and result as ``paged_decode_attention_plain``."""
    if counting.ACTIVE is not None:
        counting.ACTIVE.kernel("paged_decode_attention",
                               counting.paged_cost(q, k_pages, page_table,
                                                   lens))
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        with counting.paused():
            return paged_decode_attention_plain(q, k_pages, v_pages,
                                                page_table, lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for "
                         f"{q.device.type} tensors")
    _check_cuda(q, k_pages, v_pages, page_table, lens)
    B, H, D = q.shape
    n_pages, PS, KH, _ = k_pages.shape
    P = page_table.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_splits, pps = plan_for(q, k_pages, page_table)
    G = H // KH
    if n_splits > 1:
        # one scratch buffer: acc [B, KH, n_splits, G, D], then m and l
        # [B, KH, n_splits, G]; the (lane, head) arrival counters
        rows = B * KH * n_splits * G
        scratch = torch.empty(rows * (D + 2), dtype=torch.float32,
                              device=q.device)
        base = scratch.data_ptr()
        ptrs = (base, base + rows * D * 4, base + rows * (D + 1) * 4,
                arrival_counters(q.device, B * KH).data_ptr())
    else:
        ptrs = (None, None, None, None)
    lib = _lib()
    err = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(), *ptrs,
        B, H, KH, D, P, PS, n_pages, n_splits, pps, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "paged_decode_attention launch")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_partials_plain(q, k_pages, v_pages, page_table, lens,
                                n_splits: int = 1, pps: int = 0):
    """Every split's softmax partial in plain PyTorch, f32: split si
    covers pages [si * pps, (si + 1) * pps) of each lane's table (pps 0:
    one split of all P pages). Returns acc [B, KH, ns, G, D], m and l
    [B, KH, ns, G]: m the split's largest score (natural log units, -inf
    for a split with no valid token), l = sum exp(s - m), acc = sum
    exp(s - m) v (both 0 for an empty split)."""
    B, H, D = q.shape
    _, PS, KH, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // KH
    pps = pps or P
    L = pps * PS
    T = n_splits * L
    idx = page_table.long()
    k = k_pages[idx].reshape(B, P * PS, KH, D).float()
    v = v_pages[idx].reshape(B, P * PS, KH, D).float()
    if T > P * PS:
        pad = (0, 0, 0, 0, 0, T - P * PS)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    k, v = k[:, :T], v[:, :T]
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * (D ** -0.5)
    s = s.reshape(B, KH, G, n_splits, L).transpose(2, 3)     # [B,KH,ns,G,L]
    mask = (torch.arange(T, device=q.device)[None, :]
            < lens.to(q.device)[:, None]).reshape(B, 1, n_splits, 1, L)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1)
    m_safe = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    vs = v.reshape(B, n_splits, L, KH, D).permute(0, 3, 1, 2, 4)
    acc = torch.einsum("bhngl,bhnld->bhngd", p, vs)
    return acc, m, p.sum(-1)


def paged_decode_partials(q, k_pages, v_pages, page_table, lens):
    """The split kernel's f32 partials, with its merge skipped: acc
    [B, KH, ns, G, D], m and l [B, KH, ns, G], for the kernel's own split
    plan (``plan_for``); on CPU tensors the plain version with one split.
    Same arguments as ``paged_decode_attention``."""
    if counting.ACTIVE is not None:
        counting.ACTIVE.kernel("paged_decode_partials",
                               counting.partials_cost(q, k_pages, page_table,
                                                      lens))
    if q.device.type == "meta":
        B, H, D = q.shape
        KH = k_pages.shape[2]
        return tuple(torch.empty((B, KH, 1, H // KH) + tail,
                                 dtype=torch.float32, device="meta")
                     for tail in ((D,), (), ()))
    if q.device.type == "cpu":
        with counting.paused():
            return paged_decode_partials_plain(q, k_pages, v_pages,
                                               page_table, lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_partials: no kernel for "
                         f"{q.device.type} tensors")
    _check_cuda(q, k_pages, v_pages, page_table, lens)
    B, H, D = q.shape
    n_pages, PS, KH, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // KH
    n_splits, pps = plan_for(q, k_pages, page_table)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, KH, n_splits, G, D), **f32)
    m = torch.empty((B, KH, n_splits, G), **f32)
    l = torch.empty((B, KH, n_splits, G), **f32)
    if B == 0:
        return acc, m, l
    lib = _lib()
    err = lib.repro_paged_decode_partials(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), B, H, KH, D, P, PS, n_pages, n_splits,
        pps, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "paged_decode_partials launch")
    paged_decode_partials.launches += 1
    return acc, m, l


paged_decode_partials.launches = 0


def lse_merge_partials_plain(acc, m, l, dtype):
    """The torch ``lse_merge`` over the slot axis: acc [B, KH, n, G, D],
    m and l [B, KH, n, G] -> [B, KH * G, D] in ``dtype``."""
    from .decode_attention import lse_merge
    B, KH, _, G, D = acc.shape
    o = lse_merge(acc, m[..., None], l[..., None])
    return o.reshape(B, KH * G, D).to(dtype)


def lse_merge_partials(acc, m, l, dtype, slots=None):
    """Merge the f32 partials of every slot (splits of one or more shards,
    concatenated along axis 2): acc [B, KH, n, G, D], m and l
    [B, KH, n, G] -> [B, KH * G, D] in ``dtype``, in one launch of
    ``lse_merge_kernel`` (one warp a row) on a card; the plain version on
    CPU tensors. ``slots`` only sets the n a counter charges
    (``counting.merge_cost``)."""
    if counting.ACTIVE is not None:
        counting.ACTIVE.kernel("lse_merge_partials",
                               counting.merge_cost(acc, dtype, slots))
    if acc.device.type == "meta":
        B, KH, _, G, D = acc.shape
        return torch.empty((B, KH * G, D), dtype=dtype, device="meta")
    if acc.device.type == "cpu":
        with counting.paused():
            return lse_merge_partials_plain(acc, m, l, dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"lse_merge_partials: no kernel for "
                         f"{acc.device.type} tensors")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"lse_merge_partials: dtype {dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    for name, t in (("acc", acc), ("m", m), ("l", l)):
        if t.device != acc.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"lse_merge_partials: {name} must be a "
                             "contiguous float32 tensor on acc's device")
    B, KH, n, G, D = acc.shape
    if m.shape != acc.shape[:4] or l.shape != acc.shape[:4]:
        raise ValueError("lse_merge_partials: m/l do not match acc")
    if D not in HEAD_DIMS or acc.data_ptr() % 16:
        raise ValueError(f"lse_merge_partials: D {D} not built (D in "
                         f"{HEAD_DIMS}) or acc not 16-byte aligned")
    out = torch.empty((B, KH * G, D), dtype=dtype, device=acc.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.repro_lse_merge(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
        B * KH * G, G, n, D, _DTYPE_CODE[dtype],
        torch.cuda.current_stream(acc.device).cuda_stream)
    build.check(lib, err, "lse_merge_partials launch")
    lse_merge_partials.launches += 1
    return out


lse_merge_partials.launches = 0


def occupancy(dtype: torch.dtype, G: int, D: int,
              pps: int = 1) -> Tuple[int, int, int, int]:
    """(resident blocks per SM, registers per thread, shared bytes, tile
    tokens) of the kernel instantiated for (dtype, G, D) with ``pps``
    pages a split, on the current card."""
    lib = _lib()
    blocks, regs, smem, tile = (ctypes.c_int(), ctypes.c_int(),
                                ctypes.c_int(), ctypes.c_int())
    err = lib.repro_paged_decode_occupancy(
        _DTYPE_CODE[dtype], G, D, pps, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(tile))
    build.check(lib, err, "paged_decode_attention occupancy")
    return blocks.value, regs.value, smem.value, tile.value
