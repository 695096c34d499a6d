"""The work of a step, counted as it runs: dot FLOPs and dot bytes, the
hand-written kernels' work by formula, and the collectives of
``launch/mesh.py`` (the port's counterpart of the reference's
``compiled.cost_analysis()`` and ``analysis/hlo_stats.py``).

``hlo_stats`` parses the text of XLA's optimized HLO module. PyTorch runs
eagerly and has no such program text, so nothing here emulates it.
Instead a ``Counter`` (a ``TorchDispatchMode``) sees every aten op of a
step as it runs, on any device:

  dot FLOPs    the matmul family (mm, addmm, bmm, baddbmm), by the
               formulas of ``torch.utils.flop_counter`` (2 M N K a
               product);
  dot bytes    the inputs and the output of each such product in their
               dtypes (``hlo_stats``'s ``dot_bytes``, its proxy for HBM
               traffic);
  kernels      each wrapper under ``kernels/`` calls ``Counter.kernel``
               with its kernel's own work: 4 D FLOPs a visible (query,
               key) pair (the QK and PV products it replaces) and the
               bytes of its inputs read once and its outputs written once
               over the valid KV (the formulas below, which are the
               bounds of ``PERF.md`` §6). They add to the dot totals and
               are kept by name;
  collectives  ``mesh.all_reduce`` and ``mesh.all_gather`` report each
               call: the reference's per-device HLO bytes (an
               all-reduce's operand, an all-gather's gathered result)
               times the shards that took part, and one op a shard.

The count does not depend on the device. The same aten ops run on meta,
CPU and CUDA tensors; a kernel wrapper counts its formula on every
device and hides the ops of its plain version on the CPU (``paused``);
on meta tensors it returns an empty output of the kernel's shape. A
kernel's work may depend on values (the valid lengths ``lens``): meta
tensors have none, so there every lane counts as full, which is exact
where the caller's lanes are full (the dry-run decodes at a cache's last
slot). The routed MoE counts its expert products by the T x K identity
on meta (``models/layers.py``).

While no counter is active ``ACTIVE`` is None, and a wrapper's only
added cost is that one check.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..core.cost_model import HBM_BW, PEAK_FLOPS_BF16

aten = torch.ops.aten
DOT_OPS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)

ACTIVE: Optional["Counter"] = None


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """``with Counter() as c: step()`` counts the step's work into
    ``dot_flops``, ``dot_bytes`` (products and kernels together),
    ``kernels`` (name -> calls, flops, bytes), ``collective_bytes`` and
    ``collective_counts`` (kind -> bytes and ops summed over the shards
    that took part). Counters do not nest."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.dot_bytes = 0
        self.dots = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.collective_bytes: Dict[str, int] = {}
        self.collective_counts: Dict[str, int] = {}
        self._paused = 0

    def __enter__(self):
        global ACTIVE
        if ACTIVE is not None:
            raise RuntimeError("a Counter is already active")
        ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused and func.overloadpacket in DOT_OPS:
            self.add_dots(
                flop_registry[func.overloadpacket](*args, **kwargs,
                                                   out_val=out),
                sum(nbytes(a) for a in args if isinstance(a, torch.Tensor))
                + nbytes(out))
        return out

    def add_dots(self, flops: int, bytes_: int, n: int = 1) -> None:
        self.dot_flops += int(flops)
        self.dot_bytes += int(bytes_)
        self.dots += n

    def kernel(self, name: str, cost: Tuple[int, int]) -> None:
        """One call of the kernel ``name`` doing ``cost`` = (flops,
        bytes)."""
        flops, bytes_ = cost
        self.dot_flops += flops
        self.dot_bytes += bytes_
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += bytes_

    def collective(self, kind: str, nbytes_: int, members: int) -> None:
        """One collective of ``kind`` over ``members`` shards, each
        holding ``nbytes_`` of it in the reference's HLO terms."""
        self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0)
                                       + nbytes_ * members)
        self.collective_counts[kind] = (self.collective_counts.get(kind, 0)
                                        + members)


@contextlib.contextmanager
def paused():
    """The active counter (if any) skips the ops run inside: a kernel
    wrapper's plain version, whose kernel is counted by its formula."""
    c = ACTIVE
    if c is None:
        yield
        return
    c._paused += 1
    try:
        yield
    finally:
        c._paused -= 1


# ---------------------------------------------------------------------------
# the kernels' work: (flops, bytes) of one call
# ---------------------------------------------------------------------------

def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash masks let through, per (lane, head):
    query qp sees keys [max(0, qp - window + 1), min(qp + 1, Skv)) when
    causal (all Skv keys otherwise, then cut by the window)."""
    n = 0
    for qp in range(Sq):
        hi = min(qp + 1, Skv) if causal else Skv
        lo = max(0, qp - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def valid_tokens(lens: torch.Tensor, cap: int) -> Tuple[int, list]:
    """(sum, per lane) of the lanes' valid lengths, each clamped to
    [0, cap]; on meta tensors every lane counts as ``cap``."""
    if lens.device.type == "meta":
        per = [cap] * lens.shape[0]
    else:
        per = torch.clamp(lens, 0, cap).tolist()
    return sum(per), per


def decode_cost(q, k, lens) -> Tuple[int, int]:
    """Split-K decode: q [B, H, D]; k [B, KH, S, D]; lens [B]. The valid
    K and V rows, q read and the output written, the lens."""
    B, H, D = q.shape
    KH, S = k.shape[1], k.shape[2]
    ntok, _ = valid_tokens(lens, S)
    isz = q.element_size()
    return (4 * ntok * H * D,
            ntok * KH * D * 2 * isz + 2 * B * H * D * isz + B * 4)


def paged_cost(q, k_pages, page_table, lens) -> Tuple[int, int]:
    """Paged decode: the valid K and V rows, the table entries of the
    pages they lie on, q read and the output written, the lens."""
    B, H, D = q.shape
    PS, KH = k_pages.shape[1], k_pages.shape[2]
    ntok, per = valid_tokens(lens, page_table.shape[1] * PS)
    isz = q.element_size()
    pages = sum(-(-n // PS) for n in per)
    return (4 * ntok * H * D,
            ntok * KH * D * 2 * isz + 2 * B * H * D * isz + B * 4
            + pages * 4)


def partials_cost(q, k_pages, page_table, lens) -> Tuple[int, int]:
    """The paged kernel's unmerged partials: as ``paged_cost``, with the
    output one f32 partial (acc, m, l) a query row, whatever the card's
    split count."""
    B, H, D = q.shape
    flops, bytes_ = paged_cost(q, k_pages, page_table, lens)
    return flops, bytes_ - B * H * D * q.element_size() + B * H * (D + 2) * 4


def merge_cost(acc, out_dtype, slots: Optional[int] = None
               ) -> Tuple[int, int]:
    """The standalone merge: the f32 partials read (acc [B, KH, n, G, D],
    m and l [B, KH, n, G]), the merged rows written; no product. ``slots``
    (default n) is the n charged: partials that come from
    ``paged_decode_partials`` are charged one slot a call, as
    ``partials_cost`` charges them, since the card's split count is its
    own (the CPU's and meta's plain version takes one split)."""
    B, KH, n, G, D = acc.shape
    n = n if slots is None else slots
    return 0, (B * KH * n * G * (D + 2)) * 4 \
        + B * KH * G * D * out_dtype.itemsize


def prefix_cost(q, kp, ks=None, lens=None) -> Tuple[int, int]:
    """Shared-prefix decode: q [B, H, D] against the prefix kp/vp
    [KH, Sp, D] (read once for the batch) and, with ``ks`` [B, KH, Ss, D],
    each lane's valid suffix; q read, the output written (without a
    suffix: the f32 partial acc, m, l of each query row), the lens."""
    B, H, D = q.shape
    KH, Sp = kp.shape[0], kp.shape[1]
    isz = q.element_size()
    pre = 2 * KH * Sp * D * isz + B * H * D * isz
    if ks is None:
        return 4 * H * D * B * Sp, pre + B * H * (D + 2) * 4
    ntok, _ = valid_tokens(lens, ks.shape[2])
    return (4 * H * D * (B * Sp + ntok),
            pre + ntok * KH * D * 2 * isz + B * H * D * isz + B * 4)


def flash_cost(q, k, causal: bool, window: int, kv_len: int
               ) -> Tuple[int, int]:
    """Flash attention: q [B, H, Sq, D] over k/v [B, KH, Skv, D], keys
    past ``kv_len`` masked: 4 D a visible pair; q and the K, V rows
    below kv_len read, the output written."""
    B, H, Sq, D = q.shape
    KH = k.shape[1]
    isz = q.element_size()
    pairs = visible_pairs(Sq, kv_len, causal, window)
    return (4 * D * H * B * pairs,
            2 * B * H * Sq * D * isz + 2 * B * KH * kv_len * D * isz)


def routed_cost(T: int, K: int, d: int, f: int, experts_hit: int,
                x_dtype: torch.dtype, w_dtype: torch.dtype
                ) -> Tuple[int, int]:
    """The routed MoE's expert products by the T x K identity: whatever
    the routing, the products of all experts together see the T x K
    (token, k) pairs, three products [n, d] x [d, f], [n, d] x [d, f] and
    [n, f] x [f, d] an expert hit; each expert hit reads its three
    weights once."""
    n = T * K
    xs, ws = x_dtype.itemsize, w_dtype.itemsize
    act = n * (d * xs + f * xs) * 2 + n * (f * xs + d * xs)
    return 3 * 2 * n * d * f, act + experts_hit * 3 * d * f * ws


def bound_ms(bytes_: float, flops: float, hbm_bytes_per_s: float = HBM_BW,
             peak_flops: float = PEAK_FLOPS_BF16) -> Tuple[float, str]:
    """The least time for ``bytes_`` and ``flops``: the larger of bytes
    over the memory rate and flops over the peak rate (by default the
    H100's, ``core/cost_model.py``), in ms, and which one bounds it
    ("bytes" or "operations")."""
    b_ms = bytes_ / hbm_bytes_per_s * 1e3
    f_ms = flops / peak_flops * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def shard_bytes(shape, dtype_itemsize: int, pspec, mesh_shape) -> int:
    """Bytes of one device's shard of a [shape] leaf laid out by ``pspec``
    (one entry per leading dim: a mesh axis, a tuple of axes or None) on
    a mesh of ``mesh_shape`` (axis -> size): each split dim divided by
    its axes' sizes (the policies split only dims that divide)."""
    n = math.prod(shape) * dtype_itemsize
    for entry in pspec:
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            n //= mesh_shape[a]
    return n
