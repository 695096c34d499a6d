"""Host/device batch split for the paged data plane (counterpart of the
JAX package's ``serving/batch.py``).

  * ModelWorkerBatch — the numpy subset the model forward consumes,
    already padded/bucketed to its (Lc, C, Ld) shape. Host-only.
  * ForwardBatch — the same arrays on the model's device, produced by
    ``lower`` in ONE host-to-device copy: the int32 arrays are packed
    into one (pinned, on a CUDA target) host buffer, copied once, and
    the fields are views into the device copy.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["ModelWorkerBatch", "ForwardBatch", "bucket", "lower_arrays"]


@dataclass
class ModelWorkerBatch:
    """Host-side (numpy int32) model inputs for one fused iteration.
    Pure-decode steps leave the chunk half at Lc=0."""
    # prefill-chunk half: [Lc, C] tokens, per-lane start/len, [Lc, P]
    # page-table rows (padding lanes carry all-scratch rows)
    chunk_tokens: np.ndarray
    chunk_start: np.ndarray
    chunk_len: np.ndarray
    chunk_page_table: np.ndarray
    # decode half: [Ld] fed tokens / context positions, [Ld, P] rows
    dec_tokens: np.ndarray
    dec_pos: np.ndarray
    dec_page_table: np.ndarray

    def arrays(self) -> Tuple[np.ndarray, ...]:
        return tuple(getattr(self, f.name) for f in fields(self))


@dataclass
class ForwardBatch:
    """Device-side twin of ``ModelWorkerBatch``: same fields, int32
    tensors that are views into one device buffer."""
    chunk_tokens: torch.Tensor
    chunk_start: torch.Tensor
    chunk_len: torch.Tensor
    chunk_page_table: torch.Tensor
    dec_tokens: torch.Tensor
    dec_pos: torch.Tensor
    dec_page_table: torch.Tensor

    @classmethod
    def lower(cls, wb: ModelWorkerBatch, device) -> "ForwardBatch":
        """ONE host-to-device copy for the whole worker batch."""
        return cls(*lower_arrays(wb.arrays(), device))


def bucket(n: int) -> int:
    """Next power of two >= n: model batches are padded to bucket sizes
    (the reference's retrace bound; kept so padding matches it)."""
    return 1 << max(n - 1, 0).bit_length()


def lower_arrays(arrays, device, out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """int32 host arrays -> int32 tensors on ``device`` in ONE
    host-to-device copy: the arrays are packed into one (pinned, on a
    CUDA target) host buffer, copied once, and returned as views into
    the device copy. ``out``: a flat int32 device buffer of exactly the
    packed size that the copy lands in (a CUDA graph's static inputs)."""
    device = torch.device(device)
    arrs = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    sizes = [a.size for a in arrs]
    host = torch.empty(sum(sizes), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    np.concatenate([a.reshape(-1) for a in arrs], out=host.numpy())
    if out is None:
        dev = host.to(device, non_blocking=True)
    else:
        if out.shape != host.shape or out.dtype != torch.int32:
            raise ValueError(f"lower_arrays: out {tuple(out.shape)} "
                             f"{out.dtype}, packed {tuple(host.shape)} int32")
        dev = out.copy_(host, non_blocking=True)
    views, ofs = [], 0
    for a, n in zip(arrs, sizes):
        views.append(dev[ofs:ofs + n].view(a.shape))
        ofs += n
    return tuple(views)
