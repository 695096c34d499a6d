"""Three-term roofline from the port's dry-run records (counterpart of
the JAX package's ``analysis/roofline.py``), for one NVIDIA H100:

    compute    = dot FLOPs a device / peak FLOP/s
    memory     = dot bytes a device / HBM rate
    collective = per-kind collective bytes on the wire / link rate

Every quantity of a record is per device (``launch/dryrun.py`` says how
it got there), so nothing is divided by the device count here. The
hardware figures are the H100 SXM data sheet's, imported from
``core/cost_model.py``: 989e12 FLOP/s bf16 dense, 3.35e12 B/s HBM3,
450e9 B/s each way on NVLink 4; not the reference's TPU v5e figures.
The record's counts are in the model's own dtype (meta tensors are not
upcast, as XLA:CPU's bf16 is), so no byte correction applies.

Collective time model, as the reference's (ring algorithms over an axis
of n devices): an all-reduce moves 2 (n - 1) / n of its bytes through
each link; an all-gather (n - 1) / n of its gathered size; a
reduce-scatter (n - 1) / n of its full size, n times its scattered
output; an all-to-all (n - 1) / n; a collective-permute its bytes. The
sum is divided by one link's rate (a single-direction ring).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..core.cost_model import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16

PEAK_FLOPS = PEAK_FLOPS_BF16       # bf16 dense, FLOP/s a card
LINK_BW = ICI_BW_PER_LINK          # NVLink 4, B/s each way


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_wire_bytes: float
    model_flops: float = 0.0
    useful_ratio: float = 0.0          # model FLOPs / (dot FLOPs x devices)
    collectives: Dict[str, float] = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / step_time_s: 1.0 is compute-bound at peak."""
        t = self.step_time_s
        return (self.compute_s / t) if t > 0 else 0.0


def _wire_bytes(kind: str, nbytes: float, axis_n: int = 16) -> float:
    """Bytes through a device's link for one collective of HLO-shape size
    ``nbytes`` over an axis of ``axis_n`` devices (ring algorithm)."""
    f = (axis_n - 1) / axis_n
    if kind == "all-reduce":
        return 2.0 * f * nbytes
    if kind == "all-gather":
        return f * nbytes                    # the gathered size
    if kind == "reduce-scatter":
        return f * nbytes * axis_n           # the scattered size
    if kind == "all-to-all":
        return f * nbytes
    return nbytes


def roofline_from_record(rec: Dict[str, Any],
                         model_flops: Optional[float] = None,
                         axis_n: int = 16) -> RooflineTerms:
    """rec: one dry-run record of the port (results/dryrun_torch/*.json)."""
    counts = rec["count"]
    flops = counts["dot_flops"]
    nbytes = counts["dot_bytes"]
    wire = {k: _wire_bytes(k, v, axis_n)
            for k, v in counts.get("collective_bytes", {}).items()}
    wire_total = sum(wire.values())
    t = RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=nbytes / HBM_BW,
        collective_s=wire_total / LINK_BW,
        flops=flops,
        bytes_accessed=nbytes,
        collective_wire_bytes=wire_total,
        collectives=wire,
    )
    if model_flops:
        t.model_flops = model_flops
        total = flops * rec["devices"]
        t.useful_ratio = model_flops / total if total else 0.0
    return t


def model_flops_for(cfg, shape, n_active_params: int) -> float:
    """Analytic model FLOPs of a cell (the "useful work" yardstick):

    train:   6 * N_active * tokens  (forward 2ND + backward 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch   (one token a sequence)

    The attention term (about 12 L d S^2 / 2 for causal training) is left
    out, as in the reference: small at the assigned shapes except for
    long-context attention."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * (shape.seq_len if not cfg.encoder_decoder
                      else cfg.max_target_len + S)
        return 6.0 * n_active_params * tokens
    if shape.kind == "prefill":
        tokens = B * S + (B * 16 if cfg.encoder_decoder else 0)
        return 2.0 * n_active_params * tokens
    return 2.0 * n_active_params * B
