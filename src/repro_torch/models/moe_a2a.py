"""Expert parallelism by half-experts (counterpart of the JAX package's
``models/moe_a2a.py``, its shard_map "a2a EP" path).

Layout: each of the tp model-axis columns owns ONE half-expert — expert
e = h // s split column-wise into s = tp / n_experts shards of
f_half = d_ff / s columns (s = 2 for 8 experts on a 16-way axis, s = 1
for 16). Weights are stored pre-reshaped [tp, d, f_half] (and
[tp, f_half, d]) and sharded (model, None, data): chip (r, c) of a
("data", "model") mesh holds column block r of half-expert c.

Per chip, everything is local except two collectives per layer, which
are explicit calls of ``launch/mesh.py`` here (GSPMD's in the
reference):
  1. the all-gather of the chip's half-expert columns over "data" (of
     size 1 on a serve submesh);
  2. the sum of the combined output over "model", in shard order in
     float32 (``mesh.all_reduce``): each column contributes the tokens
     routed to its half-expert, and the halves of one expert sum their
     column-partial outputs through it.
The batch splits over "data". Capacity is per chip: cap =
max(int(capacity_factor * T * K / E), K) slots for the chip's T local
tokens, overflow dropped in token order.

The parameters come whole (one tree, as ``forward_full`` holds them);
``moe_halfexpert`` cuts each chip's piece onto its device.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..bridge import Spec
from ..launch import mesh as M


def applicable(cfg, tp: int) -> bool:
    return (cfg.n_experts > 0 and tp % cfg.n_experts == 0
            and cfg.d_ff % (tp // cfg.n_experts) == 0)


def moe_halfexpert_specs(cfg, tp: int) -> Dict[str, Spec]:
    """Pre-reshaped weights: [tp, d, f_half] / [tp, f_half, d]."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    fh = f // (tp // E)
    return {
        "router": Spec((d, E), "fan_in", ("embed", None), "float32"),
        "wg": Spec((tp, d, fh), "fan_in",
                   ("halfexpert", None, "expert_ff_fsdp")),
        "wu": Spec((tp, d, fh), "fan_in",
                   ("halfexpert", None, "expert_ff_fsdp")),
        "wd": Spec((tp, fh, d), "fan_in",
                   ("halfexpert", "expert_ff_fsdp", None)),
    }


def local_moe(p, cfg, x, my_half: int, tp: int) -> torch.Tensor:
    """One chip's share (the reference's shard_map body): x [B_local, S,
    d]; p["wg"/"wu"] [d, fh], p["wd"] [fh, d] the chip's half-expert
    my_half, already gathered over "data"; router [d, E]. Returns the
    chip's combined output [B_local, S, d], before the "model" sum."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    my_expert = my_half // (tp // E)
    logits = x.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(gates, K, dim=-1)                     # [B, S, K]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    T = B * S
    hit = tope == my_expert
    w_tok = torch.where(hit, topw, 0.0).sum(-1).reshape(T)        # combine gate
    mine = hit.any(-1).reshape(T)
    cap = max(int(cfg.capacity_factor * T * K / E), K)
    pos = torch.cumsum(mine.long(), 0) - mine.long()
    keep = mine & (pos < cap)
    slot = torch.where(keep, pos, torch.full_like(pos, cap))      # cap: spill
    xt = x.reshape(T, d)
    disp = torch.zeros((cap + 1, d), dtype=x.dtype, device=x.device)
    disp.index_add_(0, slot, torch.where(keep[:, None], xt,
                                         torch.zeros_like(xt)))
    g = F.silu((disp @ p["wg"]).float())
    u = (disp @ p["wu"]).float()
    eo = (g * u).to(x.dtype) @ p["wd"]
    out = eo[slot] * (w_tok * keep).to(x.dtype)[:, None]
    return out.reshape(B, S, d)


def moe_halfexpert(p, cfg, x, mesh) -> torch.Tensor:
    """x [B, S, d] (B divisible by the data-parallel size) through the
    half-expert MoE on ``mesh`` (a ``launch/mesh.py`` Mesh, "data" x
    "model", or "pod" x "data" x "model"); p: router [d, E], wg/wu
    [tp, d, fh], wd [tp, fh, d] with tp the "model" size. The "pod" axis
    is pure data parallelism, as in the reference: the batch splits over
    pod x data rows, each weight gather stays inside its pod's "data"
    column (one ``mesh.all_gather`` a (pod, column) and weight, every
    member of the column taking its copy) and each output sum inside its
    row's "model" axis. Returns [B, S, d] on the mesh's first device."""
    shape = mesh.shape
    if set(shape) - {"pod", "data", "model"}:
        raise ValueError(f"no half-expert MoE on a {tuple(shape)} mesh")
    pods, dp, tp = shape.get("pod", 1), shape["data"], shape["model"]
    n_rows = pods * dp
    B = x.shape[0]
    if B % n_rows:
        raise ValueError(f"batch {B} does not split over {n_rows} "
                         "data-parallel rows")
    bl, fl = B // n_rows, p["wg"].shape[2] // dp
    # chip (pod, r, c) holds columns r of half-expert c: gather them
    weights = {}
    for pod in range(pods):
        for c in range(tp):
            devs = [mesh.devices[(pod * dp + r) * tp + c] for r in range(dp)]
            col = M.make_mesh(1, dp, devs)
            gathered = {n: M.all_gather(
                [p[n][c].narrow(ax, r * fl, fl).to(dev)
                 for r, dev in enumerate(devs)], ax, col)
                for n, ax in (("wg", 1), ("wu", 1), ("wd", 0))}
            for r, dev in enumerate(devs):
                w = {n: g[r] for n, g in gathered.items()}
                w["router"] = p["router"].to(dev)
                weights[pod * dp + r, c] = w
    rows = []
    for row in range(n_rows):
        outs = [local_moe(weights[row, c], cfg,
                          x[row * bl:(row + 1) * bl].to(
                              mesh.devices[row * tp + c]), c, tp)
                for c in range(tp)]
        rows.append(M.all_reduce(outs, M.make_mesh(
            1, tp, mesh.devices[row * tp:(row + 1) * tp]))[0])
    dev0 = mesh.devices[0]
    return torch.cat([o.to(dev0) for o in rows], dim=0)


def reshape_standard_to_halfexpert(wg, wu, wd, tp: int):
    """[E, d, f] -> [tp, d, f / s] (each expert's columns split in s =
    tp / E), [E, f, d] -> [tp, f / s, d]."""
    E, d, f = wg.shape
    s = tp // E
    fh = f // s

    def split_g(w):   # [E, d, f] -> [E, d, s, fh] -> [tp, d, fh]
        return (w.reshape(E, d, s, fh).permute(0, 2, 1, 3)
                .reshape(tp, d, fh))

    def split_d(w):   # [E, f, d] -> [tp, fh, d]
        return w.reshape(E, s, fh, d).reshape(tp, fh, d)

    return split_g(wg), split_g(wu), split_d(wd)
