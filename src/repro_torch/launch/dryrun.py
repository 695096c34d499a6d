"""Dry-run of the port (counterpart of the JAX package's
``launch/dryrun.py``): for every (architecture x shape x mesh) cell,
build the step the reference builds (a train step, a prefill, or one
decode token against a seq_len cache) on the reference's production
meshes with its sharding policies, count its work, and record the
per-device memory, dot FLOPs and bytes and collective bytes that the
H100 roofline reads (``analysis/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--multi-pod] [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell for 512 placeholder XLA
devices and reads XLA's analyses. The port has no compiler: it runs the
step once on meta tensors (shapes and dtypes, no values, nothing
allocated) under an ``analysis.counting.Counter``. A record holds:

  memory.argument_bytes, output_bytes  per device, exact: every leaf's
      shard under the cell's PartitionSpecs (the reference's), summed.
  memory.temp_bytes, peak_bytes  null: meta tensors allocate nothing,
      and an eager step's temporaries are not XLA's (memory.note).
  count.dot_flops, dot_bytes  per device: the global step's count (every
      matrix product, and every hand-written kernel by its formula)
      divided by the devices. XLA counts each device's partitioned
      program, which includes the compute a layout replicates: where a
      dim does not divide its mesh axis (smollm's 15 heads, whisper's 6,
      on a 16-way model axis), attention is replicated over "model" in
      the reference and the port's figure is the lower one.
  count.collective_bytes, collective_counts  per device, under the
      reference's kinds; each entry of count.collectives names its
      source: "issued" for the collectives the port's code calls (the
      half-expert MoE's, through ``launch/mesh.py``), a rule of
      ``rule_collectives`` for those GSPMD would insert and the port does
      not run. Nothing here is compared with XLA's numbers: the repo
      holds none, and making them takes the 512-device compile.
  time_count_s  the wall of building and counting the cell (in place of
      the reference's lower and compile times).

The counts are in the model's dtype: meta tensors are not upcast, as
XLA:CPU upcasts bf16 in the reference's compile, so the record has no
``cpu_f32_correction``.

``run_cell`` also takes a ``mesh`` and a ``device``: on a 1 x 1 mesh and
``"cuda"`` it runs the same step on the card with random values from a
seed (``chip_smoke.py`` holds its count against the meta count). The CLI
keeps the reference's meshes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ..analysis import counting
from ..analysis.roofline import model_flops_for
from ..bridge import Spec
from ..configs import ASSIGNED, SHAPES, ShapeSpec, get_config, \
    shape_applicable
from ..models import common, moe_a2a, zoo
from ..models.transformer import layer_plan
from ..train.optimizer import AdamWConfig
from ..train.train_loop import (TrainConfig, TrainState, init_state,
                                make_train_step)
from .mesh import Mesh, axis_size, make_production_mesh
from .sharding import (_norm, batch_pspecs, cache_pspecs, dp_spec,
                       param_pspecs, q8_scale_pspec, serve_policy,
                       train_policy)

Pytree = Any


class SkipCell(Exception):
    pass


# ---------------------------------------------------------------------
# the inputs of a cell
# ---------------------------------------------------------------------

def input_specs(cfg, shape, device="meta") -> Dict[str, torch.Tensor]:
    """Empty stand-ins for every model input of this cell (the
    reference's ShapeDtypeStructs), on ``device``."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, getattr(torch, cfg.dtype)

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind == "train":
        if cfg.encoder_decoder:
            T = cfg.max_target_len
            return {"frames": sd((B, S, cfg.d_model), dt),
                    "tokens": sd((B, T), i32), "labels": sd((B, T), i32)}
        out = {"tokens": sd((B, S), i32), "labels": sd((B, S), i32)}
        if cfg.cross_attn_period:
            out["vision"] = sd((B, cfg.n_vision_tokens, cfg.d_model), dt)
        return out
    if shape.kind == "prefill":
        if cfg.encoder_decoder:
            return {"frames": sd((B, S, cfg.d_model), dt),
                    "tokens": sd((B, 16), i32)}
        out = {"tokens": sd((B, S), i32)}
        if cfg.cross_attn_period:
            out["vision"] = sd((B, cfg.n_vision_tokens, cfg.d_model), dt)
        return out
    # decode: one new token against a seq_len cache
    return {"tokens": sd((B,), i32), "pos": sd((), i32)}


def _fill(batch: Dict[str, torch.Tensor], cfg, gen: torch.Generator
          ) -> Dict[str, torch.Tensor]:
    """Values for the inputs on a real device: token ids below the vocab
    size, float inputs normal, the decode position 0 (unused: the step
    takes ``decode_position``)."""
    out = {}
    for k, t in batch.items():
        if k == "pos":
            out[k] = torch.zeros_like(t)
        elif t.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                   device=t.device, dtype=torch.int32)
        else:
            out[k] = torch.randn(t.shape, generator=gen, device=t.device
                                 ).to(t.dtype)
    return out


def decode_position(cfg, shape) -> int:
    """The position a decode cell's token takes: the self-attention
    cache's last slot (seq_len - 1; whisper's decoder cache holds
    max_target_len), so every lane attends a full cache."""
    return (cfg.max_target_len if cfg.encoder_decoder
            else shape.seq_len) - 1


def pick_grad_accum(cfg, shape, mesh, budget_bytes: float = 2 << 30) -> int:
    """Microbatches so that the widest per-device activation fits the
    budget (the reference's rule)."""
    dp = axis_size(mesh, tuple(a for a in ("pod", "data")
                               if a in mesh.shape))
    width = max(cfg.d_ff, 4 * cfg.d_model)
    for accum in (1, 2, 4, 8, 16, 32):
        if shape.global_batch % accum:
            continue
        tokens_per_chip = shape.global_batch // accum * shape.seq_len / dp
        tp = axis_size(mesh, "model")
        if tokens_per_chip * (width / tp) * 2 <= budget_bytes:
            return accum
    return 32


# ---------------------------------------------------------------------
# one cell: its step, its arguments and their PartitionSpecs
# ---------------------------------------------------------------------

@dataclass
class Cell:
    """A built cell. ``args`` / ``outs`` are the step's argument and
    output trees (tensors; TrainState for a train state), ``arg_pspecs``
    / ``out_pspecs`` their PartitionSpecs in the same structure;
    ``param_pspecs`` the parameters' under the cell's policy; ``layout``
    the mesh, the decode-MoE switch and the activation axes the
    reference pins in its ``models/common.py`` (batch, seq, head and
    expert, as tuples of axis names or None, with the seq and head
    sizes); ``step()`` runs the step once under that layout. ``cfg`` is the
    config the step runs (the half-expert layout where the cell takes
    it), ``base_cfg`` the config as named, whose sizes the record gives
    (as the reference's)."""
    arch: str
    shape: ShapeSpec
    multi_pod: bool
    mesh: Mesh
    cfg: Any
    base_cfg: Any
    api: Any
    args: Tuple
    arg_pspecs: Tuple
    outs: Tuple
    out_pspecs: Tuple
    param_pspecs: Pytree
    extra: Dict[str, Any]
    overrides: Dict[str, Any]
    layout: Dict[str, Any]
    device: torch.device
    run: Callable[[], Any]

    def step(self):
        with applied(self.layout):
            return self.run()


@contextlib.contextmanager
def applied(layout: Dict[str, Any]):
    """The ambient mesh and the decode-MoE switch of ``layout`` set
    through ``models/common.py`` inside, cleared after. The activation
    axes (batch, seq, head, expert) pin GSPMD's layout in the reference;
    the port has no GSPMD and runs a step's math whole, so they stay in
    ``layout``, where ``rule_collectives`` reads them."""
    common.set_mesh(layout["mesh"])
    common.set_ep_decode(layout["ep_decode"])
    try:
        yield
    finally:
        common.set_mesh(None)
        common.set_ep_decode(False)


def _empty(cache_specs: Pytree, device) -> Pytree:
    """A cache tree of zeros on ``device`` (empty on meta)."""
    if isinstance(cache_specs, dict):
        return {k: _empty(v, device) for k, v in cache_specs.items()}
    make = torch.empty if torch.device(device).type == "meta" else torch.zeros
    return make(cache_specs.shape, dtype=cache_specs.dtype, device=device)


def _zip_specs(specs: Pytree, pspecs: Pytree, fn) -> Pytree:
    if isinstance(specs, Spec):
        return fn(specs, pspecs)
    return {k: _zip_specs(specs[k], pspecs[k], fn) for k in specs}


def build_cell(arch, shape: Union[str, ShapeSpec],
               multi_pod: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               mesh: Optional[Mesh] = None, device="meta",
               seed: int = 0) -> Cell:
    """The cell's step with the reference's choices: the half-expert MoE
    for train and prefill where ``moe_a2a.applicable``, the "seq" prefill
    mode, int8 moments when 14 bytes a parameter over the data x model
    shards exceed 15e9, remat on, ``pick_grad_accum``; each overridable
    by ``overrides`` (``expert_mesh``, ``moe_impl``, ``prefill_mode``,
    ``grad_accum``, ``quant_moments``, ``remat``, ``attn_impl``,
    ``fsdp_bytes_per_chip``). ``mesh`` defaults to the production mesh;
    ``device`` holds the arguments (meta: shapes only; else random
    values from ``seed``). ``arch`` is a config name or a ModelConfig of
    its own, ``shape`` a name of SHAPES or a ShapeSpec of its own (a
    cut)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    ov = overrides or {}
    expert_mesh = ov.get("expert_mesh", False)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    expert_axis=expert_mesh)
    tp = axis_size(mesh, "model")
    base_cfg = cfg
    want_he = ov.get("moe_impl", "halfexpert"
                     if shape.kind in ("train", "prefill") else "standard")
    if want_he == "halfexpert" and moe_a2a.applicable(cfg, tp):
        cfg = dataclasses.replace(cfg, moe_impl="halfexpert", moe_tp=tp)
    api = zoo.build(cfg)

    recurrent = any(p.mixer in ("mamba", "rwkv") for p in layer_plan(cfg))
    batch_axes = dp_spec(mesh, shape.global_batch)
    layout = dict(mesh=mesh,
                  batch=((batch_axes,) if isinstance(batch_axes, str)
                         else batch_axes),
                  seq=None, seq_size=1, head=None, head_size=1,
                  expert=(("expert",) if expert_mesh and cfg.n_experts
                          and cfg.n_experts % 8 == 0 else None),
                  ep_decode=cfg.n_experts > 0 and cfg.n_experts % tp == 0)
    if shape.kind == "prefill" and not recurrent:
        mode = ov.get("prefill_mode", "seq")
        if mode == "head" and cfg.n_heads % tp == 0:
            layout.update(head=("model",), head_size=tp)
        elif mode == "seq" and shape.seq_len % tp == 0:
            layout.update(seq=("model",), seq_size=tp)

    device = torch.device(device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    specs = api.specs
    params = api.abstract() if meta else api.init(gen, device)
    batch = input_specs(cfg, shape, device)
    if not meta:
        batch = _fill(batch, cfg, gen)
    b_ps = batch_pspecs(batch, mesh)
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        p_ps = param_pspecs(specs, mesh, train_policy(mesh))
        accum = ov.get("grad_accum", pick_grad_accum(cfg, shape, mesh))
        # int8 AdamW moments when the float32 state would not fit: the
        # "pod" axis is pure data parallelism, so the state shards over
        # data x model whatever the pod count
        n_shards = axis_size(mesh, "data") * axis_size(mesh, "model")
        quant = ov.get("quant_moments", api.n_params * 14.0 / n_shards > 15e9)
        tc = TrainConfig(adamw=AdamWConfig(), grad_accum=accum,
                         quant_moments=quant, remat=ov.get("remat", True))
        step = make_train_step(api, tc)
        state = init_state(params, tc)
        mom = (_zip_specs(specs, p_ps, lambda s, ps: {
            "q": ps, "s": q8_scale_pspec(ps, len(s.shape))})
            if quant else p_ps)
        state_ps = TrainState(params=p_ps,
                              opt={"m": mom, "v": mom, "master": p_ps,
                                   "count": ()},
                              ef_error=None, step=())
        metrics = {k: torch.empty((), dtype=torch.float32, device="meta")
                   for k in ("loss", "grad_norm", "lr")}
        return Cell(arch, shape, multi_pod, mesh, cfg, base_cfg, api,
                    (state, batch), (state_ps, b_ps), (state, metrics),
                    (state_ps, {k: () for k in metrics}), p_ps,
                    {"grad_accum": accum, "quant_moments": quant}, ov,
                    layout, device, lambda: step(state, batch))

    p_ps = param_pspecs(specs, mesh, serve_policy(
        mesh, api.n_bytes,
        fsdp_bytes_per_chip=ov.get("fsdp_bytes_per_chip", 6 << 30)))
    cache_sp = api.cache_specs(B, S)
    c_ps = cache_pspecs(cache_sp, mesh)
    cache_out = _empty(cache_sp, "meta")
    if shape.kind == "prefill":
        impl = ov.get("attn_impl", "blockwise")
        nxt = torch.empty((B,), dtype=torch.int32, device="meta")
        return Cell(arch, shape, multi_pod, mesh, cfg, base_cfg, api,
                    (params, batch), (p_ps, b_ps), (nxt, cache_out),
                    ((None,), c_ps), p_ps, {}, ov, layout, device,
                    lambda: api.prefill(params, batch, attn_impl=impl))

    cache = _empty(cache_sp, device)
    tok_ps = (dp_spec(mesh, B),)
    tokens, pos = batch["tokens"], batch["pos"]
    position = decode_position(cfg, shape)
    return Cell(arch, shape, multi_pod, mesh, cfg, base_cfg, api,
                (params, cache, tokens, pos), (p_ps, c_ps, tok_ps, ()),
                (tokens, cache), (tok_ps, c_ps), p_ps, {}, ov, layout,
                device, lambda: api.decode(params, cache,
                                           {"tokens": tokens,
                                            "pos": position}))


# ---------------------------------------------------------------------
# bytes under PartitionSpecs
# ---------------------------------------------------------------------

def tree_shard_bytes(tree: Pytree, pspecs: Pytree, mesh: Mesh) -> int:
    """One device's bytes of ``tree`` laid out by ``pspecs`` (the same
    structure; TrainStates compare as their dicts)."""
    if isinstance(tree, TrainState):
        return tree_shard_bytes(tree.as_dict(), pspecs.as_dict(), mesh)
    if isinstance(tree, (tuple, list)):
        return sum(tree_shard_bytes(t, p, mesh) for t, p in zip(tree, pspecs))
    if isinstance(tree, dict):
        return sum(tree_shard_bytes(tree[k], pspecs[k], mesh) for k in tree)
    return counting.shard_bytes(tuple(tree.shape), tree.element_size(),
                                pspecs, mesh.shape)


# ---------------------------------------------------------------------
# the collectives the port does not run: an analytic rule
# ---------------------------------------------------------------------

NOT_MODELLED = ("the MoE dispatch over an expert axis (an all-to-all in "
                "the reference); reductions of the LM head over a split "
                "vocab (a few values a token)")


def _leaves(specs, pspecs, path=()):
    if isinstance(specs, Spec):
        yield path, specs, pspecs
        return
    for k in specs:
        yield from _leaves(specs[k], pspecs[k], path + (k,))


def rule_collectives(cell: Cell) -> List[Dict[str, Any]]:
    """The collectives GSPMD would insert for this cell and the port does
    not run, per device, from the cell's PartitionSpecs and
    ``cell.layout``. Each entry: kind (the reference's
    names), source (the rule), bytes (HLO bytes: an all-reduce's operand,
    an all-gather's gathered result, a reduce-scatter's scattered
    output) and count. A collective over an axis of size 1 is left out.

      fsdp weight gather  (all-gather) every parameter split over "data"
          or "pod", gathered whole over them before use, a layer at a
          time: once a serving step; a train step (2 with remat, else 1)
          x grad_accum times. The half-expert leaves are left out: their
          gathers are issued.
      gradient reduce     (train) every parameter's grad, in its dtype
          (float32 with grad_accum > 1), a layer at a time: a
          reduce-scatter over "data" when the parameter is split over
          it, else an all-reduce over "data"; then an all-reduce over
          "pod" of the shard.
      tensor-parallel all-reduce  every product whose output is the
          residual width (a leaf whose last axis is "embed" or
          "expert_in") and whose other dims are split over "model":
          the activation [tokens / batch shards, d] summed over "model",
          once a layer and step (the embedding's lookup once), 3 times
          in training (forward, remat's recompute, the backward's
          input grad). Not in a sequence-parallel prefill.
      sequence-parallel gathers  (prefill with the "seq" mode) every
          stack leaf split over "model" gathered whole once, and each
          attention layer's K and V [B / batch shards, S, KH, D] over
          the sequence's axes.
      split-KV merge      (decode) each attention layer whose cache puts
          the sequence over mesh axes all-reduces the f32 softmax
          partials [B / batch shards, H, D + 2] over them.

    Not modelled: see NOT_MODELLED."""
    mesh, cfg, shape = cell.mesh, cell.cfg, cell.shape
    ms = mesh.shape
    kind = shape.kind
    train = kind == "train"
    out: List[Dict[str, Any]] = []

    def add(k, source, nbytes, count, group):
        if group > 1 and count:
            out.append({"kind": k, "source": source, "bytes": int(nbytes),
                        "count": int(count)})

    batch, seq = cell.layout["batch"], cell.layout["seq"]
    shards = axis_size(mesh, batch) if batch else 1
    B, S = shape.global_batch, shape.seq_len
    accum = cell.extra.get("grad_accum", 1)
    remat = cell.overrides.get("remat", True)
    if cfg.encoder_decoder:
        T = cfg.max_target_len if train else 16
        dec = B if kind == "decode" else B * T
        tokens = {"embed": dec, "decoder": dec,
                  "encoder": 0 if kind == "decode" else B * S}
    else:
        n = B if kind == "decode" else B * S
        tokens = {"embed": n, "stack": n}
    act = getattr(torch, cfg.dtype).itemsize
    d = cfg.d_model
    for path, s, ps in _leaves(cell.api.specs, cell.param_pspecs):
        isz = getattr(torch, s.dtype or cfg.dtype).itemsize
        shard = counting.shard_bytes(s.shape, isz, ps, ms)
        used = {a for e in ps if e is not None for a in _norm(e)}
        layers = s.shape[0] if s.axes[0] == "layers" else 1
        data_in = tuple(a for a in ("pod", "data") if a in used)
        if data_in and "halfexpert" not in s.axes:
            g = axis_size(mesh, data_in)
            n = (2 if remat else 1) * accum if train else 1
            add("all-gather", "fsdp weight gather", shard * g * n,
                n * layers, g)
        if train:
            gb = shard if accum == 1 else shard // isz * 4
            if "data" in used:
                add("reduce-scatter", "gradient reduce", gb, layers,
                    ms["data"])
            elif "data" in ms:
                add("all-reduce", "gradient reduce", gb, layers, ms["data"])
            if "pod" in ms:
                add("all-reduce", "gradient reduce", gb, layers, ms["pod"])
        if "model" not in used or "halfexpert" in s.axes:
            continue
        if seq is not None and path[0] != "embed":
            add("all-gather", "sequence-parallel gathers",
                shard * ms["model"], layers, ms["model"])
            continue
        if s.axes[-1] in ("embed", "expert_in"):
            n = 1 if path[0] == "embed" else layers * (3 if train else 1)
            add("all-reduce", "tensor-parallel all-reduce",
                tokens[path[0]] // shards * d * act * n,
                n * (accum if train else 1), ms["model"])
    KH, D, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    if seq is not None:
        g = axis_size(mesh, seq)
        n_attn = (cfg.n_encoder_layers if cfg.encoder_decoder else
                  sum(p.mixer == "attn" for p in layer_plan(cfg))
                  * cfg.n_groups)
        add("all-gather", "sequence-parallel gathers",
            2 * (B // shards) * S * KH * D * act * n_attn, 2 * n_attn, g)
    if kind == "decode":
        for pj, leaves in cell.out_pspecs[1].items():
            for name in ("k", "ck"):
                sspec = leaves.get(name, (None,) * 3)[2]
                if sspec is None:
                    continue
                lanes = cell.outs[1][pj][name].shape
                add("all-reduce", "split-KV merge",
                    (B // shards) * H * (D + 2) * 4 * lanes[0], lanes[0],
                    axis_size(mesh, sspec))
    return out


# ---------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------

def count_cell(cell: Cell) -> counting.Counter:
    """Run the cell's step once under a Counter (on a card, up to its
    end)."""
    with counting.Counter() as c:
        cell.step()
        if cell.device.type == "cuda":
            torch.cuda.synchronize()
    return c


def record(cell: Cell, c: counting.Counter, seconds: float
           ) -> Dict[str, Any]:
    """The dry-run record of a counted cell (the module doc says what
    each field means)."""
    mesh, shape = cell.mesh, cell.shape
    api = zoo.build(cell.base_cfg)
    n_dev = mesh.size
    with applied(cell.layout):
        rule = rule_collectives(cell)
    issued = [{"kind": k, "source": "issued", "bytes": v / n_dev,
               "count": c.collective_counts[k] / n_dev}
              for k, v in sorted(c.collective_bytes.items())]
    colls = issued + rule
    by_kind: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    for e in colls:
        by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + e["bytes"]
        counts[e["kind"]] = counts.get(e["kind"], 0) + e["count"]
    return {
        "arch": cell.arch, "shape": shape.name,
        "mesh": "x".join(str(v) for v in mesh.shape.values()),
        "axes": list(mesh.shape),
        "multi_pod": cell.multi_pod, "kind": shape.kind,
        "devices": n_dev, "extra": cell.extra,
        "overrides": cell.overrides,
        "time_count_s": round(seconds, 1),
        "model": {
            "n_params": api.n_params,
            "n_active_params": api.n_active_params,
            "model_flops": model_flops_for(cell.base_cfg, shape,
                                           api.n_active_params),
        },
        "memory": {
            "argument_bytes": tree_shard_bytes(cell.args, cell.arg_pspecs,
                                               mesh),
            "output_bytes": tree_shard_bytes(cell.outs, cell.out_pspecs,
                                             mesh),
            "temp_bytes": None, "peak_bytes": None,
            "note": ("argument and output bytes are one device's shards "
                     "under the PartitionSpecs; temp and peak are not "
                     "known: meta tensors allocate nothing, and an eager "
                     "step's temporaries are not XLA's"),
        },
        "count": {
            "dot_flops": c.dot_flops / n_dev,
            "dot_bytes": c.dot_bytes / n_dev,
            "dot_flops_global": c.dot_flops,
            "dot_bytes_global": c.dot_bytes,
            "dots": c.dots,
            "kernels": c.kernels,
            "collective_bytes": by_kind,
            "collective_counts": counts,
            "collectives": colls,
            "not_modelled": NOT_MODELLED,
            "definition": (
                "per device = the global step's count / devices; dots "
                "are mm/addmm/bmm/baddbmm (2MNK FLOPs; inputs and output "
                "in their dtypes) plus each hand-written kernel by its "
                "formula (analysis/counting.py); counted on meta tensors "
                "in the model's dtype, no f32 correction; compute a "
                "layout replicates is not counted"),
        },
    }


def run_cell(arch, shape: Union[str, ShapeSpec],
             multi_pod: bool = False,
             overrides: Optional[Dict[str, Any]] = None,
             mesh: Optional[Mesh] = None, device="meta") -> Dict[str, Any]:
    """Build, count and record one cell (``build_cell``'s arguments)."""
    t0 = time.time()
    cell = build_cell(arch, shape, multi_pod, overrides, mesh, device)
    c = count_cell(cell)
    return record(cell, c, time.time() - t0)


def cell_list():
    cells = []
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            cells.append((arch, sname, ok, why))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of cell overrides")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    if args.list:
        for arch, sname, ok, why in cell_list():
            print(f"{arch:24s} {sname:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return 0

    os.makedirs(args.out, exist_ok=True)
    overrides = json.loads(args.overrides) if args.overrides else None
    if args.all:
        todo = [(a, s) for a, s, ok, _ in cell_list() if ok]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]

    failures = 0
    for arch, sname in todo:
        tag = f"{arch}__{sname}__{'pod2' if args.multi_pod else 'pod1'}"
        if args.tag:
            tag += f"__{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        try:
            res = run_cell(arch, sname, args.multi_pod, overrides)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            mem, cnt = res["memory"], res["count"]
            useful = res["model"]["model_flops"] / max(
                cnt["dot_flops"] * res["devices"], 1)
            print(f"OK  {tag}: count={res['time_count_s']}s "
                  f"args/dev={mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"out/dev={mem['output_bytes'] / 2**30:.2f}GiB "
                  f"dotF/dev={cnt['dot_flops']:.3g} "
                  f"dotB/dev={cnt['dot_bytes']:.3g} useful={useful:.2f}",
                  flush=True)
        except SkipCell as e:
            print(f"SKIP {tag}: {e}")
        except Exception as e:   # recorded; the other cells still run
            failures += 1
            print(f"FAIL {tag}: {type(e).__name__}: {e}")
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
