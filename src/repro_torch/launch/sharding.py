"""Divisibility-aware sharding policy: logical axes -> PartitionSpecs
(counterpart of the JAX package's ``launch/sharding.py``), and the
shard layout of a tensor-parallel serving instance.

Every parameter leaf carries logical axis names (``bridge.param_specs``);
a ``Policy`` maps them onto mesh axes through ordered preference lists.
An axis candidate is taken only if (a) every mesh axis in it exists,
(b) the dim divides the combined mesh-axis size, and (c) none of its
mesh axes is already used by another dim of the same tensor. Otherwise
the next preference is tried; an exhausted list replicates the dim.

A PartitionSpec is a plain tuple here: one entry per dim (a mesh axis
name, a tuple of names, or None), with the entries the reference's
functions give (``Policy.pspec`` drops trailing Nones, the pool and span
specs keep one entry per dim). The rules for "experts", "expert_ff",
"expert_in", "halfexpert" and "expert_ff_fsdp" are the reference's and
lay out the MoE leaves; "inner" lays out the Mamba leaves.

``train_policy``, ``dp_spec``, ``batch_pspecs``, ``cache_pspecs`` and
``q8_scale_pspec`` give the training state's, the batch's and the decode
cache's specs on any mesh of the reference's axes ("pod", "data",
"expert", "model"), as the reference's functions do; the dry-run
(``launch/dryrun.py``) and the sharded train step
(``train/sharded.py``) read them.

``shard_tree`` cuts every leaf of a tree into its shards' blocks by its
PartitionSpec, over every axis the spec names (a single axis, a tuple
of axes, several split dims a leaf), one fresh tensor a shard on its
shard's device: shard s's block is the one JAX's ``NamedSharding`` gives
the device at mesh position s (``mesh.block_slices``). ``unshard_tree``
puts the blocks back together. A ``TreeSharding`` (a mesh and a tree of
PartitionSpecs) is the port's counterpart of a tree of NamedShardings:
what ``restore_checkpoint(..., shardings=)`` places a checkpoint by.

On a serve submesh ("data", "model") = (1, tp) only the "model" axis
splits anything: ``shard_params`` cuts every leaf along the dims whose
spec names "model" into tp contiguous pieces, one tensor per shard on
its shard's device; the whole tensor is not kept. ``ShardPlan`` records
what the model math needs to know of the layout: which of the heads,
kv heads, ff, vocab, experts and expert ff dims are split, and which arm
of ``pool_pspec`` the paged KV pool takes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..bridge import Spec
from . import mesh as M
from .mesh import Mesh, axis_size, data_axes

Pytree = Any
AxisPref = Union[str, Tuple[str, ...]]
PSpec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]


def _norm(pref: AxisPref) -> Tuple[str, ...]:
    return (pref,) if isinstance(pref, str) else tuple(pref)


@dataclass(frozen=True)
class Policy:
    rules: Dict[str, Tuple[AxisPref, ...]]

    def pspec(self, spec: Spec, mesh: Mesh) -> PSpec:
        used: set = set()
        out: List[Optional[Union[str, Tuple[str, ...]]]] = []
        for dim, name in zip(spec.shape, spec.axes):
            picked = None
            for pref in self.rules.get(name, ()):  # type: ignore[arg-type]
                axes = _norm(pref)
                if not all(a in mesh.shape for a in axes):
                    continue
                if any(a in used for a in axes):
                    continue
                if dim % axis_size(mesh, axes) != 0:
                    continue
                picked = axes[0] if len(axes) == 1 else tuple(axes)
                used.update(axes)
                break
            out.append(picked)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


def train_policy(mesh: Mesh) -> Policy:
    """TP over "model" (heads, ff, vocab, experts, inner) and FSDP over
    "data" on the embed dim; an expert's ff dim takes "model" and "data"
    jointly, never its input dim (a data-sharded contraction dim would
    turn the expert products into float32 partial-sum all-reduces)."""
    return Policy(rules={
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("expert", "model"),
        "expert_ff": (("model", "data"), ("model",), ("data",)),
        "expert_in": (),
        "halfexpert": ("model",),
        "expert_ff_fsdp": ("data",),
        "inner": ("model",),
        "embed": ("data",),
    })


def dp_spec(mesh: Mesh, batch: int
            ) -> Optional[Union[str, Tuple[str, ...]]]:
    """Mesh axes of a batch dim: the data-parallel axes when they divide
    ``batch``, else "data", else None (replicated)."""
    for axes in (data_axes(mesh), ("data",)):
        if axes and all(a in mesh.shape for a in axes) \
                and batch % axis_size(mesh, axes) == 0:
            return axes[0] if len(axes) == 1 else tuple(axes)
    return None


def batch_pspecs(batch_specs: Dict[str, Any], mesh: Mesh
                 ) -> Dict[str, PSpec]:
    """PartitionSpecs of a step's inputs (the reference's
    ``batch_shardings``): a leaf's leading dim over ``dp_spec``, the
    others replicated; a scalar ()."""
    out = {}
    for name, s in batch_specs.items():
        shape = tuple(s.shape)
        out[name] = (() if shape == () else
                     (dp_spec(mesh, shape[0]),) + (None,) * (len(shape) - 1))
    return out


_SEQ_PREFS = (("pod", "data", "model"), ("data", "model"), ("model",),
              ("data",))


def _cache_pspec(name: str, shape: Tuple[int, ...], mesh: Mesh) -> PSpec:
    """PartitionSpec of one decode-cache leaf by its name (the
    reference's ``_cache_pspec``): k / v / ck / cv [G, B, S, KH, D] put
    the batch over ``dp_spec``, the kv heads over "model" when it divides
    them (head-wise TP), and the sequence over the first of _SEQ_PREFS
    whose axes are unused and divide it (distributed flash-decoding);
    conv [G, B, W, ed], ssm [G, B, ed, N] and state [G, B, H, Dh, Dh]
    put their inner or head dim over "model" when it divides; anything
    else (shift, shift_c) is split over the batch only."""
    used: set = set()
    bspec = dp_spec(mesh, shape[1])
    if bspec is not None:
        used.update(_norm(bspec))
    tp = axis_size(mesh, "model")
    if name in ("k", "v", "ck", "cv"):
        S, KH = shape[2], shape[3]
        hspec = None
        if "model" in mesh.shape and "model" not in used \
                and KH % tp == 0 and tp > 1:
            hspec = "model"
            used.add("model")
        sspec = None
        for axes in _SEQ_PREFS:
            if all(a in mesh.shape for a in axes) \
                    and not (set(axes) & used) \
                    and S % axis_size(mesh, axes) == 0:
                sspec = axes[0] if len(axes) == 1 else tuple(axes)
                break
        return (None, bspec, sspec, hspec, None)
    if name == "conv":
        return (None, bspec, None, "model" if shape[3] % tp == 0 else None)
    if name == "ssm":
        return (None, bspec, "model" if shape[2] % tp == 0 else None, None)
    if name == "state":
        return (None, bspec, "model" if shape[2] % tp == 0 else None,
                None, None)
    return (None, bspec) + (None,) * (len(shape) - 2)


def cache_pspecs(cache_specs: Pytree, mesh: Mesh) -> Pytree:
    """``_cache_pspec`` of every leaf of a ``cache_specs`` tree (the
    reference's ``cache_shardings``)."""
    return {k: (cache_pspecs(v, mesh) if isinstance(v, dict)
                else _cache_pspec(k, tuple(v.shape), mesh))
            for k, v in cache_specs.items()}


def q8_scale_pspec(pspec: PSpec, ndim: int) -> PSpec:
    """The PartitionSpec of an int8 moment's float32 scale, shape
    shape[:-1] + (1,), from its parameter's ``pspec``: the last dim's
    entry goes only when the spec reaches it (the reference's
    ``q8_sharding`` in ``launch/dryrun.py``); the int8 values keep
    ``pspec``."""
    return pspec[:-1] if len(pspec) == ndim else pspec


def serve_policy(mesh: Mesh, param_bytes: int,
                 fsdp_bytes_per_chip: int = 6 << 30) -> Policy:
    """TP over "model"; a model whose TP shard would still exceed
    ``fsdp_bytes_per_chip`` also puts its embed dim on "data" (of size 1
    on a serve submesh, so nothing more is split)."""
    tp = axis_size(mesh, "model")
    big = param_bytes // tp > fsdp_bytes_per_chip
    rules = {
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "expert_ff": ((("model", "data"), ("model",), ("data",))
                      if big else (("model",),)),
        "expert_in": (),
        "halfexpert": ("model",),
        "expert_ff_fsdp": (("data",) if big else ()),
        "inner": ("model",),
    }
    if big:
        rules["embed"] = ("data",)
    return Policy(rules=rules)


def _walk(tree: Pytree, fn) -> Pytree:
    if isinstance(tree, Spec):
        return fn(tree)
    return {k: _walk(v, fn) for k, v in tree.items()}


def param_pspecs(specs: Pytree, mesh: Mesh, policy: Policy) -> Pytree:
    return _walk(specs, lambda s: policy.pspec(s, mesh))


def pool_pspec(shape: Tuple[int, ...], mesh: Mesh) -> PSpec:
    """PartitionSpec of one paged-pool leaf [n_pages, PS, KH, D], each arm
    guarded by divisibility:
      1. head-wise ("model" on KH): each shard owns KH/tp kv heads of
         every page;
      2. slot-wise ("model" on PS), the GQA fallback when tp does not
         divide KH: heads replicate and each shard owns PS/tp token slots
         of every page (distributed flash-decoding over the slot shards);
      3. page-wise ("model" on n_pages) when PS does not divide either;
      4. replicated."""
    n_pages, ps, kh, _d = shape
    tp = axis_size(mesh, "model")
    if tp <= 1:
        return (None, None, None, None)
    if kh % tp == 0:
        return (None, None, "model", None)
    if ps % tp == 0:
        return (None, "model", None, None)
    if n_pages % tp == 0:
        return ("model", None, None, None)
    return (None, None, None, None)


def span_pspec(shape: Tuple[int, ...], mesh: Mesh) -> PSpec:
    """PartitionSpec of a token-granular KV span [..., KH, D] (the host
    tier's copies): only the head shard carries over from
    ``pool_pspec``; slot- and page-sharded pools replicate the span."""
    kh = shape[-2]
    tp = axis_size(mesh, "model")
    if tp > 1 and kh % tp == 0:
        return (None,) * (len(shape) - 2) + ("model", None)
    return (None,) * len(shape)


def _model_dims(pspec: PSpec) -> List[int]:
    """The dims a spec splits over "model"."""
    return [i for i, e in enumerate(pspec)
            if e is not None and "model" in _norm(e)]


def _zip_walk(tree: Pytree, pspecs: Pytree, fn, path=()) -> Pytree:
    """fn(path, leaf, pspec) over the leaves of ``tree``; a path that
    ``pspecs`` lacks is replicated (pspec ())."""
    if isinstance(tree, dict):
        return {k: _zip_walk(v, pspecs.get(k, ()) if isinstance(pspecs, dict)
                             else (), fn, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, pspecs if isinstance(pspecs, tuple) else ())


def shard_tree(tree: Pytree, pspecs: Pytree, mesh: Mesh) -> List[Pytree]:
    """One tree a shard: each leaf shard s's block by its PartitionSpec
    (the whole leaf where the spec splits nothing), a fresh tensor on
    shard s's device."""
    return [_zip_walk(tree, pspecs,
                      lambda _, t, ps, s=s: M.piece(t, ps, mesh, s))
            for s in range(mesh.size)]


def _leaf_parts(shards: Sequence[Pytree], path) -> List[torch.Tensor]:
    out = []
    for tree in shards:
        for k in path:
            tree = tree[k]
        out.append(tree)
    return out


def _whole_shape(part_shape: Sequence[int], pspec: PSpec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The whole leaf's shape from one shard's block shape."""
    shape = list(part_shape)
    for d, e in enumerate(pspec):
        shape[d] *= axis_size(mesh, _norm(e)) if e is not None else 1
    return tuple(shape)


def unshard_leaf(shards: Sequence[Pytree], path: Sequence[str], pspec: PSpec,
                 mesh: Mesh, device) -> torch.Tensor:
    """The leaf at ``path`` whole from the shards' trees, a fresh tensor
    on ``device``."""
    parts = _leaf_parts(shards, path)
    return M.assemble(parts, _whole_shape(parts[0].shape, pspec, mesh), pspec,
                      mesh, device)


def unshard_tree(shards: Sequence[Pytree], pspecs: Pytree, mesh: Mesh,
                 device=None) -> Pytree:
    """Inverse of ``shard_tree``: the whole tree, each leaf a fresh
    tensor on ``device`` (default shard 0's)."""
    dev = mesh.devices[0] if device is None else device
    return _zip_walk(shards[0], pspecs, lambda path, _, ps: unshard_leaf(
        shards, path, ps, mesh, dev))


@dataclass(frozen=True)
class TreeSharding:
    """A mesh and a tree of PartitionSpecs (a path it lacks is
    replicated): the port's counterpart of a tree of NamedShardings."""
    mesh: Mesh
    pspecs: Pytree

    def pspec(self, path: Sequence[str]) -> PSpec:
        t = self.pspecs
        for k in path:
            if not isinstance(t, dict) or k not in t:
                return ()
            t = t[k]
        return t if isinstance(t, tuple) else ()


def shard_params(params: Pytree, specs: Pytree, mesh: Mesh,
                 policy: Policy) -> List[Pytree]:
    """One parameter tree per shard by ``policy``'s specs (``shard_tree``):
    on a serve submesh (1, tp) each leaf shard s's piece along the dims
    its spec puts on "model" (the whole leaf where it has none)."""
    return shard_tree(params, param_pspecs(specs, mesh, policy), mesh)


def unshard_params(shards: Sequence[Pytree], specs: Pytree, mesh: Mesh,
                   policy: Policy) -> Pytree:
    """Inverse of ``shard_params``: the whole tree on shard 0's device."""
    return unshard_tree(shards, param_pspecs(specs, mesh, policy), mesh)


def tree_bytes(tree: Pytree) -> int:
    """Bytes held by a tree of tensors (one shard's parameters or pool)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# the shard layout of a serving instance
# ---------------------------------------------------------------------------

POOL_MODES = {(None, None, "model", None): "head",
              (None, "model", None, None): "slot",
              ("model", None, None, None): "page",
              (None, None, None, None): "rep"}


@dataclass(frozen=True)
class ShardPlan:
    """How one tensor-parallel instance lays its model and pool over its
    submesh. ``heads``/``kv_heads``/``ff``/``vocab``: whether that dim of
    the weights is split over the shards (else replicated); ``experts``
    / ``expert_ff``: whether the MoE experts are split whole over the
    shards (E / tp a shard), or each expert's ff columns. ``pool``: the
    arm of ``pool_pspec`` the KV pool [n_pages, page_size, KH, D] takes
    ("head", "slot", "page" or "rep")."""
    mesh: Mesh
    heads: bool
    kv_heads: bool
    ff: bool
    vocab: bool
    pool: str
    n_pages: int
    page_size: int
    experts: bool = False
    expert_ff: bool = False

    @property
    def tp(self) -> int:
        return self.mesh.size

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return self.mesh.devices

    def local_pool_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """A shard's leaf shape for a pool leaf [n_pages, PS, KH, D]."""
        n, ps, kh, d = shape
        tp = self.tp
        return {"head": (n, ps, kh // tp, d), "slot": (n, ps // tp, kh, d),
                "page": (n // tp, ps, kh, d), "rep": (n, ps, kh, d)}[self.pool]

    @property
    def slot_size(self) -> int:
        """Token slots of a page that one shard holds."""
        return self.page_size // self.tp if self.pool == "slot" \
            else self.page_size

    @property
    def pages_per_shard(self) -> int:
        return self.n_pages // self.tp if self.pool == "page" \
            else self.n_pages


def shard_plan(cfg, mesh: Mesh, n_pages: int, page_size: int,
               policy: Optional[Policy] = None) -> ShardPlan:
    """The layout of ``cfg`` served on ``mesh`` with a pool of n_pages
    pages of page_size tokens, read off the PartitionSpecs that
    ``policy`` (default: ``serve_policy``) gives its leaves."""
    from ..bridge import param_bytes, param_specs
    specs = param_specs(cfg)
    policy = policy or serve_policy(mesh, param_bytes(cfg))
    ps = param_pspecs(specs, mesh, policy)
    attn = ps["stack"]["p0"]["attn"]
    ffns = [p["ffn"] for p in ps["stack"].values()]
    mlp = next((f["wg"] for f in ffns if "router" not in f), None)
    moe = next((f["wg"] for f in ffns if "router" in f), None)

    def split(pspec, dim):
        return pspec is not None and dim in _model_dims(pspec)

    pool = POOL_MODES[pool_pspec((n_pages, page_size, cfg.n_kv_heads,
                                  cfg.head_dim), mesh)]
    # wg: [layers, embed, ff] (SwiGLU), [layers, experts, expert_in,
    # expert_ff] (MoE)
    plan = ShardPlan(mesh=mesh, heads=split(attn["wq"], 2),
                     kv_heads=split(attn["wk"], 2), ff=split(mlp, 2),
                     vocab=split(ps["embed"]["tok"], 0), pool=pool,
                     n_pages=n_pages, page_size=page_size,
                     experts=split(moe, 1), expert_ff=split(moe, 3))
    if plan.kv_heads != (pool == "head"):
        raise ValueError(f"kv-head split {plan.kv_heads} disagrees with the "
                         f"{pool}-wise pool")
    return plan
