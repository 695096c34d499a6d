"""Parameters and KV pools between numpy trees and the port's tensors.

The JAX package stores a model as nested dicts of arrays; its
checkpoints keep bfloat16 leaves as uint16 bit views
(``train/checkpoint.py``). The port uses the same nested layout with
torch tensors: ``{"embed": {...}, "stack": {"p{j}": {...}}}`` with every
stack leaf stacked over [n_groups, ...], and page pools
``{"p{j}": {"g{g}": {"k","v": [n_pages, PS, KH, D]}}}``.

``tree_from_numpy`` / ``tree_to_numpy`` move either kind of tree across
(uint16 leaves are bfloat16 bits). ``init_params`` makes the port's own
random parameters with the shapes and init kinds of the JAX package's
specs (``fan_in`` / ``ones`` / normal); the values differ from JAX's.
``param_specs`` also carries each leaf's logical sharding axes, copied
from the JAX package's specs, for ``launch/sharding.py``, and the dtype
of a leaf pinned to one whatever the model's (an MoE router is float32
even in a bfloat16 model, as the JAX package's ``Spec(...,
dtype="float32")``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .models.transformer import layer_plan

Pytree = Any


def _leaf_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")       # writable, owned
    if a.dtype == np.uint16:                        # bfloat16 bits
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tree_from_numpy(tree: Pytree, device) -> Pytree:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (parameters or page pools)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


def tree_to_numpy(tree: Pytree) -> Pytree:
    """Nested dicts of tensors -> numpy (bfloat16 as uint16 bits)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return _leaf_to_numpy(tree)


def tree_to(tree: Pytree, device) -> Pytree:
    """The same tree with every tensor on ``device`` (no copy for
    tensors already there)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class Spec(NamedTuple):
    """One parameter leaf: its shape, its init kind, its logical axes
    (one name or None per dim, the JAX package's vocabulary: "layers",
    "vocab", "embed", "heads", "kv_heads", "ff", "experts", "expert_in",
    "expert_ff", "halfexpert", "expert_ff_fsdp") and its dtype: None for
    the model's (``cfg.dtype``), else the one the leaf is pinned to."""
    shape: Tuple[int, ...]
    init: str
    axes: Tuple[Optional[str], ...]
    dtype: Optional[str] = None


def _leaf_dtype(spec: Spec, cfg) -> torch.dtype:
    return getattr(torch, spec.dtype or cfg.dtype)


def _moe_specs(cfg, n: int) -> Dict[str, Spec]:
    """The MoE FFN's leaves (``layers.moe_specs`` of the JAX package),
    stacked over n groups: a float32 router [d, E] and experts [E, d, f]
    / [E, f, d]; with ``moe_impl == "halfexpert"`` the experts pre-split
    into tp = ``cfg.moe_tp`` half-experts
    (``moe_a2a.moe_halfexpert_specs``)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if cfg.moe_impl == "halfexpert":
        from .models.moe_a2a import moe_halfexpert_specs
        leaves = moe_halfexpert_specs(cfg, cfg.moe_tp)
    else:
        up = Spec((E, d, f), "fan_in", ("experts", "expert_in", "expert_ff"))
        leaves = {"router": Spec((d, E), "fan_in", ("embed", None),
                                 "float32"),
                  "wg": up, "wu": up,
                  "wd": Spec((E, f, d), "fan_in",
                             ("experts", "expert_ff", "expert_in"))}
    return {k: Spec((n,) + v.shape, v.init, ("layers",) + v.axes, v.dtype)
            for k, v in leaves.items()}


def param_specs(cfg) -> Dict[str, Any]:
    """Shapes, init kinds, logical axes and pinned dtypes of a decoder of
    attention mixers with SwiGLU or MoE FFNs, as ``models/spec.py`` of
    the JAX package declares them (``layers.attn_specs``, ``mlp_specs``,
    ``moe_specs``, ``embed_specs`` and ``norm_spec``; stack leaves gain
    the leading "layers" axis)."""
    d, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n, f = cfg.n_groups, cfg.d_ff
    embed: Dict[str, Spec] = {
        "tok": Spec((cfg.vocab_size, d), "normal", ("vocab", "embed")),
        "final_norm": Spec((d,), "ones", (None,))}
    if not cfg.tie_embeddings:
        embed["head"] = Spec((d, cfg.vocab_size), "fan_in",
                             ("embed", "vocab"))
    norm = Spec((n, d), "ones", ("layers", None))
    stack = {}
    for j, pos in enumerate(layer_plan(cfg)):
        if pos.mixer != "attn" or pos.cross or pos.ffn not in ("mlp",
                                                                "moe"):
            raise NotImplementedError(f"{cfg.name}: layer kind {pos} is not "
                                      "ported yet")
        p: Dict[str, Any] = {
            "norm1": norm,
            "attn": {
                "wq": Spec((n, d, H, Dh), "fan_in",
                           ("layers", "embed", "heads", None)),
                "wk": Spec((n, d, KH, Dh), "fan_in",
                           ("layers", "embed", "kv_heads", None)),
                "wv": Spec((n, d, KH, Dh), "fan_in",
                           ("layers", "embed", "kv_heads", None)),
                "wo": Spec((n, H, Dh, d), "fan_in",
                           ("layers", "heads", None, "embed"))}}
        if not cfg.parallel_block:
            p["norm2"] = norm
        if pos.ffn == "moe":
            p["ffn"] = _moe_specs(cfg, n)
        else:
            p["ffn"] = {
                "wg": Spec((n, d, f), "fan_in", ("layers", "embed", "ff")),
                "wu": Spec((n, d, f), "fan_in", ("layers", "embed", "ff")),
                "wd": Spec((n, f, d), "fan_in", ("layers", "ff", "embed"))}
        stack[f"p{j}"] = p
    return {"embed": embed, "stack": stack}


def param_bytes(cfg) -> int:
    """Bytes of the parameters, each leaf in its dtype (the JAX package's
    ``ModelAPI.n_bytes``)."""
    def walk(tree):
        if isinstance(tree, Spec):
            return _leaf_dtype(tree, cfg).itemsize * math.prod(tree.shape)
        return sum(walk(v) for v in tree.values())

    return walk(param_specs(cfg))


DRAW_ELEMS = 1 << 31    # elements of the largest leaf drawn in one piece


def init_params(cfg, generator: torch.Generator, device) -> Pytree:
    """Random parameters on ``device``, each leaf in its dtype (the
    model's unless pinned), drawn from ``generator`` (which must live on
    ``device``). Init kinds follow the JAX specs: ones; normal(0.02);
    fan_in = normal / sqrt(shape[-2]) of the stacked shape. A leaf of
    more than ``DRAW_ELEMS`` elements is drawn slice by slice along its
    leading dims, so its float32 draw never holds more than a slice (a
    full-width MoE expert leaf is ~10^10 elements)."""
    def fill(t, scale):
        if t.numel() <= DRAW_ELEMS or t.dim() == 1:
            x = torch.randn(t.shape, generator=generator,
                            dtype=torch.float32, device=device)
            t.copy_((x * scale).to(t.dtype))
            return
        for piece in t:
            fill(piece, scale)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        shape, kind, dt = tree.shape, tree.init, _leaf_dtype(tree, cfg)
        if kind == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        scale = 1.0 / math.sqrt(shape[-2]) if kind == "fan_in" else 0.02
        out = torch.empty(shape, dtype=dt, device=device)
        fill(out, scale)
        return out

    return walk(param_specs(cfg))
