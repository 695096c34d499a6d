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
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

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


# (shape, init) per leaf, in the JAX package's spec order
Spec = Tuple[Tuple[int, ...], str]


def param_specs(cfg) -> Dict[str, Any]:
    """Shapes and init kinds of a paged-servable decoder with SwiGLU
    FFNs, as ``models/spec.py`` of the JAX package declares them."""
    d, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n, f = cfg.n_groups, cfg.d_ff
    embed: Dict[str, Spec] = {"tok": ((cfg.vocab_size, d), "normal"),
                              "final_norm": ((d,), "ones")}
    if not cfg.tie_embeddings:
        embed["head"] = ((d, cfg.vocab_size), "fan_in")
    stack = {}
    for j, pos in enumerate(layer_plan(cfg)):
        if pos.mixer != "attn" or pos.cross or pos.ffn != "mlp":
            raise NotImplementedError(f"{cfg.name}: layer kind {pos} is not "
                                      "ported yet")
        p: Dict[str, Any] = {
            "norm1": ((n, d), "ones"),
            "attn": {"wq": ((n, d, H, Dh), "fan_in"),
                     "wk": ((n, d, KH, Dh), "fan_in"),
                     "wv": ((n, d, KH, Dh), "fan_in"),
                     "wo": ((n, H, Dh, d), "fan_in")}}
        if not cfg.parallel_block:
            p["norm2"] = ((n, d), "ones")
        p["ffn"] = {"wg": ((n, d, f), "fan_in"), "wu": ((n, d, f), "fan_in"),
                    "wd": ((n, f, d), "fan_in")}
        stack[f"p{j}"] = p
    return {"embed": embed, "stack": stack}


def init_params(cfg, generator: torch.Generator, device) -> Pytree:
    """Random parameters in ``cfg.dtype`` on ``device``, drawn from
    ``generator`` (which must live on ``device``). Init kinds follow the
    JAX specs: ones; normal(0.02); fan_in = normal / sqrt(shape[-2]) of
    the stacked shape."""
    dt = getattr(torch, cfg.dtype)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        shape, kind = tree
        if kind == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        scale = 1.0 / math.sqrt(shape[-2]) if kind == "fan_in" else 0.02
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dt)

    return walk(param_specs(cfg))
