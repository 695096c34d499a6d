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
specs (``fan_in`` / ``ones`` / ``zeros`` / normal); the values differ
from JAX's.
``abstract_params`` gives the same tree as empty meta tensors (the
dry-run's parameters), ``logical_axes`` and ``param_count`` its axes and
size. ``param_specs`` also carries each leaf's logical sharding axes, copied
from the JAX package's specs, for ``launch/sharding.py``, and the dtype
of a leaf pinned to one whatever the model's (an MoE router and a mamba
layer's A_log and D are float32 even in a bfloat16 model, as the JAX
package's ``Spec(..., dtype="float32")``).
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
    """One parameter leaf: its shape, its init kind ("normal", "fan_in",
    "ones", "zeros"), its logical axes (one name or None per dim, the JAX
    package's vocabulary: "layers", "vocab", "embed", "heads",
    "kv_heads", "ff", "experts", "expert_in", "expert_ff", "halfexpert",
    "expert_ff_fsdp", "inner"), its dtype: None for the model's
    (``cfg.dtype``), else the one the leaf is pinned to, and the scale of
    a "normal" draw."""
    shape: Tuple[int, ...]
    init: str
    axes: Tuple[Optional[str], ...]
    dtype: Optional[str] = None
    scale: float = 0.02


def _leaf_dtype(spec: Spec, cfg) -> torch.dtype:
    return getattr(torch, spec.dtype or cfg.dtype)


def _stack(leaves: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Add the leading ("layers", n) axis to every leaf of a tree."""
    return {k: (_stack(v, n) if isinstance(v, dict) else
                v._replace(shape=(n,) + v.shape, axes=("layers",) + v.axes))
            for k, v in leaves.items()}


def _moe_specs(cfg) -> Dict[str, Spec]:
    """The MoE FFN's leaves (``layers.moe_specs`` of the JAX package): a
    float32 router [d, E] and experts [E, d, f] / [E, f, d]; with
    ``moe_impl == "halfexpert"`` the experts pre-split into tp =
    ``cfg.moe_tp`` half-experts (``moe_a2a.moe_halfexpert_specs``)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if cfg.moe_impl == "halfexpert":
        from .models.moe_a2a import moe_halfexpert_specs
        return moe_halfexpert_specs(cfg, cfg.moe_tp)
    up = Spec((E, d, f), "fan_in", ("experts", "expert_in", "expert_ff"))
    return {"router": Spec((d, E), "fan_in", ("embed", None), "float32"),
            "wg": up, "wu": up,
            "wd": Spec((E, f, d), "fan_in",
                       ("experts", "expert_ff", "expert_in"))}


def _attn_specs(cfg) -> Dict[str, Spec]:
    """Self- or cross-attention projections, head-factored
    (``layers.attn_specs``)."""
    d, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": Spec((d, H, Dh), "fan_in", ("embed", "heads", None)),
            "wk": Spec((d, KH, Dh), "fan_in", ("embed", "kv_heads", None)),
            "wv": Spec((d, KH, Dh), "fan_in", ("embed", "kv_heads", None)),
            "wo": Spec((H, Dh, d), "fan_in", ("heads", None, "embed"))}


def _mamba_specs(cfg) -> Dict[str, Spec]:
    """The selective-scan layer (``mamba.mamba_specs``): A_log and D are
    float32 in any model dtype."""
    d, N = cfg.d_model, cfg.mamba_d_state
    ed = cfg.mamba_expand * d
    R = max(d // 16, 1)
    return {"in_proj": Spec((d, 2 * ed), "fan_in", ("embed", "inner")),
            "conv_w": Spec((cfg.mamba_d_conv, ed), "normal",
                           (None, "inner"), scale=0.2),
            "conv_b": Spec((ed,), "zeros", ("inner",)),
            "x_proj": Spec((ed, R + 2 * N), "fan_in", ("inner", None)),
            "dt_w": Spec((R, ed), "fan_in", (None, "inner")),
            "dt_b": Spec((ed,), "zeros", ("inner",)),
            "A_log": Spec((ed, N), "zeros", ("inner", None), "float32"),
            "D": Spec((ed,), "ones", ("inner",), "float32"),
            "out_proj": Spec((ed, d), "fan_in", ("inner", "embed"))}


def _rwkv_specs(cfg) -> Dict[str, Dict[str, Spec]]:
    """RWKV-6 time-mix and channel-mix (``rwkv6.rwkv_time_specs``,
    ``rwkv_channel_specs``)."""
    d, f = cfg.d_model, cfg.d_ff
    sq = Spec((d, d), "fan_in", ("embed", "heads"))
    return {
        "time": {"mu": Spec((5, d), "zeros", (None, None)),
                 "ww": Spec((d,), "zeros", (None,)),
                 "w_lora_a": Spec((d, 64), "fan_in", ("embed", None)),
                 "w_lora_b": Spec((64, d), "fan_in", (None, "heads")),
                 "wr": sq, "wk": sq, "wv": sq, "wg": sq,
                 "wo": Spec((d, d), "fan_in", ("heads", "embed")),
                 "u": Spec((d,), "normal", ("heads",), scale=0.5),
                 "ln_x": Spec((d,), "ones", (None,))},
        "channel": {"mu_c": Spec((2, d), "zeros", (None, None)),
                    "wr_c": sq,
                    "wk_c": Spec((d, f), "fan_in", ("embed", "ff")),
                    "wv_c": Spec((f, d), "fan_in", ("ff", "embed"))}}


def _stack_specs(cfg) -> Dict[str, Any]:
    """One group's layer positions (``transformer._pos_specs``), stacked
    over the n_groups scan axis."""
    d, f = cfg.d_model, cfg.d_ff
    norm = Spec((d,), "ones", (None,))
    stack = {}
    for j, pos in enumerate(layer_plan(cfg)):
        p: Dict[str, Any] = {"norm1": norm}
        if pos.mixer == "rwkv":
            rw = _rwkv_specs(cfg)
            p.update(time=rw["time"], norm2=norm, channel=rw["channel"])
            stack[f"p{j}"] = _stack(p, cfg.n_groups)
            continue
        if pos.mixer == "attn":
            p["attn"] = _attn_specs(cfg)
        else:
            p["mamba"] = _mamba_specs(cfg)
        if pos.cross:
            p["cross_norm"] = norm
            p["cross"] = _attn_specs(cfg)
        if not cfg.parallel_block:
            p["norm2"] = norm
        if pos.ffn == "moe":
            p["ffn"] = _moe_specs(cfg)
        else:
            p["ffn"] = {"wg": Spec((d, f), "fan_in", ("embed", "ff")),
                        "wu": Spec((d, f), "fan_in", ("embed", "ff")),
                        "wd": Spec((f, d), "fan_in", ("ff", "embed"))}
        stack[f"p{j}"] = _stack(p, cfg.n_groups)
    return stack


def param_specs(cfg) -> Dict[str, Any]:
    """Shapes, init kinds, logical axes and pinned dtypes of every leaf,
    as ``models/spec.py`` of the JAX package declares them: a decoder
    ``{"embed", "stack"}`` of attention, mamba or RWKV positions (with
    SwiGLU or MoE FFNs and cross-attention sub-blocks), or an
    encoder-decoder ``{"embed", "enc_norm", "encoder", "decoder"}``
    (``zoo._build_encdec``); stack leaves carry the leading "layers"
    axis."""
    d = cfg.d_model
    embed: Dict[str, Spec] = {
        "tok": Spec((cfg.vocab_size, d), "normal", ("vocab", "embed")),
        "final_norm": Spec((d,), "ones", (None,))}
    if not cfg.tie_embeddings:
        embed["head"] = Spec((d, cfg.vocab_size), "fan_in",
                             ("embed", "vocab"))
    if cfg.encoder_decoder:
        from .models.zoo import encdec_configs
        enc_cfg, dec_cfg = encdec_configs(cfg)
        return {"embed": embed,
                "enc_norm": Spec((d,), "ones", (None,)),
                "encoder": _stack_specs(enc_cfg),
                "decoder": _stack_specs(dec_cfg)}
    return {"embed": embed, "stack": _stack_specs(cfg)}


def param_bytes(cfg) -> int:
    """Bytes of the parameters, each leaf in its dtype (the JAX package's
    ``ModelAPI.n_bytes``)."""
    def walk(tree):
        if isinstance(tree, Spec):
            return _leaf_dtype(tree, cfg).itemsize * math.prod(tree.shape)
        return sum(walk(v) for v in tree.values())

    return walk(param_specs(cfg))


def _walk(tree, fn):
    if isinstance(tree, Spec):
        return fn(tree)
    return {k: _walk(v, fn) for k, v in tree.items()}


def abstract_params(cfg, device="meta") -> Pytree:
    """The parameters as empty tensors in each leaf's shape and dtype, on
    ``device`` (meta: shapes only, nothing allocated; the reference's
    ``abstract_params`` of ShapeDtypeStructs)."""
    return _walk(param_specs(cfg), lambda s: torch.empty(
        s.shape, dtype=_leaf_dtype(s, cfg), device=device))


def logical_axes(cfg) -> Pytree:
    """Every leaf's logical axes (the reference's ``logical_axes``)."""
    return _walk(param_specs(cfg), lambda s: s.axes)


def param_count(cfg) -> int:
    """Parameters in all leaves (the reference's ``param_count``)."""
    total = 0

    def leaf(s):
        nonlocal total
        total += math.prod(s.shape)

    _walk(param_specs(cfg), leaf)
    return total


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
        if kind == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        scale = (1.0 / math.sqrt(shape[-2]) if kind == "fan_in"
                 else tree.scale)
        out = torch.empty(shape, dtype=dt, device=device)
        fill(out, scale)
        return out

    return walk(param_specs(cfg))
