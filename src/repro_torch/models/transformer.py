"""The paged decoder stack (counterpart of the JAX package's
``models/transformer.py``, paged serving entry points only).

Parameters mirror the JAX tree: ``{"p{j}": leaves stacked over
[n_groups, ...]}`` for the per-group layer plan; group g's weights are
the views ``a[g]``. The KV pool is ``{"p{j}": {"g{g}": {"k","v"}}}``,
one [n_pages, PS, KH, D] pair per physical layer, updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from . import layers as L
from .common import rms_norm

Pytree = Any


@dataclass(frozen=True)
class PosPlan:
    mixer: str            # "attn" | "mamba" | "rwkv"
    ffn: str              # "mlp" | "moe" | "rwkv"
    cross: bool = False   # cross-attention sub-block after the mixer
    window: int = 0       # sliding window for attn mixers (0 = full)


def layer_plan(cfg) -> List[PosPlan]:
    """The periodic per-group layer pattern for this config."""
    plan = []
    for j in range(cfg.group_size):
        if cfg.attention_free:
            plan.append(PosPlan("rwkv", "rwkv"))
            continue
        mixer = "attn" if cfg.is_attn_layer(j) else "mamba"
        ffn = "moe" if cfg.is_moe_layer(j) else "mlp"
        cross = cfg.is_cross_attn_layer(j)
        plan.append(PosPlan(mixer, ffn, cross, cfg.sliding_window))
    return plan


def paged_servable(cfg) -> bool:
    """True when every layer position can be served from the KV page
    pool: self-attention mixers only, no cross-attention, no sliding
    window, decoder-only."""
    if cfg.encoder_decoder:
        return False
    return all(p.mixer == "attn" and not p.cross and not p.window
               for p in layer_plan(cfg))


def paged_cache_specs(cfg, n_pages: int, page_size: int,
                      device) -> Pytree:
    """Allocate the per-layer KV page pools (zeros): one
    [n_pages, page_size, KH, D] k/v pair per (attention position, group)
    — per physical layer. The pool is instance-wide: requests address it
    through page tables."""
    if not paged_servable(cfg):
        raise ValueError(f"{cfg.name}: stack is not paged-servable")
    dt = getattr(torch, cfg.dtype)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {f"p{j}": {f"g{g}": {"k": torch.zeros(shape, dtype=dt,
                                                 device=device),
                                "v": torch.zeros(shape, dtype=dt,
                                                 device=device)}
                      for g in range(cfg.n_groups)}
            for j, _pos in enumerate(layer_plan(cfg))}


def _group(tree, g: int):
    """Group g's weights: the views a[g] of every stacked leaf."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _mlp_step(pf, x_dtype, h):
    """SwiGLU for the [B, d] step paths."""
    g = torch.nn.functional.silu((h @ pf["wg"]).float())
    u = (h @ pf["wu"]).float()
    return (g * u).to(x_dtype) @ pf["wd"]


def _ffn_step_tail(p, cfg, pos: PosPlan, x):
    """norm2 + SwiGLU FFN after the mixer residual, single-token lanes
    (MoE FFNs are not ported: ``zoo.build`` rejects them)."""
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _mlp_step(p["ffn"], x.dtype, h2)


def _ffn_extend_tail(p, cfg, pos: PosPlan, x):
    """norm2 + SwiGLU FFN over a chunk."""
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp_full(p["ffn"], cfg, h2)


def _pos_step_paged(p, cfg, pos: PosPlan, x, pages, page_table, position):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    y, pages = L.attn_step_paged(p["attn"], cfg, h, pages, page_table,
                                 position)
    if cfg.parallel_block:
        return x + y + _mlp_step(p["ffn"], x.dtype, h), pages
    return _ffn_step_tail(p, cfg, pos, x + y), pages


def forward_step_paged(params, cfg, x, pages, page_table, position
                       ) -> Tuple[torch.Tensor, Pytree]:
    """x: [B, d] one embedded token per lane; ``pages`` the instance-wide
    pool (updated in place); page_table [B, P]; position [B] context
    lengths. Returns (hidden [B, d], pages)."""
    plan = layer_plan(cfg)
    for g in range(cfg.n_groups):
        for j, pos in enumerate(plan):
            gp = _group(params[f"p{j}"], g)
            x, _ = _pos_step_paged(gp, cfg, pos, x, pages[f"p{j}"][f"g{g}"],
                                   page_table, position)
    return x, pages


def _pos_mixed_paged(p, cfg, pos_plan: PosPlan, xc, xd, pages, chunk_table,
                     chunk_start, chunk_len, dec_table, dec_pos):
    hc = rms_norm(xc, p["norm1"], cfg.norm_eps)
    hd = rms_norm(xd, p["norm1"], cfg.norm_eps)
    yc, yd, pages = L.attn_mixed_paged(p["attn"], cfg, hc, hd, pages,
                                       chunk_table, chunk_start, chunk_len,
                                       dec_table, dec_pos)
    if cfg.parallel_block:
        return (xc + yc + L.mlp_full(p["ffn"], cfg, hc),
                xd + yd + _mlp_step(p["ffn"], xd.dtype, hd), pages)
    return (_ffn_extend_tail(p, cfg, pos_plan, xc + yc),
            _ffn_step_tail(p, cfg, pos_plan, xd + yd), pages)


def forward_mixed_paged(params, cfg, xc, xd, pages, chunk_table,
                        chunk_start, chunk_len, dec_table, dec_pos
                        ) -> Tuple[torch.Tensor, torch.Tensor, Pytree]:
    """Fused ragged iteration: every query token of the scheduling step
    in one forward. ``xc`` [Lc, C, d] embeds the prefill chunks padded to
    C (lane l: chunk_len[l] real tokens from chunk_start[l]); ``xd``
    [Ld, d] embeds the decode lanes (fed token at dec_pos[l]). Padding
    lanes carry all-scratch table rows. Returns (hidden_c [Lc, C, d],
    hidden_d [Ld, d], pages)."""
    plan = layer_plan(cfg)
    for g in range(cfg.n_groups):
        for j, pos in enumerate(plan):
            gp = _group(params[f"p{j}"], g)
            xc, xd, _ = _pos_mixed_paged(
                gp, cfg, pos, xc, xd, pages[f"p{j}"][f"g{g}"], chunk_table,
                chunk_start, chunk_len, dec_table, dec_pos)
    return xc, xd, pages


def _pos_extend_paged(p, cfg, pos: PosPlan, x, pages, page_table, start):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    y, pages = L.attn_extend_paged(p["attn"], cfg, h, pages, page_table,
                                   start)
    if cfg.parallel_block:
        return x + y + L.mlp_full(p["ffn"], cfg, h), pages
    return _ffn_extend_tail(p, cfg, pos, x + y), pages


def forward_extend_paged(params, cfg, x, pages, page_table, start
                         ) -> Tuple[torch.Tensor, Pytree]:
    """Chunked prefill against the page pool: x [B, C, d] new embedded
    tokens from absolute start position(s) ``start`` ([B]); pages and
    page_table as in forward_step_paged. Returns (hidden [B, C, d],
    pages)."""
    plan = layer_plan(cfg)
    for g in range(cfg.n_groups):
        for j, pos in enumerate(plan):
            gp = _group(params[f"p{j}"], g)
            x, _ = _pos_extend_paged(gp, cfg, pos, x,
                                     pages[f"p{j}"][f"g{g}"], page_table,
                                     start)
    return x, pages
