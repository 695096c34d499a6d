"""The decoder stack (counterpart of the JAX package's
``models/transformer.py``): the dense entry points (full sequence,
one-token step, chunk extension, with sliding windows) for every layer
position of the zoo — attention, mamba (``models/mamba.py``) and RWKV-6
(``models/rwkv6.py``) mixers, cross-attention sub-blocks, SwiGLU or MoE
FFNs — and the paged serving ones for attention-only stacks.

Parameters mirror the JAX tree: ``{"p{j}": leaves stacked over
[n_groups, ...]}`` for the per-group layer plan; group g's weights are
the views ``a[g]``, and the reference's scan over groups is a loop. The
dense cache is ``{"p{j}": {leaf: [G, B, ...]}}`` (``cache_specs``:
k / v [G, B, S_c, KH, D], S_c the window for a sliding-window stack: a
ring buffer; ck / cv for cross-attention; a recurrent position's state),
the KV pool ``{"p{j}": {"g{g}": {"k","v"}}}``, one [n_pages, PS, KH, D]
pair per physical layer. Both are updated in place. An FFN is SwiGLU or
MoE: the full forward runs the capacity dispatch (``layers.moe_full``,
or ``moe_a2a.moe_halfexpert`` on the ambient mesh for the half-expert
layout), the step and chunk forms the dropless routed one (``moe_step``,
``moe_extend``; ``moe_full`` at S = 1 under ``common.ep_decode``), as the
JAX package's.

The paged forwards also serve a tensor-parallel instance: given a
``plan`` (``launch/sharding.py::ShardPlan``), ``params`` and ``pages``
are lists with one tree per shard (``sharding.shard_params`` and
``paged_cache_specs(..., plan=plan)``), and the hidden states and batch
tensors lists with one tensor per shard. The loop over layers is the
same; inside each layer the shard-local math of ``layers.*_tp`` loops
over the shards and all-reduces where the reference's GSPMD would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import mamba as M
from . import rwkv6 as R
from .common import CacheSpec, ep_decode, get_mesh, rms_norm

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


def _check_ported(pos: PosPlan) -> None:
    """The tensor-parallel forms serve attention mixers with SwiGLU or
    MoE FFNs only."""
    if pos.mixer != "attn" or pos.cross or pos.ffn not in ("mlp", "moe"):
        raise NotImplementedError(
            f"layer position {pos}: the tensor-parallel forms serve "
            "attention mixers with SwiGLU or MoE FFNs only")


def cache_specs(cfg, batch: int, seq: int) -> Pytree:
    """The decode cache for (batch, seq) context, every leaf stacked over
    the n_groups axis: attention positions hold k / v [G, B, S_c, KH, D]
    with S_c = min(seq, window or seq) (and, with cross-attention, ck /
    cv [G, B, n_vision_tokens, KH, D]); recurrent positions their O(1)
    state (``mamba.mamba_cache_spec``, ``rwkv6.rwkv_cache_spec``)."""
    dt = getattr(torch, cfg.dtype)
    G = cfg.n_groups
    out = {}

    def stackG(tree):
        return {n: CacheSpec((G,) + s.shape, s.dtype)
                for n, s in tree.items()}

    for j, pos in enumerate(layer_plan(cfg)):
        if pos.mixer == "rwkv":
            out[f"p{j}"] = stackG(R.rwkv_cache_spec(cfg, batch))
            continue
        if pos.mixer == "mamba":
            if pos.cross:
                raise NotImplementedError(
                    f"{cfg.name}: a mamba position with cross-attention")
            out[f"p{j}"] = stackG(M.mamba_cache_spec(cfg, batch))
            continue
        S_c = min(seq, pos.window) if pos.window else seq
        s = CacheSpec((batch, S_c, cfg.n_kv_heads, cfg.head_dim), dt)
        c = {"k": s, "v": s}
        if pos.cross:
            c["ck"] = c["cv"] = CacheSpec(
                (batch, cfg.n_vision_tokens, cfg.n_kv_heads, cfg.head_dim),
                dt)
        out[f"p{j}"] = stackG(c)
    return out


def cache_bytes(cfg, batch: int, seq: int) -> int:
    total = 0
    for c in cache_specs(cfg, batch, seq).values():
        for s in c.values():
            n = s.dtype.itemsize
            for d in s.shape:
                n *= d
            total += n
    return total


def paged_servable(cfg) -> bool:
    """True when every layer position can be served from the KV page
    pool: self-attention mixers only, no cross-attention, no sliding
    window, decoder-only."""
    if cfg.encoder_decoder:
        return False
    return all(p.mixer == "attn" and not p.cross and not p.window
               for p in layer_plan(cfg))


def paged_cache_specs(cfg, n_pages: int, page_size: int,
                      device, plan=None) -> Pytree:
    """Allocate the per-layer KV page pools (zeros): one
    [n_pages, page_size, KH, D] k/v pair per (attention position, group)
    — per physical layer. The pool is instance-wide: requests address it
    through page tables. With a ``plan`` (tensor-parallel instance): one
    such tree per shard, on its device, each leaf the shard's piece
    (``ShardPlan.local_pool_shape``); ``device`` is then unused."""
    if not paged_servable(cfg):
        raise ValueError(f"{cfg.name}: stack is not paged-servable")
    dt = getattr(torch, cfg.dtype)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if plan is not None:
        shape = plan.local_pool_shape(shape)
        return [_pool_tree(cfg, shape, dt, d) for d in plan.devices]
    return _pool_tree(cfg, shape, dt, device)


def _pool_tree(cfg, shape, dt, device) -> Pytree:
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
    """norm2 + FFN after the mixer residual, single-token lanes — shared
    by the dense and paged step paths. MoE: the routed ``moe_step``, or
    under ``ep_decode`` the capacity dispatch at S = 1 (cap = K: exact,
    dropless)."""
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if pos.ffn == "moe":
        if ep_decode():
            return x + L.moe_full(p["ffn"], cfg, h2[:, None])[:, 0]
        return x + L.moe_step(p["ffn"], cfg, h2)
    return x + _mlp_step(p["ffn"], x.dtype, h2)


def _ffn_extend_tail(p, cfg, pos: PosPlan, x):
    """norm2 + FFN over a chunk (MoE dropless: a chunk equals the full
    sequence)."""
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if pos.ffn == "moe":
        return x + L.moe_extend(p["ffn"], cfg, h2)
    return x + L.mlp_full(p["ffn"], cfg, h2)


def _ffn_full_tail(p, cfg, pos: PosPlan, x):
    """norm2 + FFN over a full sequence: MoE takes the capacity dispatch
    (``moe_full``), or the half-expert path on the ambient mesh."""
    if pos.ffn != "moe":
        return _ffn_extend_tail(p, cfg, pos, x)
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.moe_impl == "halfexpert":
        from .moe_a2a import moe_halfexpert
        mesh = get_mesh()
        if mesh is None:
            raise ValueError(f"{cfg.name}: the half-expert MoE runs on a "
                             "mesh (models.common.set_mesh)")
        return x + moe_halfexpert(p["ffn"], cfg, h2, mesh)
    return x + L.moe_full(p["ffn"], cfg, h2)


# ---------------------------------------------------------------------
# dense forwards: full sequence, one-token step, chunk extension
# ---------------------------------------------------------------------

def _ring(a: torch.Tensor, W: int) -> torch.Tensor:
    """The last W positions of a [B, S, KH, D] cache, ring-aligned:
    token t lands at slot t % W."""
    S = a.shape[1]
    return torch.roll(a[:, S - W:], (S - W) % W, dims=1)


def _rwkv(p, cfg, x, cache, full: bool):
    """An RWKV position: time-mix then channel-mix, each with its
    residual. ``full``: the chunked forms (``cache`` None or resumed and
    updated in place), else the one-token steps. Returns (x, cache)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    tc = cache and {"state": cache["state"], "shift": cache["shift"]}
    cc = cache and {"shift_c": cache["shift_c"]}
    if full:
        y, tc = R.rwkv_time_full(p["time"], cfg, h, cache=tc)
    else:
        y, tc = R.rwkv_time_step(p["time"], cfg, h, tc)
    x = x + y
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if full:
        y2, cc = R.rwkv_channel_full(p["channel"], cfg, h2, cache=cc)
    else:
        y2, cc = R.rwkv_channel_step(p["channel"], cfg, h2, cc)
    return x + y2, {**tc, **cc}


def _mamba_views(cache):
    return cache and {"conv": cache["conv"], "ssm": cache["ssm"]}


def _pos_full(p, cfg, pos: PosPlan, x, kv_src, want_cache: bool,
              attn_impl: str, in_cache=None, causal: bool = True):
    """One layer position, full sequence; ``in_cache`` resumes a
    recurrent position (its views are updated in place). Returns (x,
    cache | {})."""
    if pos.mixer == "rwkv":
        x, c = _rwkv(p, cfg, x, in_cache, True)
        return x, (c if want_cache else {})
    cache: Dict[str, torch.Tensor] = {}
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if pos.mixer == "attn":
        y, kv = L.attn_full(p["attn"], cfg, h, causal=causal,
                            window=pos.window, impl=attn_impl,
                            return_cache=want_cache)
        if want_cache:
            W = pos.window
            if W and W < kv["k"].shape[1]:
                kv = {n: _ring(a, W) for n, a in kv.items()}
            cache.update(kv)
    else:
        y, c = M.mamba_full(p["mamba"], cfg, h, cache=_mamba_views(in_cache))
        cache.update(c)
    if cfg.parallel_block:
        x = x + y + L.mlp_full(p["ffn"], cfg, h)
        return x, (cache if want_cache else {})
    x = x + y
    if pos.cross:
        hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        yc, ckv = L.cross_attn_full(p["cross"], cfg, hc, kv_src,
                                    impl=attn_impl)
        x = x + yc
        cache["ck"], cache["cv"] = ckv["k"], ckv["v"]
    return (_ffn_full_tail(p, cfg, pos, x),
            cache if want_cache else {})


def forward_full(params, cfg, x, *, kv_src=None, want_cache: bool = False,
                 attn_impl: str = "auto", remat: bool = False,
                 in_cache=None, causal: bool = True
                 ) -> Tuple[torch.Tensor, Optional[Pytree]]:
    """x: [B, S, d] embedded inputs -> (hidden [B, S, d], cache | None);
    the cache's leaves are stacked over groups ([G, B, ...]).
    ``kv_src``: [B, Skv, d] cross-attention source (vision or encoder
    states). ``in_cache``: continue the recurrent positions from a
    previous state (mamba / RWKV chunked prefill; its leaves are updated
    in place); attention positions do not resume this way.

    ``remat``: each group runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of the group body): autograd keeps
    only the group's input and recomputes the group in the backward
    pass. A recomputed group would read a recurrent state that its first
    run already wrote into ``in_cache``, so remat takes neither
    ``in_cache`` nor ``want_cache`` (ValueError); the loss passes
    neither."""
    if remat and (in_cache is not None or want_cache):
        raise ValueError("remat recomputes each group in the backward "
                         "pass; it takes no in_cache and no want_cache")
    plan = layer_plan(cfg)
    caches: Dict[str, List[Dict[str, torch.Tensor]]] = {
        f"p{j}": [] for j in range(len(plan))}

    def group(g, x):
        cs = []
        for j, pos in enumerate(plan):
            pj = f"p{j}"
            x, c = _pos_full(_group(params[pj], g), cfg, pos, x, kv_src,
                             want_cache, attn_impl,
                             in_cache=(_group_cache(in_cache, pj, g)
                                       if in_cache is not None else None),
                             causal=causal)
            cs.append(c)
        return x, cs

    for g in range(cfg.n_groups):
        if remat:
            # the forward draws no random numbers: no RNG state to keep
            x = checkpoint(lambda x, g=g: group(g, x)[0], x,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        x, cs = group(g, x)
        for j, c in enumerate(cs):
            caches[f"p{j}"].append(c)
    if not want_cache:
        return x, None
    return x, {pj: {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
               for pj, cs in caches.items()}


def _pos_step(p, cfg, pos: PosPlan, x, cache, position):
    if pos.mixer == "rwkv":
        return _rwkv(p, cfg, x, cache, False)[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if pos.mixer == "attn":
        y, _ = L.attn_step(p["attn"], cfg, h,
                           {"k": cache["k"], "v": cache["v"]}, position,
                           window=pos.window)
    else:
        y, _ = M.mamba_step(p["mamba"], cfg, h, _mamba_views(cache))
    if cfg.parallel_block:
        return x + y + _mlp_step(p["ffn"], x.dtype, h)
    x = x + y
    if pos.cross:
        hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        yc, _ = L.cross_attn_step(p["cross"], cfg, hc,
                                  {"k": cache["ck"], "v": cache["cv"]})
        x = x + yc
    return _ffn_step_tail(p, cfg, pos, x)


def _group_cache(cache, pj: str, g: int) -> Dict[str, torch.Tensor]:
    """Group g's views of every leaf of a dense cache position."""
    return {n: a[g] for n, a in cache[pj].items()}


def forward_step(params, cfg, x, cache, position
                 ) -> Tuple[torch.Tensor, Pytree]:
    """x: [B, d] one embedded token per lane; cache from forward_full /
    cache_specs, updated in place; ``position`` the context length so
    far (an int or a [B] tensor). Returns (hidden [B, d], cache)."""
    plan = layer_plan(cfg)
    for g in range(cfg.n_groups):
        for j, pos in enumerate(plan):
            x = _pos_step(_group(params[f"p{j}"], g), cfg, pos, x,
                          _group_cache(cache, f"p{j}", g), position)
    return x, cache


def _pos_extend(p, cfg, pos: PosPlan, x, cache, start):
    """One layer position over a chunk against a linear cache; a sliding
    window is a mask here (the engine's buffers hold its max context).
    Recurrent positions resume from their state, cross-attention attends
    the fixed cross KV."""
    if pos.mixer == "rwkv":
        return _rwkv(p, cfg, x, cache, True)[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if pos.mixer == "attn":
        y, _ = L.attn_extend(p["attn"], cfg, h,
                             {"k": cache["k"], "v": cache["v"]}, start,
                             window=pos.window)
    else:
        y, _ = M.mamba_full(p["mamba"], cfg, h, cache=_mamba_views(cache))
    if cfg.parallel_block:
        return x + y + L.mlp_full(p["ffn"], cfg, h)
    x = x + y
    if pos.cross:
        hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        yc, _ = L.cross_attn_extend(p["cross"], cfg, hc,
                                    {"k": cache["ck"], "v": cache["cv"]})
        x = x + yc
    return _ffn_extend_tail(p, cfg, pos, x)


def forward_extend(params, cfg, x, cache, start
                   ) -> Tuple[torch.Tensor, Pytree]:
    """Chunked prefill: x [B, C, d] new embedded tokens from absolute
    position(s) ``start`` (an int or a [B] tensor); the cache's buffers
    are linear and must hold start + C positions (the engine's hold its
    max context). Returns (hidden [B, C, d], cache), updated in place."""
    plan = layer_plan(cfg)
    for g in range(cfg.n_groups):
        for j, pos in enumerate(plan):
            x = _pos_extend(_group(params[f"p{j}"], g), cfg, pos, x,
                            _group_cache(cache, f"p{j}", g), start)
    return x, cache


def seed_cross_cache(params, cfg, kv_src, cache) -> Pytree:
    """Project ``kv_src`` [B, Skv, d] through every cross-attention
    position's wk / wv into the cache's ck / cv, in place (a VLM
    request's admission: the vision tokens arrive once, before its text
    chunks). Returns the cache."""
    for j, pos in enumerate(layer_plan(cfg)):
        if not pos.cross:
            continue
        c = cache[f"p{j}"]
        for g in range(cfg.n_groups):
            p = _group(params[f"p{j}"], g)["cross"]
            c["ck"][g].copy_(torch.einsum("...d,dhk->...hk", kv_src,
                                          p["wk"]))
            c["cv"][g].copy_(torch.einsum("...d,dhk->...hk", kv_src,
                                          p["wv"]))
    return cache


# ---------------------------------------------------------------------
# paged forwards
# ---------------------------------------------------------------------

def _pos_step_paged(p, cfg, pos: PosPlan, x, pages, page_table, position):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    y, pages = L.attn_step_paged(p["attn"], cfg, h, pages, page_table,
                                 position)
    if cfg.parallel_block:
        return x + y + _mlp_step(p["ffn"], x.dtype, h), pages
    return _ffn_step_tail(p, cfg, pos, x + y), pages


def forward_step_paged(params, cfg, x, pages, page_table, position,
                       plan=None) -> Tuple[torch.Tensor, Pytree]:
    """x: [B, d] one embedded token per lane; ``pages`` the instance-wide
    pool (updated in place); page_table [B, P]; position [B] context
    lengths. Returns (hidden [B, d], pages). With a shard ``plan``:
    per-shard lists (module doc)."""
    if plan is not None:
        return _forward_tp(params, cfg, pages, plan, "step", x, None,
                           page_table, position)
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
                        chunk_start, chunk_len, dec_table, dec_pos,
                        plan=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Pytree]:
    """Fused ragged iteration: every query token of the scheduling step
    in one forward. ``xc`` [Lc, C, d] embeds the prefill chunks padded to
    C (lane l: chunk_len[l] real tokens from chunk_start[l]); ``xd``
    [Ld, d] embeds the decode lanes (fed token at dec_pos[l]). Padding
    lanes carry all-scratch table rows. Returns (hidden_c [Lc, C, d],
    hidden_d [Ld, d], pages). With a shard ``plan``: per-shard lists
    (module doc)."""
    if plan is not None:
        (xc, xd), pages = _forward_tp(
            params, cfg, pages, plan, "mixed", xc, xd, chunk_table,
            chunk_start, chunk_len, dec_table, dec_pos)
        return xc, xd, pages
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


def forward_extend_paged(params, cfg, x, pages, page_table, start,
                         plan=None) -> Tuple[torch.Tensor, Pytree]:
    """Chunked prefill against the page pool: x [B, C, d] new embedded
    tokens from absolute start position(s) ``start`` ([B]); pages and
    page_table as in forward_step_paged. Returns (hidden [B, C, d],
    pages). With a shard ``plan``: per-shard lists (module doc)."""
    if plan is not None:
        return _forward_tp(params, cfg, pages, plan, "extend", x, None,
                           page_table, start)
    plan = layer_plan(cfg)
    for g in range(cfg.n_groups):
        for j, pos in enumerate(plan):
            gp = _group(params[f"p{j}"], g)
            x, _ = _pos_extend_paged(gp, cfg, pos, x,
                                     pages[f"p{j}"][f"g{g}"], page_table,
                                     start)
    return x, pages


# ---------------------------------------------------------------------
# tensor-parallel paged forwards
# ---------------------------------------------------------------------

def _norm_tp(ps, key: str, xs, eps):
    return [rms_norm(x, p[key], eps) for p, x in zip(ps, xs)]


def _add(*lists):
    return [sum(xs[1:], xs[0]) for xs in zip(*lists)]


def _ffn_tp(ps, cfg, pos: PosPlan, xs, hs, plan, step: bool):
    """The FFN half of one position on every shard: x + y + mlp(h) for a
    parallel block (``hs`` the norm1 outputs, xs already x + y), else
    x + ffn(norm2(x)), the MoE in its shard-local dropless form (what
    ``moe_step``, ``moe_extend`` and ``moe_full`` at S = 1 compute)."""
    fs = [p["ffn"] for p in ps]
    if cfg.parallel_block:
        return _add(xs, L.mlp_tp(fs, cfg, hs, plan, step))
    h2 = _norm_tp(ps, "norm2", xs, cfg.norm_eps)
    if pos.ffn == "moe":
        return _add(xs, L.moe_tp(fs, cfg, h2, plan))
    return _add(xs, L.mlp_tp(fs, cfg, h2, plan, step))


def _forward_tp(params, cfg, pages, plan, kind: str, x, xd, table, *rest):
    """The paged forwards on a shard plan. ``kind``: "step" (x [B, d],
    rest = (position,)), "extend" (x [B, C, d], rest = (start,)) or
    "mixed" (x = xc, xd, table = chunk_table, rest = (chunk_start,
    chunk_len, dec_table, dec_pos)). Returns (hidden, pages), hidden a
    per-shard list or, for "mixed", the pair (hc, hd)."""
    eps = cfg.norm_eps
    for g in range(cfg.n_groups):
        for j, pos in enumerate(layer_plan(cfg)):
            _check_ported(pos)
            ps = [_group(p[f"p{j}"], g) for p in params]
            pg = [p[f"p{j}"][f"g{g}"] for p in pages]
            attn = [p["attn"] for p in ps]
            h = _norm_tp(ps, "norm1", x, eps)
            if kind == "mixed":
                hd = _norm_tp(ps, "norm1", xd, eps)
                yc, yd, _ = L.attn_mixed_paged_tp(attn, cfg, h, hd, pg,
                                                  table, *rest, plan)
                x = _ffn_tp(ps, cfg, pos, _add(x, yc), h, plan, False)
                xd = _ffn_tp(ps, cfg, pos, _add(xd, yd), hd, plan, True)
                continue
            if kind == "step":
                y, _ = L.attn_step_paged_tp(attn, cfg, h, pg, table,
                                            rest[0], plan)
            else:
                y, _ = L.attn_extend_paged_tp(attn, cfg, h, pg, table,
                                              rest[0], plan)
            x = _ffn_tp(ps, cfg, pos, _add(x, y), h, plan,
                        kind == "step")
    return ((x, xd) if kind == "mixed" else x), pages
