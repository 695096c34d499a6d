"""Layer forwards (counterpart of the JAX package's ``models/layers.py``):
the dense forms (full sequence, one-token step against a per-request
cache, chunk extension) of self- and cross-attention, and the paged
serving forms.

Shapes follow the JAX package: x is [B, S, d] for full sequences, [B, d]
for one-token steps and [B, C, d] for chunks; projection weights are
head-factored ([d, H, Dh], [H, Dh, d]). Caches — the dense
{"k","v": [B, S, KH, D]} and the KV page pool {"k","v": [n_pages, PS,
KH, D]} — are updated IN PLACE with ``index_put_`` where the JAX code
writes a new buffer with ``.at[].set`` / ``dynamic_update_slice`` and
donates the old one: the functions return the same dict they were
given, already holding this step's KV.

Page-table lookups clamp the page index to the table's width, as JAX's
gathers clamp out-of-range indices; every such lookup is for a padded
token whose write is redirected to the scratch page 0 or whose output
is dropped.

The ``*_tp`` forms are the shard-local math of a tensor-parallel
instance (``launch/sharding.py::ShardPlan``): every argument that is a
list holds one tensor (or tree) per shard, on its shard's device, and
each collective the reference's GSPMD inserts is an explicit call of
``launch/mesh.py``:
  * embedding: ``tok`` split along the vocab; each shard looks up the
    ids of its range, writes zeros for the others, and the parts are
    all-reduced (exact);
  * attention: q heads split when tp divides H, kv heads when it divides
    KH (then the pool is head-wise), else replicated; ``wo`` split on
    heads is row-parallel, its partial products all-reduced; with heads
    replicated every shard computes the whole attention, no reduce;
  * FFN: ``wg``/``wu`` column-parallel on ff, ``wd`` row-parallel with an
    all-reduce; norms replicated;
  * MoE FFN: the router replicated (every shard routes alike); experts
    split whole over the shards when tp divides E ("experts" on
    "model": each shard computes the tokens routed to its own experts),
    else every expert's ff columns split ("expert_ff"); either way the
    shards' partial outputs are all-reduced;
  * LM head: split along the vocab; each shard's (max, index) pair is
    gathered and the lowest index among equal maxima kept, as argmax
    keeps it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..analysis import counting
from ..launch import mesh as M
from .attention import attention, decode_attention, extend_attention, \
    mixed_paged_attention, mixed_paged_attention_tp, paged_attention, \
    paged_attention_tp
from .common import rope

Pages = Dict[str, torch.Tensor]


def _project_qkv(p, cfg, x):
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    k = torch.einsum("...d,dhk->...hk", x, p["wk"])
    v = torch.einsum("...d,dhk->...hk", x, p["wv"])
    return q, k, v


def _on(v, device) -> torch.Tensor:
    """An int or a tensor as a tensor on ``device``; an int is filled in
    there, with no host-to-device copy (which would wait for the
    device at every layer)."""
    if isinstance(v, int):
        return torch.full((), v, device=device)
    return torch.as_tensor(v, device=device)


def attn_full(p, cfg, x, *, causal: bool = True, positions=None,
              window: int = 0, impl: str = "auto",
              return_cache: bool = True):
    """Full-sequence self-attention: x [B, S, d]. Returns (y, {"k","v"}
    [B, S, KH, D] | None)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if not cfg.attention_free and cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=window, impl=impl)
    y = torch.einsum("...hk,hkd->...d", o, p["wo"])
    return y, ({"k": k, "v": v} if return_cache else None)


def cross_attn_full(p, cfg, x, kv_src, *, impl: str = "auto"):
    """Cross-attention over a full sequence: queries from x [B, S, d],
    keys and values projected from kv_src [B, Skv, d]; no RoPE, not
    causal. Returns (y, {"k","v"} [B, Skv, KH, D])."""
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    k = torch.einsum("...d,dhk->...hk", kv_src, p["wk"])
    v = torch.einsum("...d,dhk->...hk", kv_src, p["wv"])
    o = attention(q, k, v, causal=False, impl=impl)
    return torch.einsum("...hk,hkd->...d", o, p["wo"]), {"k": k, "v": v}


def cross_attn_extend(p, cfg, x, cache):
    """A prefill chunk x [B, C, d] against the fixed cross KV {"k","v"}
    [B, Skv, KH, D] (naive attention, as the reference's). Returns
    (y [B, C, d], cache)."""
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    o = attention(q, cache["k"], cache["v"], causal=False, impl="naive")
    return torch.einsum("...hk,hkd->...d", o, p["wo"]), cache


def cross_attn_step(p, cfg, x, cache):
    """One token a lane x [B, d] against the fixed cross KV: every one of
    the Skv positions is valid, so the call reaches the split-K decode
    kernel (``attention.decode_attention``) with lens Skv. Returns
    (y [B, d], cache)."""
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    o = decode_attention(q, cache["k"], cache["v"],
                         _on(cache["k"].shape[1], x.device))
    return torch.einsum("bhk,hkd->bd", o, p["wo"]), cache


def attn_step(p, cfg, x, cache, pos, *, window: int = 0):
    """Decode one token per lane: x [B, d]; cache {"k","v"} [B, S, KH, D]
    (S == window for a ring buffer); ``pos`` the context length so far,
    an int or a [B] tensor. The new KV lands at ring slot pos % S, and
    attention masks to cache_len = min(pos + 1, S, window): once the
    ring has wrapped every slot holds a token inside the window, so the
    length alone masks it, and the call reaches the split-K decode kernel
    (``attention.decode_attention``). Returns (y [B, d], cache)."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    q, k, v = _project_qkv(p, cfg, x)
    pos = _on(pos, x.device)
    posb = pos.expand(B)
    if cfg.rope_theta:
        q = rope(q[:, None], posb[:, None], cfg.rope_theta)[:, 0]
        k = rope(k[:, None], posb[:, None], cfg.rope_theta)[:, 0]
    _write_kv(cache, torch.arange(B, device=x.device), posb % S, k, v)
    cache_len = torch.clamp(pos + 1, max=S)
    if window and window < S:
        cache_len = torch.clamp(pos + 1, max=window)
    o = decode_attention(q, cache["k"], cache["v"], cache_len)
    y = torch.einsum("bhk,hkd->bd", o, p["wo"])
    return y, cache


def _linear_end(start, C: int) -> int:
    """The end of a chunk's linear write: the largest start + C (an int
    ``start`` costs no device read)."""
    if isinstance(start, int):
        return start + C
    return int(torch.as_tensor(start).max()) + C


def attn_extend(p, cfg, x, cache, start, *, window: int = 0):
    """Chunked-prefill extension: x [B, C, d] new tokens from absolute
    position ``start`` (an int or a [B] tensor) against a linear (not
    ring) cache {"k","v"} [B, S, KH, D] whose first ``start`` positions
    are valid. A write past the cache's end raises ValueError (the
    reference's ``dynamic_update_slice`` would move it back into range).
    Returns (y [B, C, d], cache)."""
    B, C, _ = x.shape
    S = cache["k"].shape[1]
    if _linear_end(start, C) > S:
        raise ValueError(f"extend: positions up to {_linear_end(start, C)} "
                         f"do not fit a {S}-position cache")
    q, k, v = _project_qkv(p, cfg, x)
    startt = _on(start, x.device)
    positions = (startt.reshape(-1, 1)
                 + torch.arange(C, device=x.device)[None, :])  # [B|1, C]
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    _write_kv(cache, torch.arange(B, device=x.device)[:, None],
              positions.expand(B, C), k, v)
    o = extend_attention(q, cache["k"], cache["v"], startt, startt + C,
                         window=window)
    y = torch.einsum("...hk,hkd->...d", o, p["wo"])
    return y, cache


def _table_lookup(table, rows, pos, page_size):
    """table[rows, pos // page_size] with the page index clamped to the
    table's width (JAX gather semantics)."""
    col = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"),
                      max=table.shape[1] - 1)
    return table[rows, col]


def _write_kv(pages: Pages, pids, offs, k, v) -> None:
    """Scatter new K/V rows into a pool (pids: pages) or a dense cache
    (pids: batch lanes) in place."""
    idx = (pids.long(), offs.long())
    pages["k"].index_put_(idx, k.to(pages["k"].dtype))
    pages["v"].index_put_(idx, v.to(pages["v"].dtype))


def attn_step_paged(p, cfg, x, pages: Pages, page_table, pos
                    ) -> Tuple[torch.Tensor, Pages]:
    """Decode one token per lane against the shared page pool. x [B, d];
    page_table [B, P]; pos [B] (the fed token's absolute position). The
    new KV lands in page page_table[b, pos // PS] at slot pos % PS (rows
    of different lanes are distinct: shared pages are copied before a
    sequence may write). Returns (y [B, d], pages)."""
    B = x.shape[0]
    PS = pages["k"].shape[1]
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.rope_theta:
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    bidx = torch.arange(B, device=x.device)
    pids = _table_lookup(page_table, bidx, pos, PS)
    _write_kv(pages, pids, pos % PS, k, v)
    o = paged_attention(q, pages["k"], pages["v"], page_table, pos + 1)
    y = torch.einsum("bhk,hkd->bd", o, p["wo"])
    return y, pages


def attn_mixed_paged(p, cfg, xc, xd, pages: Pages, chunk_table, chunk_start,
                     chunk_len, dec_table, dec_pos):
    """Fused ragged iteration against the page pool: xc [Lc, C, d] packs
    the prefill chunks padded to C (lane l: chunk_len[l] real tokens from
    position chunk_start[l]); xd [Ld, d] packs the decode lanes (fed
    token at dec_pos[l]). KV of both halves is scattered before either
    half attends. Chunk-pad tokens write the scratch page 0. Returns
    (yc [Lc, C, d], yd [Ld, d], pages)."""
    Lc, C, _ = xc.shape
    Ld = xd.shape[0]
    PS = pages["k"].shape[1]
    dev = xc.device
    qc, kc, vc = _project_qkv(p, cfg, xc)
    qd, kd, vd = _project_qkv(p, cfg, xd)
    cpos = chunk_start[:, None] + torch.arange(C, device=dev)[None, :]
    if cfg.rope_theta:
        qc = rope(qc, cpos, cfg.rope_theta)
        kc = rope(kc, cpos, cfg.rope_theta)
        qd = rope(qd[:, None], dec_pos[:, None], cfg.rope_theta)[:, 0]
        kd = rope(kd[:, None], dec_pos[:, None], cfg.rope_theta)[:, 0]
    valid = torch.arange(C, device=dev)[None, :] < chunk_len[:, None]
    lidx = torch.arange(Lc, device=dev)[:, None]
    zero = torch.zeros((), dtype=cpos.dtype, device=dev)
    cpids = torch.where(valid, _table_lookup(chunk_table, lidx, cpos, PS),
                        zero)
    coffs = torch.where(valid, cpos % PS, zero)
    dpids = _table_lookup(dec_table, torch.arange(Ld, device=dev), dec_pos,
                          PS)
    _write_kv(pages, cpids, coffs, kc, vc)
    _write_kv(pages, dpids, dec_pos % PS, kd, vd)
    oc, od = mixed_paged_attention(qc, qd, pages["k"], pages["v"],
                                   chunk_table, chunk_start, dec_table,
                                   dec_pos)
    yc = torch.einsum("...hk,hkd->...d", oc, p["wo"])
    yd = torch.einsum("bhk,hkd->bd", od, p["wo"])
    return yc, yd, pages


def attn_extend_paged(p, cfg, x, pages: Pages, page_table, start):
    """Chunked-prefill extension against the page pool: x [B, C, d] new
    tokens from absolute position ``start`` ([B] tensor); the chunk's KV
    is scattered into the table's pages, then the chunk attends to the
    gathered table rows. Returns (y [B, C, d], pages)."""
    B, C, _ = x.shape
    _, PS, KH, D = pages["k"].shape
    P = page_table.shape[1]
    dev = x.device
    q, k, v = _project_qkv(p, cfg, x)
    positions = start[:, None] + torch.arange(C, device=dev)[None, :]
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    bidx = torch.arange(B, device=dev)[:, None]
    pids = _table_lookup(page_table, bidx, positions, PS)
    _write_kv(pages, pids, positions % PS, k, v)
    idx = page_table.long()
    kc = pages["k"][idx].reshape(B, P * PS, KH, D)
    vc = pages["v"][idx].reshape(B, P * PS, KH, D)
    o = extend_attention(q, kc, vc, start, start + C)
    y = torch.einsum("...hk,hkd->...d", o, p["wo"])
    return y, pages


def mlp_full(p, cfg, x):
    g = F.silu(torch.einsum("...d,df->...f", x, p["wg"]).float())
    u = torch.einsum("...d,df->...f", x, p["wu"]).float()
    return torch.einsum("...f,fd->...d", (g * u).to(x.dtype), p["wd"])


# ---------------------------------------------------------------------
# MoE FFN (top-k router; capacity dispatch and dropless routed forms)
# ---------------------------------------------------------------------

# What the routed forms cost: ``calls`` routed calls (one per MoE layer
# and token group), ``host_syncs`` device-to-host reads (one a call: the
# per-expert pair counts that size its products) and ``expert_products``
# (one SwiGLU product per expert hit). Reset and read by chip_smoke.py.
MOE_STATS = {"calls": 0, "host_syncs": 0, "expert_products": 0}
# Where each routed call's host sync is recorded as a "moe.sync" span:
# ``Telemetry.span``, set by a telemetered engine for the length of its
# model dispatch, else None.
MOE_SPAN_SINK: Optional[Callable[[str, float], float]] = None


def _route(p, cfg, x):
    """Router softmax in float32, top-k, renormalised with a 1e-9 floor:
    x [..., d] -> (topw [..., K] float32, tope [..., K] int64)."""
    logits = x.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(gates, cfg.experts_per_token, dim=-1)
    return topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9), tope


def _expert_ffn(x, wg, wu, wd):
    g = F.silu((x @ wg).float())
    u = (x @ wu).float()
    return (g * u).to(x.dtype) @ wd


def _standard_layout(cfg) -> None:
    if cfg.moe_impl != "standard":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl {cfg.moe_impl!r} serves only the full "
            "forward (moe_a2a.moe_halfexpert); the routed forms take the "
            "standard [E, d, f] experts")


def moe_full(p, cfg, x):
    """Capacity-based top-k dispatch with per-sequence capacity groups:
    x [B, S, d] -> [B, S, d]. Each (sequence, expert) has cap =
    max(int(capacity_factor * S * K / E), K) slots, filled in the
    (s, k)-flattened order; overflow pairs are dropped (their zero rows
    land in slot cap - 1, their combine weight is 0). Every expert runs
    on its [B, cap] slots."""
    _standard_layout(cfg)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    topw, tope = _route(p, cfg, x)                                # [B, S, K]
    cap = max(int(cfg.capacity_factor * S * K / E), K)
    flat = F.one_hot(tope, E).reshape(B, S * K, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1)    # [B, S*K]
    keep = pos < cap
    weight = topw.reshape(B, S * K) * keep
    e_idx = tope.reshape(B, S * K)
    c_idx = torch.clamp(pos, max=cap - 1)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    src = torch.repeat_interleave(x, K, dim=1) * keep[..., None].to(x.dtype)
    disp = torch.zeros((B, E, cap, d), dtype=x.dtype, device=x.device)
    disp.index_put_((bidx, e_idx, c_idx), src, accumulate=True)
    g = F.silu(torch.einsum("becd,edf->becf", disp, p["wg"]).float())
    u = torch.einsum("becd,edf->becf", disp, p["wu"]).float()
    eo = torch.einsum("becf,efd->becd", (g * u).to(x.dtype), p["wd"])
    out = eo[bidx, e_idx, c_idx] * weight[..., None].to(x.dtype)
    return out.reshape(B, S, K, d).sum(2).to(x.dtype)


def _routed(p, cfg, x, first: int = 0):
    """Dropless top-k MoE of tokens x [T, d] through the experts p holds:
    p["wg"]/["wu"] [E_loc, d, f], p["wd"] [E_loc, f, d], experts first ..
    first + E_loc - 1 (pairs routed elsewhere contribute 0). The (token,
    k) pairs are sorted by expert (stably: (token, k) order within one),
    each expert hit runs one product over its pairs on its own weights,
    and the results go back to their pairs before the gate-weighted sum
    over k. The per-expert pair counts are read on the host (one sync).
    No expert weight is gathered. Returns [T, d].

    Meta tensors have no counts to read: the router runs, the expert
    products are counted by the T x K identity (``counting.routed_cost``;
    min(E, T x K) experts counted as hit; the layer must hold every
    expert) and the output is empty; ``MOE_STATS`` is left alone."""
    topw, tope = _route(p, cfg, x)                                # [T, K]
    T, K = tope.shape
    if x.device.type == "meta":
        e_loc, d, f = p["wg"].shape
        if e_loc != cfg.n_experts:
            raise NotImplementedError("the T x K identity counts a layer "
                                      "that holds every expert")
        if counting.ACTIVE is not None:
            counting.ACTIVE.add_dots(*counting.routed_cost(
                T, K, d, f, min(e_loc, T * K), x.dtype, p["wg"].dtype),
                n=3 * min(e_loc, T * K))
        return x.new_empty((T, x.shape[-1]))
    flat = tope.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sink = MOE_SPAN_SINK
    if sink is not None:
        t0 = time.perf_counter()
    counts = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    if sink is not None:
        sink("moe.sync", t0)
    MOE_STATS["calls"] += 1
    MOE_STATS["host_syncs"] += 1
    tok = torch.div(order, K, rounding_mode="floor")
    out = x.new_zeros((T * K, x.shape[-1]))
    ofs = sum(counts[:first])
    for e in range(p["wg"].shape[0]):
        n = counts[first + e]
        if n:
            rows = order[ofs:ofs + n]
            out.index_copy_(0, rows, _expert_ffn(
                x[tok[ofs:ofs + n]], p["wg"][e], p["wu"][e], p["wd"][e]))
            MOE_STATS["expert_products"] += 1
        ofs += n
    return (out.reshape(T, K, -1) * topw[..., None].to(x.dtype)).sum(1)


def moe_step(p, cfg, x):
    """Dropless top-k MoE of single tokens: x [B, d] -> [B, d]. The same
    function as the JAX package's gather-based ``moe_step`` (each token
    through its K experts, weighted by its renormalised gates), computed
    grouped by expert (``_routed``)."""
    _standard_layout(cfg)
    return _routed(p, cfg, x)


def moe_extend(p, cfg, x):
    """Dropless MoE over a chunk x [B, C, d] (chunked prefill): every
    token routed as by ``moe_step``, so chunked execution cannot diverge
    from one-shot prefill through drops."""
    B, C, d = x.shape
    return moe_step(p, cfg, x.reshape(B * C, d)).reshape(B, C, d)


def embed_tokens(p, cfg, tokens):
    return F.embedding(tokens, p["tok"])


def head_matrix(p, cfg):
    return p["tok"].T if cfg.tie_embeddings else p["head"]


# ---------------------------------------------------------------------
# tensor-parallel (shard-local) forms
# ---------------------------------------------------------------------

def _vocab_range(plan, s: int, v_local: int) -> int:
    """The first vocab id of shard s's slice (0 when not split)."""
    return s * v_local if plan.vocab else 0


def embed_tokens_tp(ps, cfg, tokens, plan):
    """Per-shard embeddings of ``tokens`` (one replicated id tensor per
    shard): each shard's rows of its vocab slice, zeros elsewhere,
    all-reduced when the vocab is split."""
    parts = []
    for s, (p, toks) in enumerate(zip(ps, tokens)):
        tok = p["tok"]
        if not plan.vocab:
            parts.append(F.embedding(toks, tok))
            continue
        ids = toks - _vocab_range(plan, s, tok.shape[0])
        ok = (ids >= 0) & (ids < tok.shape[0])
        e = F.embedding(torch.clamp(ids, 0, tok.shape[0] - 1), tok)
        parts.append(torch.where(ok[..., None], e, torch.zeros_like(e)))
    return M.all_reduce(parts, plan.mesh) if plan.vocab else parts


def top1_logits_tp(hs, ps, cfg, plan) -> torch.Tensor:
    """Greedy next tokens from per-shard (replicated) hidden states
    [..., d] against the vocab-split head: each shard's max logit and its
    global index, gathered in shard order; the first shard holding the
    largest max wins, so equal maxima keep the lowest index. int32 on
    shard 0's device."""
    if not plan.vocab:
        logits = (hs[0] @ head_matrix(ps[0], cfg)).float()
        return torch.argmax(logits, dim=-1).to(torch.int32)
    mx, ix = [], []
    for s, (h, p) in enumerate(zip(hs, ps)):
        w = head_matrix(p, cfg)
        logits = (h @ w).float()
        i = torch.argmax(logits, dim=-1, keepdim=True)
        mx.append(torch.gather(logits, -1, i))
        ix.append(i + _vocab_range(plan, s, w.shape[1]))
    mx = M.gather(mx, -1, plan.mesh)
    ix = M.gather(ix, -1, plan.mesh)
    best = torch.argmax(mx, dim=-1, keepdim=True)
    return torch.gather(ix, -1, best)[..., 0].to(torch.int32)


def _reduce_if(parts, split: bool, plan):
    return M.all_reduce(parts, plan.mesh) if split else parts


def mlp_tp(ps, cfg, hs, plan, step: bool = False):
    """SwiGLU on every shard (its ff slice when split), all-reduced when
    split. ``step``: the [B, d] form of the step paths."""
    parts = []
    for p, h in zip(ps, hs):
        if step:
            g = F.silu((h @ p["wg"]).float())
            u = (h @ p["wu"]).float()
            parts.append((g * u).to(h.dtype) @ p["wd"])
        else:
            parts.append(mlp_full(p, cfg, h))
    return _reduce_if(parts, plan.ff, plan)


def moe_tp(ps, cfg, hs, plan):
    """The dropless MoE (``moe_step``'s function) on every shard, on
    tokens [..., d]: each shard routes all tokens (the router is
    replicated) and computes the pairs of the experts it holds (whole
    experts when they are split, its ff columns of every expert when the
    ff dim is split); the partial outputs are all-reduced in shard
    order."""
    _standard_layout(cfg)
    parts = []
    for s, (p, h) in enumerate(zip(ps, hs)):
        first = s * p["wg"].shape[0] if plan.experts else 0
        parts.append(_routed(p, cfg, h.reshape(-1, h.shape[-1]), first)
                     .reshape(h.shape))
    return _reduce_if(parts, plan.experts or plan.expert_ff, plan)


def _rope_tp(cfg, q, k, positions):
    """rope of one shard's q and k at ``positions`` (broadcast over
    heads); step inputs [B, H, D] take positions [B]."""
    if not cfg.rope_theta:
        return q, k
    if q.dim() == 3:
        return (rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0],
                rope(k[:, None], positions[:, None], cfg.rope_theta)[:, 0])
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta)


def _write_kv_tp(pages, plan, s: int, pids, offs, k, v) -> None:
    """Scatter shard s's new K/V rows into its pool: its head slice
    (head-wise), the slots it owns at their local slot (slot-wise: other
    tokens go to the scratch page 0), the pages it owns at their local id
    (page-wise), or all of them (replicated). pids/offs: global page ids
    and slots."""
    if plan.pool in ("head", "rep"):
        _write_kv(pages, pids, offs, k, v)
    elif plan.pool == "slot":
        ps_loc = plan.slot_size
        own = torch.div(offs, ps_loc, rounding_mode="floor") == s
        _write_kv(pages, torch.where(own, pids, torch.zeros_like(pids)),
                  offs % ps_loc, k, v)
    else:
        n_loc = plan.pages_per_shard
        own = torch.div(pids, n_loc, rounding_mode="floor") == s
        _write_kv(pages, pids[own] % n_loc, offs[own], k[own], v[own])


def _out_proj_tp(ps, os_, plan, eq: str):
    """Row-parallel ``wo`` (all-reduced) when heads are split, else every
    shard's whole product."""
    parts = [torch.einsum(eq, o, p["wo"]) for p, o in zip(ps, os_)]
    return _reduce_if(parts, plan.heads, plan)


def attn_step_paged_tp(ps, cfg, xs, pages, page_table, pos, plan):
    """``attn_step_paged`` on every shard: xs, pages, page_table and pos
    are per-shard lists. Returns (ys, pages)."""
    qs = []
    for s, (p, x) in enumerate(zip(ps, xs)):
        q, k, v = _project_qkv(p, cfg, x)
        q, k = _rope_tp(cfg, q, k, pos[s])
        PS = plan.page_size
        pids = _table_lookup(page_table[s],
                             torch.arange(x.shape[0], device=x.device),
                             pos[s], PS)
        _write_kv_tp(pages[s], plan, s, pids, pos[s] % PS, k, v)
        qs.append(q)
    os_ = paged_attention_tp(qs, pages, page_table,
                             [p_ + 1 for p_ in pos], plan, cfg.n_heads)
    return _out_proj_tp(ps, os_, plan, "bhk,hkd->bd"), pages


def attn_mixed_paged_tp(ps, cfg, xc, xd, pages, chunk_table, chunk_start,
                        chunk_len, dec_table, dec_pos, plan):
    """``attn_mixed_paged`` on every shard (per-shard lists). Returns
    (ycs, yds, pages)."""
    PS = plan.page_size
    qcs, qds = [], []
    for s, p in enumerate(ps):
        Lc, C, _ = xc[s].shape
        Ld = xd[s].shape[0]
        dev = xc[s].device
        qc, kc, vc = _project_qkv(p, cfg, xc[s])
        qd, kd, vd = _project_qkv(p, cfg, xd[s])
        cpos = chunk_start[s][:, None] + torch.arange(C, device=dev)[None, :]
        qc, kc = _rope_tp(cfg, qc, kc, cpos)
        qd, kd = _rope_tp(cfg, qd, kd, dec_pos[s])
        valid = torch.arange(C, device=dev)[None, :] < chunk_len[s][:, None]
        lidx = torch.arange(Lc, device=dev)[:, None]
        zero = torch.zeros((), dtype=cpos.dtype, device=dev)
        cpids = torch.where(valid, _table_lookup(chunk_table[s], lidx, cpos,
                                                 PS), zero)
        coffs = torch.where(valid, cpos % PS, zero)
        dpids = _table_lookup(dec_table[s], torch.arange(Ld, device=dev),
                              dec_pos[s], PS)
        _write_kv_tp(pages[s], plan, s, cpids, coffs, kc, vc)
        _write_kv_tp(pages[s], plan, s, dpids, dec_pos[s] % PS, kd, vd)
        qcs.append(qc)
        qds.append(qd)
    ocs, ods = mixed_paged_attention_tp(qcs, qds, pages, chunk_table,
                                        chunk_start, dec_table, dec_pos,
                                        plan, cfg.n_heads)
    return (_out_proj_tp(ps, ocs, plan, "...hk,hkd->...d"),
            _out_proj_tp(ps, ods, plan, "bhk,hkd->bd"), pages)


def attn_extend_paged_tp(ps, cfg, xs, pages, page_table, start, plan):
    """``attn_extend_paged`` on every shard: the chunk's KV scattered
    into each shard's pool, then the chunk half of the mixed attention.
    Returns (ys, pages)."""
    PS = plan.page_size
    qs = []
    for s, p in enumerate(ps):
        B, C, _ = xs[s].shape
        dev = xs[s].device
        q, k, v = _project_qkv(p, cfg, xs[s])
        positions = start[s][:, None] + torch.arange(C, device=dev)[None, :]
        q, k = _rope_tp(cfg, q, k, positions)
        pids = _table_lookup(page_table[s],
                             torch.arange(B, device=dev)[:, None], positions,
                             PS)
        _write_kv_tp(pages[s], plan, s, pids, positions % PS, k, v)
        qs.append(q)
    os_, _ = mixed_paged_attention_tp(qs, None, pages, page_table, start,
                                      None, None, plan, cfg.n_heads)
    return _out_proj_tp(ps, os_, plan, "...hk,hkd->...d"), pages
