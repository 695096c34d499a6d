"""Attention forms of the model math (counterpart of the JAX package's
``models/attention.py``).

  naive      — materializes [Sq, Skv] scores; short sequences.
  blockwise  — flash-style online softmax, a loop over KV blocks; score
               memory O(Sq * kv_block).
  banded     — sliding-window attention as a diagonal-band loop: at step
               o every q block attends kv block (qi - o), gathered by
               index; FLOPs ~ S * (window + block).
  decode / extend / paged / mixed paged — the serving forms.

All functions take the JAX package's layouts: q [B, Sq, H, D], k/v
[B, Skv, KH, D] for the dense forms, the page pool [n_pages, PS, KH, D]
for the paged ones, with GQA group G = H // KH. Scores are float32 and
masked with NEG_INF, as in the reference.

The ``*_tp`` forms serve the paged pool of a tensor-parallel instance on
each arm of ``launch/sharding.py::pool_pspec`` (per-shard lists, one
entry per shard):
  * head-wise: each shard runs the paged kernel on its KH/tp kv heads
    and its H/tp q heads;
  * slot-wise: each shard holds PS/tp slots of every page; read as pages
    of PS/tp slots, a lane's valid tokens on shard s are a prefix of its
    own pages (``slot_lens``). Every shard runs the paged kernel as a
    partials launch for all H q heads (gathered when split), the partials
    are concatenated along the split axis on shard 0 and ONE launch of
    the kernels' ``lse_merge_kernel`` merges splits and shards together.
    An empty shard (len 0: every padding lane's shard but shard 0)
    writes m -inf, l 0 and weighs nothing. The chunk half gathers the
    slot shards of its table rows;
  * page-wise and replicated: the pool is gathered into a replicated
    view inside the dispatch and each shard attends its own q heads.
A shard whose q heads are split while the kv heads are replicated reads,
for its local head j (global head s * H/tp + j), kv head
(s * H/tp + j) // G (``kv_heads_for``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.decode_attention import decode_attention as _split_k_decode
from ..kernels.paged_attention import (lse_merge_partials,
                                       paged_decode_attention,
                                       paged_decode_partials)
from ..launch import mesh as M

NEG_INF = -1e30


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None):
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (D ** -0.5)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Skv, device=dev)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        mask = mask[None] & (k_pos[None, None, :]
                             < kv_len.to(dev)[:, None, None])
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    else:
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _online_softmax_step(m, l, acc, s, vj, pv_eq, q_dtype):
    """One block of the reference's online softmax: s are the block's
    masked f32 scores, vj its values; returns the new (m, l, acc)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    # fully masked rows (m_new == NEG_INF) must not turn into NaNs
    m_safe = torch.clamp(m_new, min=-1e29)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(m - m_safe)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum(pv_eq, p.to(q_dtype), vj).float()
    return m_new, l_new, acc * corr[..., None] + pv


def blockwise_attention(q, k, v, *, causal: bool = True,
                        q_block: int = 512, kv_block: int = 1024,
                        window: int = 0, q_offset: int = 0):
    """Flash-style attention: a loop over KV blocks with an online
    softmax (the reference scans them). GQA repeats the KV heads up to H,
    as the reference does. ``q_block`` is unused, as in the reference."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    if Skv % kv_block:
        pad = kv_block - Skv % kv_block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nkv = k.shape[1] // kv_block
    scale = D ** -0.5
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for j in range(nkv):
        kj = k[:, j * kv_block:(j + 1) * kv_block]
        vj = v[:, j * kv_block:(j + 1) * kv_block]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kj).float() * scale
        k_pos = j * kv_block + torch.arange(kv_block, device=dev)
        mask = (k_pos < Skv)[None, :].expand(Sq, kv_block)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m, l, acc = _online_softmax_step(m, l, acc, s, vj,
                                         "bhqk,bkhd->bhqd", q.dtype)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def banded_attention(q, k, v, *, window: int, q_block: int = 1024,
                     q_offset: int = 0):
    """Sliding-window causal attention as a diagonal-band loop: q is split
    into blocks, and at step o every q block qi attends kv block
    (qi - o). Steps: min(window // block + 2, blocks). Needs q and kv
    aligned (Sq == Skv, q_offset 0): the prefill case."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    if k.shape[1] != S or q_offset != 0:
        raise ValueError("banded attention needs aligned q/kv")
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    blk = min(q_block, S)
    if S % blk:
        raise ValueError(f"seq {S} not divisible by block {blk}")
    nb = S // blk
    qb = q.reshape(B, nb, blk, H, D)
    kb = k.reshape(B, nb, blk, H, D)
    vb = v.reshape(B, nb, blk, H, D)
    scale = D ** -0.5
    dev = q.device
    n_steps = min(window // blk + 2, nb)
    blocks = torch.arange(nb, device=dev)
    pos_in = torch.arange(blk, device=dev)
    q_pos = blocks[:, None] * blk + pos_in[None, :]              # [nb, blk]
    m = torch.full((B, nb, H, blk), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, nb, H, blk), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nb, H, blk, D), dtype=torch.float32, device=dev)
    for o in range(n_steps):
        idx = torch.clamp(blocks - o, min=0)         # kv block per q block
        kj = kb.index_select(1, idx)                 # [B, nb, blk, H, D]
        vj = vb.index_select(1, idx)
        s = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kj).float() * scale
        k_pos = idx[:, None] * blk + pos_in[None, :]             # [nb, blk]
        mask = k_pos[:, None, :] <= q_pos[:, :, None]
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
        mask &= (blocks - o >= 0)[:, None, None]
        s = torch.where(mask[None, :, None], s, NEG_INF)
        m, l, acc = _online_softmax_step(m, l, acc, s, vj,
                                         "bnhqk,bnkhd->bnhqd", q.dtype)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 1, 3, 2, 4).reshape(B, S, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-position decode: q [B, H, D] against caches [B, S, KH, D];
    ``cache_len`` an int or a [B] tensor of valid lengths (the query sits
    at position cache_len - 1).

    Every call without a window narrower than the cache reaches the
    split-K decode kernel (``kernels/decode_attention.py``): the dense
    plane's ``layers.attn_step`` is such a call, since its ring buffer
    needs only ``cache_len``. The kernel reads the caches in place
    through transposed views; on CPU tensors its wrapper takes the plain
    version. A window narrower than the cache masks [cache_len - window,
    cache_len), which is not a prefix, so that call runs the reference's
    plain form."""
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    clen = torch.as_tensor(cache_len, device=q.device)
    if not window or window >= S:
        lens = clen.to(torch.int32).expand(B).contiguous()
        return _split_k_decode(q.contiguous(), k_cache.transpose(1, 2),
                               v_cache.transpose(1, 2), lens)
    qg = q.reshape(B, KH, H // KH, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * (D ** -0.5)
    k_pos = torch.arange(S, device=q.device)
    if clen.dim() == 0:
        mask = ((k_pos < clen) & (k_pos >= clen - window))[None, None, None]
    else:
        mask = ((k_pos[None, :] < clen[:, None])
                & (k_pos[None, :] >= clen[:, None] - window))[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w.to(q.dtype), v_cache)
    return out.reshape(B, H, D)


def paged_attention(q, k_pages, v_pages, page_table, lens):
    """Decode attention over the shared KV page pool: q [B, H, D];
    k/v_pages [n_pages, PS, KH, D]; page_table [B, P] int32; lens [B]
    valid token counts. Returns [B, H, D]. Runs the Hopper kernel on a
    card and its plain version on the CPU
    (``kernels/paged_attention.py``)."""
    return paged_decode_attention(q, k_pages, v_pages, page_table, lens)


def mixed_paged_attention(qc, qd, k_pages, v_pages, chunk_table,
                          chunk_start, dec_table, dec_pos):
    """Ragged mixed prefill+decode attention over the shared page pool:
    the chunk half qc [Lc, C, H, D] attends its lanes' gathered table
    rows extend-style, the decode half qd [Ld, H, D] runs the paged
    decode kernel masked to dec_pos + 1. Both read the pool after the
    caller scattered this step's KV. Padding lanes carry all-scratch
    (page 0) rows with start/pos 0. Returns (oc [Lc, C, H, D],
    od [Ld, H, D])."""
    _, PS, KH, D = k_pages.shape
    Lc, P = chunk_table.shape
    C = qc.shape[1]
    idx = chunk_table.long()
    kc = k_pages[idx].reshape(Lc, P * PS, KH, D)
    vc = v_pages[idx].reshape(Lc, P * PS, KH, D)
    # kv_len = start + C is safe for padded lanes/tokens: the causal mask
    # already bounds every real query, and padded queries are dropped
    oc = extend_attention(qc, kc, vc, chunk_start, chunk_start + C)
    od = paged_attention(qd, k_pages, v_pages, dec_table, dec_pos + 1)
    return oc, od


def extend_attention(q, k_cache, v_cache, start, kv_len, *, window: int = 0):
    """Chunked-prefill attention: q [B, C, H, D] (first token at absolute
    position ``start``) against caches [B, S, KH, D] that already hold
    the chunk's KV; ``kv_len`` = start + C. ``start``/``kv_len`` are
    ints or [B] tensors. A window lets a query see only the keys in
    (q_pos - window, q_pos]. Materializes [B, H, C, S] scores (short
    engine chunks only)."""
    B, C, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, C, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k_cache.float()) * (D ** -0.5)
    start = torch.as_tensor(start, device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device)
    if start.dim() == 0:
        start = start.expand(B)
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(B)
    q_pos = start[:, None] + torch.arange(C, device=q.device)[None, :]
    k_pos = torch.arange(S, device=q.device)[None, None, :]
    mask = k_pos <= q_pos[..., None]
    if window:
        mask &= k_pos > q_pos[..., None] - window
    mask &= k_pos < kv_len[:, None, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache.float())
    return out.reshape(B, C, H, D).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, impl: str = "auto", q_block: int = 512,
              kv_block: int = 1024):
    """Backend dispatch. 'auto': naive up to 1024 positions, banded for a
    square sliding-window call whose length the q block divides,
    blockwise otherwise."""
    S = max(q.shape[1], k.shape[1])
    if impl == "auto":
        if S <= 1024:
            impl = "naive"
        elif window and q.shape[1] == k.shape[1] and q_offset == 0 \
                and q.shape[1] % min(q_block, q.shape[1]) == 0:
            impl = "banded"
        else:
            impl = "blockwise"
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "banded":
        return banded_attention(q, k, v, window=window, q_block=q_block,
                                q_offset=q_offset)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, q_block=q_block,
                                   kv_block=min(kv_block, k.shape[1]))
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------
# tensor-parallel paged forms
# ---------------------------------------------------------------------

def heads_range(plan, s: int, H: int):
    """(first global q head, count) of shard s."""
    if plan.heads:
        n = H // plan.tp
        return s * n, n
    return 0, H


def slot_lens(lens, s: int, page_size: int, slot_size: int):
    """Valid tokens of slot shard s for lanes of ``lens`` tokens: with
    p = (len - 1) // PS the lane's last page, every earlier page gives
    the shard all its slot_size slots and page p gives
    clamp(len - p * PS - s * slot_size, 0, slot_size). int32."""
    lens = lens.long()
    p = torch.div(lens - 1, page_size, rounding_mode="floor")
    n = p * slot_size + torch.clamp(lens - p * page_size - s * slot_size,
                                    0, slot_size)
    return torch.clamp(n, min=0).to(torch.int32)


def kv_heads_for(k, lo: int, n: int, G: int):
    """The kv heads (last but one axis of k, all KH of them) that q heads
    [lo, lo + n) read, as a tensor whose head j // G' serves local q head
    j; returns (k', G'). A contiguous range of whole groups, or one kv
    head, is a slice; any other set an index_select with G' = 1."""
    if lo % G == 0 and n % G == 0:
        return k[..., lo // G:(lo + n) // G, :], G
    if lo // G == (lo + n - 1) // G:
        return k[..., lo // G:lo // G + 1, :], n
    idx = torch.div(torch.arange(lo, lo + n, device=k.device), G,
                    rounding_mode="floor")
    return k.index_select(-2, idx), 1


def _replicated_pools(pages, plan):
    """Every shard's view of the whole pool ([n_pages, PS, KH, D] k and v)
    for the page-wise and replicated arms: page shards all-gathered,
    replicated pools as they are."""
    if plan.pool == "rep":
        return [(p["k"], p["v"]) for p in pages]
    if plan.pool == "page":
        ks = M.all_gather([p["k"] for p in pages], 0, plan.mesh)
        vs = M.all_gather([p["v"] for p in pages], 0, plan.mesh)
        return list(zip(ks, vs))
    raise ValueError(f"no replicated view of a {plan.pool}-wise pool")


def _kernel_heads(t, s: int, plan, H: int):
    """kv_heads_for on shard s's whole-pool view, made contiguous for the
    card's kernel (a slice of whole heads is one already)."""
    KH = t.shape[-2]
    lo, n = heads_range(plan, s, H)
    sel, _ = kv_heads_for(t, lo, n, H // KH)
    return sel if sel.device.type == "cpu" else sel.contiguous()


def paged_attention_tp(qs, pages, page_table, lens, plan, H: int):
    """``paged_attention`` over a sharded pool: qs [B, H_s, D] (the
    shard's q heads), per-shard pools, page tables and lens. Returns the
    per-shard outputs [B, H_s, D]."""
    tp = plan.tp
    if plan.pool == "head":
        return [paged_attention(qs[s], pages[s]["k"], pages[s]["v"],
                                page_table[s], lens[s]) for s in range(tp)]
    if plan.pool == "slot":
        qf = M.all_gather(qs, 1, plan.mesh) if plan.heads else qs
        parts = [paged_decode_partials(
            qf[s], pages[s]["k"], pages[s]["v"], page_table[s],
            slot_lens(lens[s], s, plan.page_size, plan.slot_size))
            for s in range(tp)]
        acc, m, l = (M.gather([pt[i] for pt in parts], 2, plan.mesh)
                     for i in range(3))
        # counted as one slot a shard, on every device (merge_cost)
        o = M.broadcast(lse_merge_partials(acc, m, l, qs[0].dtype,
                                           slots=tp), plan.mesh)
        out = []
        for s in range(tp):
            lo, n = heads_range(plan, s, H)
            out.append(o[s][:, lo:lo + n])
        return out
    views = _replicated_pools(pages, plan)
    return [paged_attention(qs[s], _kernel_heads(views[s][0], s, plan, H),
                            _kernel_heads(views[s][1], s, plan, H),
                            page_table[s], lens[s]) for s in range(tp)]


def _chunk_rows(pages, plan, table):
    """Every shard's gathered table rows [L, P * PS, KH_s, D] of k and v
    for the chunk half: its own rows (head-wise: its kv heads), the slot
    shards' rows all-gathered, or rows of the replicated view."""
    tp = plan.tp
    out = []
    if plan.pool in ("head", "slot"):
        for name in ("k", "v"):
            rows = [pages[s][name][table[s].long()] for s in range(tp)]
            if plan.pool == "slot":             # [L, P, PS/tp, KH, D]
                rows = M.all_gather(rows, 2, plan.mesh)
            out.append([r.reshape(r.shape[0], -1, *r.shape[3:])
                        for r in rows])
        return list(zip(*out))
    views = _replicated_pools(pages, plan)
    res = []
    for s, (k, v) in enumerate(views):
        idx = table[s].long()
        L = idx.shape[0]
        res.append((k[idx].reshape(L, -1, *k.shape[2:]),
                    v[idx].reshape(L, -1, *v.shape[2:])))
    return res


def mixed_paged_attention_tp(qcs, qds, pages, chunk_table, chunk_start,
                             dec_table, dec_pos, plan, H: int):
    """``mixed_paged_attention`` over a sharded pool (per-shard lists).
    ``qds`` None: the chunk half alone (extend). Returns (ocs, ods)."""
    rows = _chunk_rows(pages, plan, chunk_table)
    ocs = []
    for s, (qc, (kc, vc)) in enumerate(zip(qcs, rows)):
        if plan.pool != "head":
            lo, n = heads_range(plan, s, H)
            G = H // kc.shape[-2]
            kc, _ = kv_heads_for(kc, lo, n, G)
            vc, _ = kv_heads_for(vc, lo, n, G)
        C = qc.shape[1]
        ocs.append(extend_attention(qc, kc, vc, chunk_start[s],
                                    chunk_start[s] + C))
    if qds is None:
        return ocs, None
    ods = paged_attention_tp(qds, pages, dec_table,
                             [p + 1 for p in dec_pos], plan, H)
    return ocs, ods
