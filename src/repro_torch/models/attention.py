"""Attention on the paged serving path (counterpart of the JAX package's
``models/attention.py``).

All functions take the JAX package's layouts: q [B, Sq, H, D], k/v
[B, Skv, KH, D] for the dense forms, the page pool [n_pages, PS, KH, D]
for the paged ones, with GQA group G = H // KH.
"""

from __future__ import annotations

import torch

from ..kernels.paged_attention import paged_decode_attention

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-position decode: q [B, H, D] against cache [B, S, KH, D].
    ``cache_len`` is an int or a [B] tensor of valid lengths."""
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * (D ** -0.5)
    k_pos = torch.arange(S, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.dim() == 0:
        mask = (k_pos < clen)[None, None, None, :]
    else:
        mask = (k_pos[None, :] < clen[:, None])[:, None, None, :]
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


def extend_attention(q, k_cache, v_cache, start, kv_len):
    """Chunked-prefill attention: q [B, C, H, D] (first token at absolute
    position ``start``) against caches [B, S, KH, D] that already hold
    the chunk's KV; ``kv_len`` = start + C. ``start``/``kv_len`` are
    ints or [B] tensors. Materializes [B, H, C, S] scores (short engine
    chunks only)."""
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
    mask = (k_pos <= q_pos[..., None]) & (k_pos < kv_len[:, None, None])
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache.float())
    return out.reshape(B, C, H, D).to(q.dtype)
