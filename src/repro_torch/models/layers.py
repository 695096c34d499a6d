"""Layer forwards of the paged serving path (counterpart of the JAX
package's ``models/layers.py``).

Shapes follow the JAX package: x is [B, d] for one-token steps and
[B, C, d] for chunks; projection weights are head-factored ([d, H, Dh],
[H, Dh, d]). The KV page pool {"k","v": [n_pages, PS, KH, D]} is updated
IN PLACE with ``index_put_`` where the JAX code writes a new pool with
``.at[].set`` and donates the old buffer: the functions return the same
dict they were given, already holding this step's KV.

Page-table lookups clamp the page index to the table's width, as JAX's
gathers clamp out-of-range indices; every such lookup is for a padded
token whose write is redirected to the scratch page 0 or whose output
is dropped.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .attention import extend_attention, mixed_paged_attention, \
    paged_attention
from .common import rope

Pages = Dict[str, torch.Tensor]


def _project_qkv(p, cfg, x):
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    k = torch.einsum("...d,dhk->...hk", x, p["wk"])
    v = torch.einsum("...d,dhk->...hk", x, p["wv"])
    return q, k, v


def _table_lookup(table, rows, pos, page_size):
    """table[rows, pos // page_size] with the page index clamped to the
    table's width (JAX gather semantics)."""
    col = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"),
                      max=table.shape[1] - 1)
    return table[rows, col]


def _write_kv(pages: Pages, pids, offs, k, v) -> None:
    """Scatter new K/V rows into the pool in place."""
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


def embed_tokens(p, cfg, tokens):
    return F.embedding(tokens, p["tok"])


def head_matrix(p, cfg):
    return p["tok"].T if cfg.tie_embeddings else p["head"]
