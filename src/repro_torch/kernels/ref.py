"""Plain PyTorch oracles for the kernels (the allclose targets).

Layout convention for kernels: head-major [B, H, S, D] (queries) and
[B, KH, S, D] (KV), as in the JAX package's ``kernels/ref.py``.
"""

from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, lens):
    """q: [B, H, D]; k/v: [B, KH, S, D]; lens: [B] valid cache lengths."""
    B, H, D = q.shape
    KH, S = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * (D ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", w, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_len=None):
    """q: [B, H, Sq, D]; k/v: [B, KH, Skv, D] (GQA G = H // KH)."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, Sq, D).float()
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * (D ** -0.5)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask &= k_pos < kv_len
    s = s.masked_fill(~mask, float("-inf"))
    # rows with no valid key produce 0 (matches kernel's l=0 guard)
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(-1)[..., None], w, 0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", w, vf)
    return o.reshape(B, H, Sq, D).to(q.dtype)


def prefix_attention_ref(q, kp, vp, ks, vs, lens):
    """Shared-prefix (Hydragen) decode attention oracle.

    q: [B, H, D] decode queries; kp/vp: [KH, Sp, D] the SHARED prefix KV
    (one copy for the whole batch); ks/vs: [B, KH, Ss, D] per-request
    suffix KV; lens: [B] valid suffix lengths. Equivalent to attention
    over the concatenation [prefix ++ suffix]."""
    B, H, D = q.shape
    KH, Sp = kp.shape[0], kp.shape[1]
    k_full = kp[None].expand(B, KH, Sp, D)
    v_full = vp[None].expand(B, KH, Sp, D)
    k_cat = torch.cat([k_full, ks], dim=2)
    v_cat = torch.cat([v_full, vs], dim=2)
    return decode_attention_ref(q, k_cat, v_cat, Sp + lens)
