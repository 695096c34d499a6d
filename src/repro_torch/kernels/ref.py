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
