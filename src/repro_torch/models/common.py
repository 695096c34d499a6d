"""Shared model building blocks on torch tensors (counterpart of the JAX
package's ``models/common.py``). The float32 casts sit where the JAX
code has them, so the two agree in float32 and round alike in bf16."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    exps = -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)          # [D/2]
    angles = positions[..., None].float() * freq                  # [..., S, D/2]
    angles = angles[..., None, :]                                 # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def top1_logits(hidden_last: torch.Tensor,
                w_out: torch.Tensor) -> torch.Tensor:
    """Greedy next-token from last-position hidden states: [B, d] -> [B]."""
    logits = (hidden_last @ w_out).float()
    return torch.argmax(logits, dim=-1).to(torch.int32)
