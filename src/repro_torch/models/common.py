"""Shared model building blocks on torch tensors (counterpart of the JAX
package's ``models/common.py``). The float32 casts sit where the JAX
code has them, so the two agree in float32 and round alike in bf16."""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch


class CacheSpec(NamedTuple):
    """Shape and dtype of one cache leaf (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

# The decode-MoE switch (the JAX package's ``set_ep_decode``): off, the
# one-token step paths route each token to its experts (``moe_step``); on,
# they run the capacity dispatch at S = 1 (``moe_full``, exact: its
# capacity is K), the form that keeps a sharded expert dim parallel.
_EP_DECODE: bool = False


def set_ep_decode(on: bool) -> None:
    global _EP_DECODE
    _EP_DECODE = bool(on)


def ep_decode() -> bool:
    return _EP_DECODE


# The ambient mesh of the half-expert MoE path (the JAX package's
# ``set_mesh``): ``forward_full`` of a ``moe_impl == "halfexpert"`` stack
# runs ``moe_a2a.moe_halfexpert`` on it. None when unset.
_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[object]:
    return _MESH


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def rope_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's inverse frequencies theta ** (-2i / d), float32 [d / 2], made
    on ``device`` once per (d, theta, device). theta is filled in on the
    device, not copied from the host: a host-to-device copy of a Python
    scalar waits for the device, once a call of ``rope``."""
    exps = -torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=device), exps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    freq = rope_freq(x.shape[-1], theta, x.device)                 # [D/2]
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


def chunked_ce_loss(hidden: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk: int = 512) -> torch.Tensor:
    """Causal-LM loss without materializing [B, S, V] logits at once:
    hidden [B, S, d], w_out [d, V], labels [B, S] (next-token ids,
    already shifted), mask [B, S] (1 counts a position) or None. The
    sequence runs in n = max(S // chunk, 1) chunks of S // n positions,
    as the reference's scan: a chunk's logits [B, S // n, V] are float32,
    its NLL sums and mask counts are added chunk by chunk, and the loss
    is their ratio (count floored at 1). The gold logit is a gather (the
    reference's iota-mask reduce selects the same value; it exists only
    for a vocab-sharded program)."""
    B, S, d = hidden.shape
    n = max(S // chunk, 1)
    chunk = S // n
    if n * chunk != S:
        raise ValueError(f"sequence {S} does not split into {n} chunks")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=hidden.device)
    mask = mask.float()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = (hidden[:, sl] @ w_out).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, sl, None].long())[..., 0]
        mc = mask[:, sl]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)
