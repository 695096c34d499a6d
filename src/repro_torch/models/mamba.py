"""Mamba (S6 selective-scan) layer of jamba's hybrid stack (counterpart
of the JAX package's ``models/mamba.py``).

Two forms:
  * ``mamba_full`` — a whole sequence or a prefill chunk, resumable from
      a cache. The recurrence h_t = dA_t * h_{t-1} + dB_t x_t runs over
      chunks of ``pick_chunk(S, chunk)`` tokens; within a chunk it is a
      sequential loop of one fused multiply-add a token (the reference
      runs ``lax.associative_scan`` there: the same recurrence, summed in
      another order). Memory is O(C * ed * N) a chunk: the [C, C, ed, N]
      products a closed form would need are never built, and no
      cumulative product of dA is divided out (exp of a long cumulative
      sum of dt * A underflows in float32).
  * ``mamba_step`` — one token against the cache.

Cache entry: {"conv": [B, d_conv-1, ed] the last raw conv inputs, in the
model dtype; "ssm": [B, ed, N] float32 state}. The step and chunk forms
write the new state INTO the cache tensors they are given (the engine's
caches are updated in place) and return the same dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import CacheSpec


def pick_chunk(S: int, want: int) -> int:
    """Largest divisor of S that is <= want (>= 1)."""
    c = min(want, S)
    while S % c:
        c -= 1
    return c


def dt_rank(cfg) -> int:
    return max(cfg.d_model // 16, 1)


def _conv_causal(xs, conv_w, conv_b, prev=None):
    """Depthwise causal conv. xs: [B, S, ed]; prev: [B, conv-1, ed]
    history (zeros when None)."""
    conv = conv_w.shape[0]
    if prev is None:
        prev = xs.new_zeros((xs.shape[0], conv - 1, xs.shape[2]))
    xp = torch.cat([prev, xs], dim=1)                 # [B, S+conv-1, ed]
    S = xs.shape[1]
    out = sum(xp[:, w:w + S] * conv_w[w] for w in range(conv))
    return out + conv_b


def _ssm_inputs(p, cfg, xs):
    """xs: [..., ed] post-conv activations -> (dA, dBx, C) float32."""
    N = cfg.mamba_d_state
    R = dt_rank(cfg)
    proj = (xs @ p["x_proj"]).float()
    dt_r, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_w"].float() + p["dt_b"].float())
    A = -torch.exp(p["A_log"])                        # [ed, N]
    dA = torch.exp(dt[..., None] * A)                 # [..., ed, N]
    dBx = (dt * xs.float())[..., None] * Bm[..., None, :]
    return dA, dBx, Cm


def _gate_out(p, y, xs, z, dtype):
    """y + D x, gated by silu(z), projected back to d."""
    y = y + p["D"] * xs.float()
    y = y * F.silu(z.float())
    return y.to(dtype) @ p["out_proj"]


def mamba_full(p, cfg, x, cache: Optional[Dict[str, torch.Tensor]] = None,
               chunk: int = 64
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] -> (y [B, S, d], cache). With a ``cache`` the scan
    starts from its state and conv history, and the new ones are written
    into it; without one a new cache is returned."""
    B, S, d = x.shape
    conv = cfg.mamba_d_conv
    xs_raw, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    prev = cache["conv"] if cache is not None else None
    xs = F.silu(_conv_causal(xs_raw, p["conv_w"], p["conv_b"], prev)
                .float()).to(x.dtype)
    h = (cache["ssm"] if cache is not None
         else x.new_zeros((B, xs.shape[-1], cfg.mamba_d_state),
                          dtype=torch.float32))
    C = pick_chunk(S, chunk)
    ys = []
    for c0 in range(0, S, C):
        dA, dBx, Cm = _ssm_inputs(p, cfg, xs[:, c0:c0 + C])  # [B,C,ed,N]
        hs = []
        for t in range(C):
            h = torch.addcmul(dBx[:, t], dA[:, t], h)
            hs.append(h)
        ys.append(torch.einsum("bsen,bsn->bse", torch.stack(hs, 1), Cm))
    out = _gate_out(p, torch.cat(ys, 1), xs, z, x.dtype)
    if prev is not None:
        new_conv = torch.cat([prev, xs_raw], dim=1)[:, -(conv - 1):]
    else:
        new_conv = F.pad(xs_raw, (0, 0, conv - 1 - min(S, conv - 1), 0)
                         )[:, -(conv - 1):]
    new_conv = new_conv.to(x.dtype)
    if cache is None:
        return out, {"conv": new_conv, "ssm": h}
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(h)
    return out, cache


def mamba_step(p, cfg, x, cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, d] one token a lane; cache {"conv","ssm"} updated in place.
    Returns (y [B, d], cache)."""
    xs_raw, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)     # [B, ed]
    win = torch.cat([cache["conv"], xs_raw[:, None]], dim=1)
    conv_out = torch.einsum("bwe,we->be", win, p["conv_w"]) + p["conv_b"]
    xs = F.silu(conv_out.float()).to(x.dtype)
    dA, dBx, Cm = _ssm_inputs(p, cfg, xs)                    # [B, ed, N]
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("ben,bn->be", h, Cm)
    out = _gate_out(p, y, xs, z, x.dtype)
    cache["conv"].copy_(win[:, 1:])
    cache["ssm"].copy_(h)
    return out, cache


def mamba_cache_spec(cfg, batch: int) -> Dict[str, CacheSpec]:
    ed = cfg.mamba_expand * cfg.d_model
    return {"conv": CacheSpec((batch, cfg.mamba_d_conv - 1, ed),
                              getattr(torch, cfg.dtype)),
            "ssm": CacheSpec((batch, ed, cfg.mamba_d_state),
                             torch.float32)}
