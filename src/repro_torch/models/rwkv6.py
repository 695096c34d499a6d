"""RWKV-6 (Finch) layer: linear attention with a data-dependent decay a
channel (counterpart of the JAX package's ``models/rwkv6.py``).

Recurrence a head (k-dim x v-dim state S; the decay w_t and the bonus u
act on the k channel):

    y_t = r_t @ (S_{t-1} + (u * k_t)^T v_t)
    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t,      w_t = exp(-exp(ww + lora(x)))

Forms:
  * ``rwkv_time_full`` — the chunked form (prefill and chunk extension):
      within a chunk of ``pick_chunk(S, 16)`` tokens a decay-weighted
      attention whose exponent is masked to -inf BEFORE exp (no inf * 0
      NaNs), across chunks the carried state. The intra-chunk parts of
      every chunk are computed at once; only the carry is a loop over
      chunks. The float32 results follow the reference's chunking.
  * ``rwkv_time_step`` — one token against the state.
Channel-mix is the squared-ReLU gated MLP with token shift. Token-shift
mixes are static per channel, as in the reference (DESIGN.md §7).

Cache entry: {"state": [B, H, Dh, Dh] float32, "shift": [B, d],
"shift_c": [B, d]}. With a cache the forms write the new entries INTO
its tensors (the engine's caches are updated in place) and return it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import CacheSpec
from .mamba import pick_chunk

LOGW_MIN = -8.0     # clip of the decay's log, for numerical stability
LOGW_MAX = -1e-4

Cache = Dict[str, torch.Tensor]


def _shift_full(x, prev):
    """Token shift: x_{t-1}, with ``prev`` [B, d] seeding position 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _mix(x, x_prev, mu_row):
    m = torch.sigmoid(mu_row.float()).to(x.dtype)
    return x + (x_prev - x) * m


def _heads(x, H, Dh):
    return x.reshape(*x.shape[:-1], H, Dh)


def _group_norm(y, weight, H, Dh, eps=1e-5):
    """A LayerNorm a head (RWKV's GroupNorm with H groups), population
    variance."""
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    out = (yf - mu) * torch.rsqrt(var + eps)
    return out * weight.reshape(H, Dh).float()


def _projections(p, x, xp, H, Dh):
    """r, k, v [.., H, Dh], the gate g [.., d] and the clipped decay log
    [.., H, Dh] float32 of tokens x with their shifted inputs xp."""
    mu = p["mu"]
    r = _heads(_mix(x, xp, mu[0]) @ p["wr"], H, Dh)
    k = _heads(_mix(x, xp, mu[1]) @ p["wk"], H, Dh)
    v = _heads(_mix(x, xp, mu[2]) @ p["wv"], H, Dh)
    g = _mix(x, xp, mu[4]) @ p["wg"]
    lora = torch.tanh(_mix(x, xp, mu[3]) @ p["w_lora_a"]).float()
    w_raw = p["ww"].float() + lora @ p["w_lora_b"].float()
    logw = torch.clamp(-torch.exp(w_raw), LOGW_MIN, LOGW_MAX)
    return r, k, v, g, _heads(logw, H, Dh)


def _out(p, y, g, H, Dh, shape, dtype):
    y = _group_norm(y, p["ln_x"], H, Dh).reshape(shape)
    y = y * F.silu(g.float())
    return y.to(dtype) @ p["wo"]


def rwkv_time_full(p, cfg, x, cache: Optional[Cache] = None,
                   chunk: int = 16) -> Tuple[torch.Tensor, Cache]:
    """x: [B, S, d] -> (y, {"state", "shift"}); with a ``cache`` the scan
    starts from its state and shift, and the new ones are written into
    it."""
    B, S, d = x.shape
    Dh = cfg.rwkv_head_dim
    H = d // Dh
    prev = cache["shift"] if cache is not None else None
    r, k, v, g, logw = _projections(p, x, _shift_full(x, prev), H, Dh)
    u = _heads(p["u"].float(), H, Dh)                       # [H, Dh]

    C = pick_chunk(S, chunk)
    n = S // C
    rf, kf, vf, lw = (t.float().reshape(B, n, C, H, Dh)
                      for t in (r, k, v, logw))
    a = torch.cumsum(lw, dim=2)                             # inclusive
    b = a - lw                                              # exclusive
    # intra-chunk: s_ij = sum_dk r_i k_j exp(b_i - a_j), j < i
    expo = b[:, :, :, None] - a[:, :, None, :]              # [B,n,C,C,H,Dh]
    ii = torch.arange(C, device=x.device)
    mask = (ii[:, None] > ii[None, :])[:, :, None, None]
    Dm = torch.exp(torch.where(mask, expo, float("-inf")))
    s = torch.einsum("bnihd,bnjhd,bnijhd->bnhij", rf, kf, Dm)
    y = torch.einsum("bnhij,bnjhd->bnihd", s, vf)
    y = y + torch.einsum("bnihd,bnihd->bnih", rf, u * kf)[..., None] * vf
    re = rf * torch.exp(b)                                  # r_t exp(b_t)
    a_last = a[:, :, -1]                                    # [B, n, H, Dh]
    decay = torch.exp(a_last)
    kd = kf * torch.exp(a_last[:, :, None] - a)
    dS = torch.einsum("bnjhk,bnjhv->bnhkv", kd, vf)
    St = (cache["state"] if cache is not None
          else x.new_zeros((B, H, Dh, Dh), dtype=torch.float32))
    ys = []
    for c in range(n):
        ys.append(y[:, c] + torch.einsum("bihk,bhkv->bihv", re[:, c], St))
        St = decay[:, c, ..., None] * St + dS[:, c]
    y = torch.stack(ys, 1).reshape(B, S, H, Dh)
    out = _out(p, y, g, H, Dh, (B, S, d), x.dtype)
    if cache is None:
        return out, {"state": St, "shift": x[:, -1]}
    cache["state"].copy_(St)
    cache["shift"].copy_(x[:, -1])
    return out, cache


def rwkv_time_step(p, cfg, x, cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """x: [B, d] one token a lane -> (y [B, d], cache updated in
    place)."""
    B, d = x.shape
    Dh = cfg.rwkv_head_dim
    H = d // Dh
    r, k, v, g, logw = _projections(p, x, cache["shift"], H, Dh)
    w = torch.exp(logw)
    u = _heads(p["u"].float(), H, Dh)
    rf, kf, vf = r.float(), k.float(), v.float()
    St = cache["state"]                                     # [B, H, Dh, Dh]
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf, St + u[None, :, :, None] * kv)
    S_new = w[..., None] * St + kv
    out = _out(p, y, g, H, Dh, (B, d), x.dtype)
    cache["state"].copy_(S_new)
    cache["shift"].copy_(x)
    return out, cache


def _channel(p, x, xp):
    mu = p["mu_c"]
    r = torch.sigmoid((_mix(x, xp, mu[0]) @ p["wr_c"]).float())
    k = _mix(x, xp, mu[1]) @ p["wk_c"]
    k = torch.square(F.relu(k.float())).to(x.dtype)
    return r.to(x.dtype) * (k @ p["wv_c"])


def rwkv_channel_full(p, cfg, x, cache: Optional[Cache] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    prev = cache["shift_c"] if cache is not None else None
    out = _channel(p, x, _shift_full(x, prev))
    if cache is None:
        return out, {"shift_c": x[:, -1]}
    cache["shift_c"].copy_(x[:, -1])
    return out, cache


def rwkv_channel_step(p, cfg, x, cache: Cache) -> Tuple[torch.Tensor, Cache]:
    out = _channel(p, x, cache["shift_c"])
    cache["shift_c"].copy_(x)
    return out, cache


def rwkv_cache_spec(cfg, batch: int) -> Dict[str, CacheSpec]:
    d = cfg.d_model
    Dh = cfg.rwkv_head_dim
    dt = getattr(torch, cfg.dtype)
    return {"state": CacheSpec((batch, d // Dh, Dh, Dh), torch.float32),
            "shift": CacheSpec((batch, d), dt),
            "shift_c": CacheSpec((batch, d), dt)}
