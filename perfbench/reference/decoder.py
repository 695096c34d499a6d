"""Plain reference of a pre-norm decoder with grouped-query attention:
Mistral-7B and Mixtral (arXiv:2310.06825, arXiv:2401.04088).

Per layer: x + Attn(RMSNorm(x)), then + FFN(RMSNorm(.)); attention with
rotary positions (the rotate-half form, base ``rope_theta``), causal and
limited to ``sliding_window`` keys where the configuration has one; the
FFN is SwiGLU, or a mixture of experts whose router takes the softmax
over all experts, keeps the top ``num_experts_per_tok`` and renormalises
their weights (every token reaches its experts: no capacity drop). A
final RMSNorm and the output head give the logits.

Imports torch alone: nothing of the program under test. It reads the
weights the benchmark made, in the benchmark's layout (``embed`` with
``tok``, ``final_norm``, ``head``; ``stack.p0`` with leaves stacked over
the layers), and works out everything else itself.

``precision="float32"``: every product in float32 with TF32 off.
``precision="fp8"``: the control, the same forward with every weight
matrix and its input rounded to float8 e4m3 (a scale per output channel
and per token), the nearest precision below the bfloat16 the
configurations state.

Computed a layer at a time over all the sequences given, with attention
in blocks of queries, so that it fits beside the weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Q_BLOCK = 1024
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale along ``dim``'s slices."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Lin:
    """y = x @ w in float32, or with w and x rounded to fp8."""

    def __init__(self, precision: str):
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, D] at positions pos [T]."""
    D = x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = (pos.double()[:, None] * inv[None, :]).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, window: int) -> torch.Tensor:
    """Causal attention of one sequence: q [S, H, D], k/v [S, KH, D]."""
    S, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)       # [H, S, D]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for lo in range(0, S, Q_BLOCK):
        hi = min(S, lo + Q_BLOCK)
        qb = q[lo:hi].transpose(0, 1)                          # [H, b, D]
        s = qb @ k[:, :hi].transpose(1, 2) / math.sqrt(D)      # [H, b, hi]
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        mask = kpos[None, :hi] <= qpos
        if window:
            mask &= kpos[None, :hi] > qpos - window
        s = s.masked_fill(~mask[None], float("-inf"))
        out[lo:hi] = (torch.softmax(s, -1) @ v[:, :hi]).transpose(0, 1)
    return out


def _moe(x, p: Dict[str, torch.Tensor], cfg, lin: _Lin) -> torch.Tensor:
    """Top-k mixture of experts over x [T, d]."""
    K = cfg["num_experts_per_tok"]
    gates = torch.softmax(lin(x, p["router"]), dim=-1)
    w, e = torch.topk(gates, K, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for j in range(cfg["num_local_experts"]):
        tok, slot = (e == j).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = torch.nn.functional.silu(lin(xe, p["wg"][j])) * lin(xe,
                                                                 p["wu"][j])
        out.index_add_(0, tok, lin(h, p["wd"][j]) * w[tok, slot, None])
    return out


def logits(params, cfg, sequences: Sequence[Tuple[List[int], List[int]]],
           precision: str = "float32") -> List[torch.Tensor]:
    """For each (tokens, positions) the float32 logits [len(positions), V]
    at those positions of the sequence, on the weights' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lin = _Lin(precision)
    emb, stack = params["embed"], params["stack"]["p0"]
    dev = emb["tok"].device
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    window = cfg.get("sliding_window") or 0
    lens = [len(t) for t, _ in sequences]
    toks = torch.tensor([t for s, _ in sequences for t in s], device=dev)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    h = emb["tok"][toks].float()
    with torch.no_grad():
        for layer in range(cfg["num_hidden_layers"]):
            p = _layer(stack, layer)
            x = _rms(h, p["norm1"], eps)
            a = p["attn"]
            q = lin(x, a["wq"].reshape(x.shape[1], -1)).view(-1, H, D)
            k = lin(x, a["wk"].reshape(x.shape[1], -1)).view(-1, KH, D)
            v = lin(x, a["wv"].reshape(x.shape[1], -1)).view(-1, KH, D)
            q = _rope(q, pos, cfg["rope_theta"])
            k = _rope(k, pos, cfg["rope_theta"])
            o = torch.cat([_attend(qs, ks, vs, window) for qs, ks, vs in
                           zip(q.split(lens), k.split(lens), v.split(lens))])
            h = h + lin(o.reshape(-1, H * D), a["wo"].reshape(H * D, -1))
            x = _rms(h, p["norm2"], eps)
            f = p["ffn"]
            if cfg.get("num_local_experts"):
                h = h + _moe(x, f, cfg, lin)
            else:
                g = torch.nn.functional.silu(lin(x, f["wg"])) * lin(x, f["wu"])
                h = h + lin(g, f["wd"])
        out, ofs = [], 0
        for n, (_, at) in zip(lens, sequences):
            rows = h[ofs + torch.tensor(at, device=dev)]
            out.append(lin(_rms(rows, emb["final_norm"], eps), emb["head"]))
            ofs += n
    return out


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
