"""Operations and bytes the benchmark holds the program to, counted from
shapes, and the H100's published peaks (NVIDIA data sheet, SXM part,
dense bf16, at the full 700 W).

Conventions (the port's kernel table, PERF.md): a matrix product of
[m, k] x [k, n] is 2 m k n operations; attention is 4 x head_dim x heads
operations a visible (query, key) pair, over valid keys only; a kernel's
bytes count each input read once and each output written once.

A step's operations, counted from the configuration file's own keys
(``Dims.of``), a token:
- an attention layer: q, k, v and o as products, and 4 D H a visible
  pair;
- a Mamba layer: in_proj, the depthwise conv (2 d_conv a channel),
  x_proj, dt_proj and out_proj as products, and the scan, 7 a (channel,
  state) element (``Dims.scan_ops``);
- an FFN: the router and the k experts a token is routed to, at the
  expert width (``moe_intermediate_size``, else ``intermediate_size``),
  on an expert layer; the dense FFN on any other;
- the output head, 2 d V, for each row that yields a token.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

PEAK_FLOPS = 989e12         # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12        # HBM3


@dataclass(frozen=True)
class Dims:
    """A configuration's sizes as its file gives them. The layer plan:
    ``n_attn_layers`` attend (None: all), the others are Mamba layers
    (inner width ``d_inner``, state ``d_state``, conv ``d_conv``, dt rank
    ``dt_rank``); ``n_expert_layers`` route to experts ``expert_ff`` wide
    (None: all, where there are experts; ``expert_ff`` 0: ``d_ff``), the
    others hold a dense FFN ``d_ff`` wide."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    n_experts: int
    experts_per_token: int
    itemsize: int
    n_attn_layers: Optional[int] = None
    n_expert_layers: Optional[int] = None
    expert_ff: int = 0
    d_inner: int = 0
    d_state: int = 0
    d_conv: int = 0
    dt_rank: int = 0

    def __post_init__(self):
        fix = object.__setattr__
        if self.n_attn_layers is None:
            fix(self, "n_attn_layers", self.n_layers)
        if self.n_expert_layers is None:
            fix(self, "n_expert_layers",
                self.n_layers if self.n_experts else 0)
        if not self.expert_ff:
            fix(self, "expert_ff", self.d_ff)

    @classmethod
    def of(cls, config: Dict[str, Any]) -> "Dims":
        """From the file's own keys: Hugging Face names, with Jamba's
        layer plan (``attn_layer_period`` / ``_offset``,
        ``expert_layer_period`` / ``_offset``) and Mamba sizes."""
        n, d = config["num_hidden_layers"], config["hidden_size"]
        H = config["num_attention_heads"]
        experts = (config.get("num_local_experts")
                   or config.get("num_experts") or 0)

        def count(period: str, offset: str) -> int:
            p, o = config.get(period, 1), config.get(offset, 0)
            return sum(j % p == o for j in range(n))

        hybrid = "attn_layer_period" in config
        ed = config["mamba_expand"] * d if hybrid else 0
        rank = config.get("mamba_dt_rank", "auto") if hybrid else 0
        return cls(n, d, H, config["num_key_value_heads"],
                   config.get("head_dim") or d // H,
                   config["intermediate_size"], config["vocab_size"],
                   experts, config.get("num_experts_per_tok", 0) or 0,
                   {"bfloat16": 2, "float16": 2,
                    "float32": 4}[config["torch_dtype"]],
                   n_attn_layers=count("attn_layer_period",
                                       "attn_layer_offset"),
                   n_expert_layers=(count("expert_layer_period",
                                          "expert_layer_offset")
                                    if experts else 0),
                   expert_ff=config.get("moe_intermediate_size") or 0,
                   d_inner=ed,
                   d_state=config["mamba_d_state"] if hybrid else 0,
                   d_conv=config["mamba_d_conv"] if hybrid else 0,
                   dt_rank=math.ceil(d / 16) if rank == "auto" else rank)

    @property
    def n_mamba_layers(self) -> int:
        return self.n_layers - self.n_attn_layers

    @property
    def attn_params(self) -> int:
        """q, k, v and o of one attention layer."""
        d, H, KH, Dh = self.d_model, self.n_heads, self.n_kv_heads, \
            self.head_dim
        return d * H * Dh * 2 + d * KH * Dh * 2

    @property
    def mamba_params(self) -> int:
        """Weights a token multiplies in one Mamba layer: in_proj [d,
        2 ed], the depthwise conv [d_conv, ed], x_proj [ed, R + 2 N],
        dt_proj [R, ed] and out_proj [ed, d]."""
        d, ed, N, R = self.d_model, self.d_inner, self.d_state, self.dt_rank
        return (d * 2 * ed + self.d_conv * ed + ed * (R + 2 * N) + R * ed
                + ed * d)

    @property
    def expert_ffn_params(self) -> int:
        """The router and the experts a token is routed to."""
        return (self.d_model * self.n_experts
                + 3 * self.d_model * self.expert_ff * self.experts_per_token)

    @property
    def active_params(self) -> int:
        """Weights a token multiplies in the whole stack."""
        return (self.n_attn_layers * self.attn_params
                + self.n_mamba_layers * self.mamba_params
                + self.n_expert_layers * self.expert_ffn_params
                + (self.n_layers - self.n_expert_layers) * 3 * self.d_model
                * self.d_ff)

    @property
    def scan_ops(self) -> int:
        """The selective scan's operations a token in one Mamba layer: 7
        a (channel, state) element, ed x N of them: dt A, its exponential,
        (dt x) B, the state's multiply-add h dA + dB x, and the readout's
        multiply-add into y with C. Per-channel work (dt x, the gate,
        D x, the norms) is not counted, as norms and softmax are not in
        attention."""
        return 7 * self.d_inner * self.d_state


def pairs_of_chunk(start: int, n: int) -> int:
    """Visible (query, key) pairs of n causal queries from position
    ``start`` against the keys before and among them."""
    return n * start + n * (n + 1) // 2


def step_flops(dims: Dims, tokens: int, logit_rows: int, pairs: int
               ) -> float:
    """Model operations of one engine step: every token through the
    active weights of every layer, the LM head for each row that yields
    a token, attention over the visible pairs of every attention layer
    and each Mamba layer's scan for every token."""
    ops = (2.0 * dims.active_params * tokens
           + 2.0 * dims.d_model * dims.vocab * logit_rows
           + 4.0 * dims.head_dim * dims.n_heads * dims.n_attn_layers * pairs)
    if dims.n_mamba_layers:
        ops += float(dims.scan_ops) * dims.n_mamba_layers * tokens
    return ops


def paged_decode_call(dims: Dims, lens: Iterable[int]) -> Tuple[float, float]:
    """(operations, bytes) of one paged decode attention call over lanes
    with ``lens`` valid keys each: q and out [B, H, D], K and V of the
    valid keys, each read or written once."""
    lens = list(lens)
    B, kv = len(lens), sum(lens)
    H, KH, D, it = dims.n_heads, dims.n_kv_heads, dims.head_dim, \
        dims.itemsize
    flops = 4.0 * D * H * kv
    nbytes = float(it * (2 * B * H * D + 2 * kv * KH * D))
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    peak operations a second and bytes over peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
