"""Operations and bytes the benchmark holds the program to, counted from
shapes, and the H100's published peaks (NVIDIA data sheet, SXM part,
dense bf16, at the full 700 W).

Conventions (the port's kernel table, PERF.md): a matrix product of
[m, k] x [k, n] is 2 m k n operations; attention is 4 x head_dim x heads
operations a visible (query, key) pair, over valid keys only; a kernel's
bytes count each input read once and each output written once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Tuple

PEAK_FLOPS = 989e12         # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12        # HBM3


@dataclass(frozen=True)
class Dims:
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

    @classmethod
    def of(cls, config: Dict[str, Any]) -> "Dims":
        return cls(config["num_hidden_layers"], config["hidden_size"],
                   config["num_attention_heads"],
                   config["num_key_value_heads"], config["head_dim"],
                   config["intermediate_size"], config["vocab_size"],
                   config.get("num_local_experts", 0) or 0,
                   config.get("num_experts_per_tok", 0) or 0,
                   {"bfloat16": 2, "float16": 2,
                    "float32": 4}[config["torch_dtype"]])

    @property
    def layer_active_params(self) -> int:
        """Weights a token multiplies in one layer: q, k, v, o, the router
        and the FFN of each expert it is routed to (or the dense FFN)."""
        d, H, KH, Dh, f = (self.d_model, self.n_heads, self.n_kv_heads,
                           self.head_dim, self.d_ff)
        attn = d * H * Dh * 2 + d * KH * Dh * 2
        if self.n_experts:
            return attn + d * self.n_experts + 3 * d * f * \
                self.experts_per_token
        return attn + 3 * d * f


def pairs_of_chunk(start: int, n: int) -> int:
    """Visible (query, key) pairs of n causal queries from position
    ``start`` against the keys before and among them."""
    return n * start + n * (n + 1) // 2


def step_flops(dims: Dims, tokens: int, logit_rows: int, pairs: int
               ) -> float:
    """Model operations of one engine step: every token through every
    layer's active weights, the LM head for each row that yields a
    token, and attention over the visible pairs of every layer."""
    return (2.0 * dims.layer_active_params * dims.n_layers * tokens
            + 2.0 * dims.d_model * dims.vocab * logit_rows
            + 4.0 * dims.head_dim * dims.n_heads * dims.n_layers * pairs)


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
