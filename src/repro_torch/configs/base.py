"""Model / shape configuration schema shared by the model zoo and launcher."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1              # a layer is MoE iff layer_idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # "standard": GSPMD capacity dispatch; "halfexpert": hand-written
    # shard_map expert parallelism (launch-time choice; needs moe_tp)
    moe_impl: str = "standard"
    moe_tp: int = 0                 # model-axis size for halfexpert layout

    # attention variants
    sliding_window: int = 0         # 0 = full attention
    parallel_block: bool = False    # cohere-style parallel attn+FFN residual
    rope_theta: float = 1e4

    # hybrid (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0            # 0 = every layer is attention
    attn_offset: int = 3
    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # vlm: cross-attention layers every `cross_attn_period` layers
    cross_attn_period: int = 0
    cross_attn_offset: int = 3
    n_vision_tokens: int = 1600     # stub frontend sequence length

    # enc-dec (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_target_len: int = 448       # whisper decoder context

    # rwkv
    attention_free: bool = False
    rwkv_head_dim: int = 64

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # scan grouping: layers are processed as scan over n_groups groups of
    # group_size layers (group_size > 1 expresses interleave patterns)
    @property
    def group_size(self) -> int:
        if self.attn_period:
            return self.attn_period
        if self.cross_attn_period:
            return self.cross_attn_period
        return 1

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0
        return self.n_layers // self.group_size

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (self.n_experts > 0
                and layer_idx % self.moe_every == self.moe_offset)

    def is_attn_layer(self, layer_idx: int) -> bool:
        if self.attention_free:
            return False
        if self.attn_period:
            return layer_idx % self.attn_period == self.attn_offset
        return True

    def is_cross_attn_layer(self, layer_idx: int) -> bool:
        return (self.cross_attn_period > 0
                and layer_idx % self.cross_attn_period == self.cross_attn_offset)

    # ---- parameter counting (for roofline MODEL_FLOPS and cost model) -----

    def param_counts(self) -> Tuple[float, float]:
        """Returns (total_params, active_params_per_token)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        qdim = self.n_heads * self.head_dim
        kvdim = self.n_kv_heads * self.head_dim
        total = active = 0.0

        def add(n, act=True):
            nonlocal total, active
            total += n
            if act:
                active += n

        emb = V * d * (1 if self.tie_embeddings else 2)
        add(emb)

        layers = range(self.n_layers)
        for i in layers:
            if self.attention_free:
                # rwkv6 time mix: r,k,v,g,o (d*d each) + lora decays (small)
                add(5 * d * d + 2 * d * 64 + d * self.rwkv_head_dim)
                add(d * ff + ff * d + d * d)  # channel mix r,k,v
                add(4 * d)  # norms & mixers (approx)
                continue
            if self.is_attn_layer(i):
                add(d * qdim + 2 * d * kvdim + qdim * d)
            elif self.attn_period:  # mamba layer
                ed = self.mamba_expand * d
                add(d * 2 * ed            # in_proj
                    + ed * self.mamba_d_conv   # conv
                    + ed * (2 * self.mamba_d_state + ed // 16 + 1)  # x_proj(B,C,dt)
                    + (ed // 16) * ed     # dt_proj
                    + ed * self.mamba_d_state  # A
                    + ed * d)             # out_proj
            if self.is_cross_attn_layer(i):
                add(d * qdim + 2 * d * kvdim + qdim * d)
            if self.is_moe_layer(i):
                add(d * self.n_experts, act=True)  # router
                per_exp = 3 * d * ff
                add(per_exp * self.n_experts, act=False)
                active += per_exp * self.experts_per_token
            elif not self.attention_free:
                add(3 * d * ff)
            add(2 * d)  # norms
        if self.encoder_decoder:
            for _ in range(self.n_encoder_layers):
                add(d * qdim + 2 * d * kvdim + qdim * d)  # self attn
                add(2 * (d * ff + ff * d) // 2 * 2)        # mlp (gelu, 2 mats)
                add(2 * d)
            # decoder cross-attn stacks
            for _ in range(self.n_layers):
                add(d * qdim + 2 * d * kvdim + qdim * d)
        add(d)  # final norm
        return total, active


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is this (arch x shape) cell runnable? (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.attention_free or cfg.attn_period > 0
                         or cfg.sliding_window > 0)
        if not sub_quadratic:
            return False, ("full quadratic attention cannot decode at 512k "
                           "context (no sub-quadratic mechanism in this arch)")
    if cfg.encoder_decoder and shape.kind == "decode":
        # whisper decodes fine (enc-dec, not encoder-only) — but its decoder
        # context is bounded; seq_len applies to the ENCODER side.
        pass
    return True, ""


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test-sized variant of the same family (few layers/narrow)."""
    d = {
        "n_layers": min(cfg.n_layers, 2 * cfg.group_size),
        "d_model": 64 if cfg.name != "smollm-360m" else 64,
        "n_heads": max(cfg.n_heads * 64 // cfg.d_model, 1),
        "n_kv_heads": 1,
        "d_ff": 128,
        "vocab_size": 128,
        "head_dim": 16,
        "n_vision_tokens": 16,
        "max_target_len": 16,
    }
    if cfg.n_experts:
        d["n_experts"] = min(cfg.n_experts, 4)
        d["experts_per_token"] = min(cfg.experts_per_token, 2)
        # random (untrained) routers are heavily imbalanced; give the
        # smoke configs drop-free capacity so prefill==decode exactly.
        # (production: aux-loss-balanced router + cap 1.25, drops rare)
        d["capacity_factor"] = float(2 * cfg.n_experts)
    if cfg.n_encoder_layers:
        d["n_encoder_layers"] = 2
    if cfg.sliding_window:
        d["sliding_window"] = 16
    # keep head count divisible relationships sane
    d["n_heads"] = max(d["n_heads"], 2)
    d["n_kv_heads"] = 1 if cfg.n_kv_heads < cfg.n_heads else d["n_heads"]
    d.update(overrides)
    return dataclasses.replace(cfg, **d)
