"""grok-1-314b [moe] — 64L d6144 48H (GQA kv=8) ff32768 v131072,
MoE 8e top-2. [hf:xai-org/grok-1; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    n_experts=8, experts_per_token=2, moe_every=1, rope_theta=1e4,
)
