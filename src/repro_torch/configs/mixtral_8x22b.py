"""mixtral-8x22b [moe] — 56L d6144 48H (GQA kv=8) ff16384 v32768,
MoE 8e top-2, SWA(4096). [arXiv:2401.04088; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    n_experts=8, experts_per_token=2, moe_every=1,
    sliding_window=4096, rope_theta=1e6,
)
