"""jamba-v0.1-52b [hybrid] — 32L d4096 32H (GQA kv=8) ff14336 v65536,
MoE 16e top-2; Mamba+attn 1:7 interleave (1 attn per 8 layers).
[arXiv:2403.19887; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    n_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
    attn_period=8, attn_offset=3,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)
