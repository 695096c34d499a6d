"""llama3-70b — the paper's second evaluation model (§4.2).
80L d8192 64H (GQA kv=8) ff28672 v128256. [Meta 2024]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128, rope_theta=5e5,
)
