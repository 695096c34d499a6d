"""mistral-7b — the paper's primary evaluation model (§4.2).
32L d4096 32H (GQA kv=8) ff14336 v32000, SWA(4096). [arXiv:2310.06825]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    sliding_window=4096, rope_theta=1e6,
)
