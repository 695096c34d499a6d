"""rwkv6-7b [ssm] — 32L d4096 (attn-free) ff14336 v65536.
Finch: data-dependent decay. [arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64,
    attention_free=True, rwkv_head_dim=64,
)
