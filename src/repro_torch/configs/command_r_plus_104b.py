"""command-r-plus-104b [dense] — 64L d12288 96H (GQA kv=8) ff33792 v256000.
Cohere parallel-block, no-bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-plus; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128,
    parallel_block=True, tie_embeddings=True, rope_theta=75e4,
)
