"""command-r-35b [dense] — 40L d8192 64H (GQA kv=8) ff22528 v256000.
Cohere parallel-block, no-bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    parallel_block=True, tie_embeddings=True, rope_theta=8e6,
)
