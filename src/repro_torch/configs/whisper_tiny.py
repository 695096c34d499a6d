"""whisper-tiny [audio] — 4L enc + 4L dec, d384 6H ff1536 v51865.
Enc-dec; conv frontend stubbed to frame embeddings. [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    encoder_decoder=True, n_encoder_layers=4, max_target_len=448,
)
