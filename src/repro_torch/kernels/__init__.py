"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (CUDA sources under ``csrc/``, built at first use by ``build``;
nothing builds at import).

flash_attention        causal GQA flash attention (prefill)
decode_attention       split-K flash decoding + LSE merge (decode)
prefix_attention       Hydragen-style shared-prefix batch decode (the
                       kernel-level form of Preble's prompt sharing)
paged_decode_attention decode over the serving engine's page pool

The same names as ``repro.kernels``.
"""

from . import ops, ref
from .flash_attention import flash_attention
from .decode_attention import decode_attention, lse_merge
from .prefix_attention import prefix_attention, prefix_partial
from .paged_attention import paged_decode_attention

__all__ = ["ops", "ref", "flash_attention", "decode_attention",
           "lse_merge", "prefix_attention", "prefix_partial",
           "paged_decode_attention"]
