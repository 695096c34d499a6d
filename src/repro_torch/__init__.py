"""PyTorch/CUDA port of the Preble reproduction (the JAX package ``repro``
is the reference). Same subpackage layout: ``configs``, ``core``,
``data``, ``models``, ``kernels``, ``serving``, ``launch``."""

import torch


def full_precision_matmuls() -> None:
    """Keep float32 matrix products and convolutions in full float32 on
    the card (no TF32), so float32 runs agree with the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
