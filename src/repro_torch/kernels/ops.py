"""The kernels in the model-side layout [B, S, H, D].

Counterpart of ``repro/kernels/ops.py``. There is no ``interpret``
argument: CPU tensors take the plain versions and CUDA tensors the
kernels. Where the JAX wrappers transpose to the head-major kernel layout
before the call, these pass transposed views: the kernels read (and the
flash kernel writes) the model layout in place through its strides, so no
copy is made.
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention as _decode
from .flash_attention import _run_into as _flash_into
from .prefix_attention import prefix_attention as _prefix


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128):
    """Model layout: q [B, Sq, H, D]; k/v [B, Skv, KH, D] -> [B, Sq, H, D].
    ``block_q``/``block_k`` as in ``flash_attention.flash_attention``."""
    if block_q < 1 or block_k < 1:
        raise ValueError("flash_attention: block_q and block_k must be >= 1")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _flash_into(out.transpose(1, 2), q.transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2), causal, window, None)
    return out


def decode_attention(q, k_cache, v_cache, lens, *, n_splits: int = 8):
    """Model layout: q [B, H, D]; caches [B, S, KH, D]; lens [B]."""
    return _decode(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                   lens, n_splits=n_splits)


def prefix_attention(q, kp, vp, ks, vs, lens, *, block_k: int = 128):
    """Model layout: q [B, H, D]; shared prefix kp/vp [Sp, KH, D];
    suffixes ks/vs [B, Ss, KH, D]; lens [B]."""
    return _prefix(q, kp.transpose(0, 1), vp.transpose(0, 1),
                   ks.transpose(1, 2), vs.transpose(1, 2), lens,
                   block_k=block_k)
