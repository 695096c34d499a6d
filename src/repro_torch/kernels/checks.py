"""What the port's CUDA kernels take, and the checks their wrappers make
before a launch. Each raises on anything else: a CUDA tensor either
reaches its kernel or the call fails."""

from __future__ import annotations

import torch

# G = H // KH the kernels are built for (6: the 48/8 heads of grok-1-314b
# and mixtral-8x22b, and their 24/4 and 12/2 head shards at TP 2 and 4)
GROUPS = (1, 2, 3, 4, 6, 8)
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def on_cuda(fn: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version's
    case) or a meta one (shapes only: the wrapper returns an empty output
    of its kernel's shape); raise for any other device."""
    if q.device.type in ("cpu", "meta"):
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {q.device.type} tensors")
    return True


def same_device_and_dtype(fn: str, q: torch.Tensor, int32=(), **ts) -> None:
    """Every tensor on q's device; q in a built dtype; the named int32
    tensors int32 and every other tensor in q's dtype."""
    for name, t in ts.items():
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"{fn}: dtype {q.dtype} not in {tuple(DTYPE_CODE)}")
    for name, t in ts.items():
        want = torch.int32 if name in int32 else q.dtype
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {want}")


def heads(fn: str, H: int, KH: int, D: int, groups=GROUPS) -> int:
    """G = H // KH, after checking that (G, D) is built."""
    if KH <= 0 or H % KH or H // KH not in groups or D not in HEAD_DIMS:
        raise ValueError(f"{fn}: H {H} / KH {KH}, D {D} not built (G in "
                         f"{groups}, D in {HEAD_DIMS})")
    return H // KH


def rows_readable(fn: str, **ts) -> None:
    """Each tensor is read (or written) through its element strides by
    16-byte vector accesses: its last dim must be contiguous and its base
    and every other stride 16-byte aligned (a dim of size 1 is never
    stepped over, so its stride does not matter)."""
    for name, t in ts.items():
        if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{fn}: {name}'s last dim is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
        item = t.element_size()
        for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
            if size > 1 and (stride * item) % 16:
                raise ValueError(f"{fn}: {name} has a stride of "
                                 f"{stride * item} bytes, not a multiple "
                                 f"of 16")


def contiguous(fn: str, **ts) -> None:
    for name, t in ts.items():
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} not contiguous")
