"""Optimizer substrate of the port (counterpart of the JAX package's
``train/optimizer.py``): AdamW with float32 master math over the model's
parameters, global-norm clipping, the warmup-cosine schedule and int8
error-feedback gradient compression, on nested dicts of tensors.

The arithmetic is the reference's, step for step, not
``torch.optim.AdamW``'s: the bias corrections are ``1 - b ** count`` in
float32 (``count`` an int32 tensor, cast as the reference casts it), the
masters are float32 whatever the parameters' dtype, and the moments are
float32 or int8 with a float32 scale a row (``quant_moments``). Python
scalars meet float32 tensors as the reference's weakly typed scalars
do: the op runs in float32. ``torch.round`` rounds half to even, as
``jnp.round`` does.

Error-feedback int8: each step quantizes (grad + carried error) to int8
with one scale a leaf and carries the quantization error into the next
step. The int8 tensor is the wire format of a data-parallel reduce; on
one device the transform still runs, so convergence behaviour matches a
sharded run.

Trees are walked in sorted-key order (the order of ``jax.tree.leaves``
on dicts), so sums over leaves add in the reference's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Pytree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree: Pytree) -> List[torch.Tensor]:
    """The tensors of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """fn over the leaves of ``tree`` and the matching entries of
    ``rest``; an entry of ``rest`` whose counterpart in ``tree`` is a
    leaf is passed whole (a {"q","s"} moment is one slot, as
    ``flatten_up_to`` makes it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------

# 8-bit moments (per-row absmax scaling): v is quantized in the SQRT
# domain (dequantization squares it back: half the dynamic range), and
# the normalised update is clipped elementwise, so a moment that
# quantized to 0 cannot produce an unbounded step.
UPDATE_CLIP = 3.0


def _q8_prep(x: torch.Tensor, sqrt_domain: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0.0)) if sqrt_domain else x


def _q8_row_amax(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=-1, keepdim=True)


def _q8_from_amax(x: torch.Tensor, amax: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """int8 {"q", "s"} of the prepared ``x`` from its rows' absmax."""
    s = amax / 127.0 + 1e-20
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def _q8_enc(x: torch.Tensor, sqrt_domain: bool = False
            ) -> Dict[str, torch.Tensor]:
    x = _q8_prep(x, sqrt_domain)
    return _q8_from_amax(x, _q8_row_amax(x))


def _q8_dec(e: Dict[str, torch.Tensor], sqrt_domain: bool = False
            ) -> torch.Tensor:
    x = e["q"].float() * e["s"]
    return torch.square(x) if sqrt_domain else x


def _q8_zeros(p: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
            "s": torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32,
                             device=p.device)}


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Pytree, quant_moments: bool = False
               ) -> Dict[str, Pytree]:
    """float32 master weights (a bf16 parameter would drop sub-ulp
    updates) and moments: float32, or int8 {"q", "s"} when
    ``quant_moments``; ``count`` an int32 scalar on the parameters'
    device."""
    mk = _q8_zeros if quant_moments else _zeros32
    dev = leaves(params)[0].device
    return {"m": tree_map(mk, params), "v": tree_map(mk, params),
            "master": tree_map(lambda p: p.detach().float().clone(), params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def bias_corrections(count: torch.Tensor, cfg: AdamWConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1 - b1 ** count and 1 - b2 ** count in float32."""
    cf = count.float()
    return (1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf),
            1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf))


def adamw_leaf(g, m, v, w, cfg: AdamWConfig, b1c, b2c, lr, quant: bool):
    """One leaf's AdamW step on its float32 master ``w``: (new master,
    new m, new v), the moments float32 (not yet re-encoded when
    ``quant``)."""
    if quant:
        m = _q8_dec(m)
        v = _q8_dec(v, sqrt_domain=True)
    g32 = g.float()
    m = cfg.b1 * m + (1 - cfg.b1) * g32
    v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
    mh = m / b1c
    vh = v / b2c
    norm = mh / (torch.sqrt(vh) + cfg.eps)
    if quant:
        norm = torch.clamp(norm, -UPDATE_CLIP, UPDATE_CLIP)
    step = norm + cfg.weight_decay * w
    return w - lr * step, m, v


def adamw_update(grads: Pytree, state: Dict[str, Pytree], params: Pytree,
                 cfg: AdamWConfig, lr: torch.Tensor, *, quant: bool = False
                 ) -> Tuple[Pytree, Dict[str, Pytree]]:
    """Returns (new_params, new_state): all math on the float32 masters,
    the new parameters the masters cast to each parameter's dtype.
    ``quant`` must match adamw_init's ``quant_moments``. Runs without
    autograd; no input is modified."""
    with torch.no_grad():
        count = state["count"] + 1
        b1c, b2c = bias_corrections(count, cfg)

        def upd(g, m, v, w, p):
            w, m, v = adamw_leaf(g, m, v, w, cfg, b1c, b2c, lr, quant)
            if quant:
                m, v = _q8_enc(m), _q8_enc(v, sqrt_domain=True)
            return w.to(p.dtype), m, v, w

        outs = tree_map(upd, grads, state["m"], state["v"],
                        state["master"], params)

    return _pick(outs, 0), {"m": _pick(outs, 1), "v": _pick(outs, 2),
                            "master": _pick(outs, 3), "count": count}


def _pick(tree, i: int):
    """Field i of every 4-tuple at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------

def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves added
    in sorted-key order from 0 (the reference's Python ``sum``)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_norm(grads: Pytree, norm: torch.Tensor, max_norm: float
                 ) -> Pytree:
    """The grads scaled by min(1, max_norm / norm), each in its dtype."""
    with torch.no_grad():
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


def clip_by_global_norm(grads: Pytree, max_norm: float
                        ) -> Tuple[Pytree, torch.Tensor]:
    with torch.no_grad():
        norm = global_norm(grads)
    return clip_by_norm(grads, norm, max_norm), norm


# ---------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------

def ef8_init(params: Pytree) -> Pytree:
    return tree_map(_zeros32, params)


def _quant_roundtrip(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 q and the scale of ``x``: one scale from the absmax of the
    whole leaf (``amax`` when given: a sharded leaf's, over its shards)."""
    if amax is None:
        amax = torch.abs(x).max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef8_leaf(g: torch.Tensor, e: torch.Tensor,
             amax: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantized grad in g's dtype, new float32 error) of one leaf;
    ``amax``: the absmax of the whole leaf's g + e, where the leaf is
    sharded."""
    x = g.float() + e
    q, scale = _quant_roundtrip(x, amax)
    deq = q.float() * scale
    return deq.to(g.dtype), x - deq


def ef8_compress(grads: Pytree, error: Pytree) -> Tuple[Pytree, Pytree]:
    """Quantize (grad + error) to int8; returns (dequantized grads in
    each grad's dtype, new float32 error). The int8 tensor is the wire
    format of the data-parallel reduce."""
    with torch.no_grad():
        outs = tree_map(ef8_leaf, grads, error)
    return _pick(outs, 0), _pick(outs, 1)


# ---------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an int tensor) -> the float32 learning rate: linear warmup
    to ``base_lr``, then a cosine to ``final_frac * base_lr`` at
    ``total``."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(torch.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return sched
