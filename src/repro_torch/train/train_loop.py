"""The train step of the port (counterpart of the JAX package's
``train/train_loop.py``): remat'd loss, gradient accumulation, int8
error-feedback compression, global-norm clipping and AdamW, as one
function of (state, batch) on one device.

The dtype flow is the reference's. With ``grad_accum == 1`` the grads
stay in each parameter's dtype (bf16 for a bf16 model) through
compression and clipping; with ``grad_accum > 1`` the microbatches' grads
sum into float32 and stay float32 through compression and the clip. The
optimizer step and the parameter update run without autograd.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        clip_by_global_norm, ef8_compress, ef8_init, leaves,
                        tree_map, warmup_cosine)

Pytree = Any


@dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_accum: int = 1             # microbatches per step
    compress_grads: bool = False    # int8 error-feedback
    quant_moments: bool = False     # int8 AdamW moments (8-bit Adam)
    remat: bool = True


@dataclass
class TrainState:
    params: Pytree
    opt: Dict[str, Pytree]
    ef_error: Optional[Pytree]
    step: torch.Tensor              # int32 scalar

    def as_dict(self) -> Dict:
        d = {"params": self.params, "opt": self.opt, "step": self.step}
        if self.ef_error is not None:
            d["ef_error"] = self.ef_error
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "TrainState":
        return cls(params=d["params"], opt=d["opt"],
                   ef_error=d.get("ef_error"), step=d["step"])


def init_state(params: Pytree, cfg: TrainConfig) -> TrainState:
    dev = leaves(params)[0].device
    return TrainState(
        params=params,
        opt=adamw_init(params, quant_moments=cfg.quant_moments),
        ef_error=ef8_init(params) if cfg.compress_grads else None,
        step=torch.zeros((), dtype=torch.int32, device=dev))


def value_and_grad(loss_fn: Callable, params: Pytree, batch: Dict
                   ) -> Tuple[torch.Tensor, Pytree]:
    """(loss, d loss / d params): the grads a tree like ``params``, each
    leaf in its parameter's dtype (zeros for a leaf the loss does not
    read, as the reference's); the loss detached."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(ps, batch)
    gs = torch.autograd.grad(loss, leaves(ps), allow_unused=True,
                             materialize_grads=True)
    return loss.detach(), _fill(ps, iter(gs))


def _fill(tree: Pytree, it) -> Pytree:
    """A tree like ``tree`` whose leaves are taken from ``it`` in
    ``leaves`` (sorted-key) order."""
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    return next(it)


def make_train_step(api, cfg: TrainConfig
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    """api: ``models.zoo.ModelAPI``. Returns train_step(state, batch) ->
    (new_state, {"loss", "grad_norm", "lr"}), float32 scalars on the
    state's device. Batch leaves are [global_batch, ...]; with
    ``grad_accum > 1`` the batch dim splits into that many microbatches,
    run one after another. The given state is not modified."""
    sched = warmup_cosine(cfg.adamw.lr, cfg.warmup_steps, cfg.total_steps)

    def loss_fn(params, mb):
        return api.loss(params, mb, remat=cfg.remat)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if cfg.grad_accum > 1:
            mbs = [{k: v.reshape(cfg.grad_accum, v.shape[0]
                                 // cfg.grad_accum, *v.shape[1:])[i]
                    for k, v in batch.items()}
                   for i in range(cfg.grad_accum)]
            dev = state.step.device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            for mb in mbs:
                lm, g = value_and_grad(loss_fn, state.params, mb)
                loss = loss + lm
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
            loss = loss / cfg.grad_accum
            grads = tree_map(lambda g: g / cfg.grad_accum, grads)
        else:
            loss, grads = value_and_grad(loss_fn, state.params, batch)

        ef_error = state.ef_error
        if cfg.compress_grads:
            grads, ef_error = ef8_compress(grads, ef_error)
        grads, gnorm = clip_by_global_norm(grads, cfg.adamw.clip_norm)
        lr = sched(state.step)
        params, opt = adamw_update(grads, state.opt, state.params,
                                   cfg.adamw, lr, quant=cfg.quant_moments)
        new_state = TrainState(params=params, opt=opt, ef_error=ef_error,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
