"""Data-parallel and FSDP training over a mesh (counterpart of the JAX
package's train CLI, which lays its ``TrainState`` out by
``train_policy`` over its host mesh and runs ``make_train_step`` under
``jax.jit``; GSPMD inserts the collectives there, explicit calls of
``launch/mesh.py`` here).

Single-controller, as the serving TP is: one process holds every
shard's tensors, each on its shard's device (shards may share a device:
that is how a mesh is emulated on the CPU or on one card).

Layout (``state_sharding``): the parameters, float32 masters, float32
moments and ``ef_error`` by ``train_policy``; int8 moments' ``q`` by the
parameter's spec and ``s`` by ``q8_scale_pspec``; ``count`` and
``step`` replicated. ``shard_state`` / ``unshard_state`` move a
``TrainState`` into that layout and back.

A step (``make_sharded_train_step``):

1. Every data row (a block of the data axes; a row's first shard
   computes for the row, the row's "model" shards read its grads)
   gathers the whole parameter tree, once a step (per-layer gathering
   is a later speed item).
2. For each microbatch (consecutive rows of the global batch, as the
   reference's ``reshape(grad_accum, mb, ...)``), each data row runs
   ``value_and_grad`` on its rows of the microbatch; the batch dim goes
   over ``dp_spec``, and a microbatch the data axes do not divide is
   replicated: every row computes all of it and nothing is summed, as
   the reference's ``set_batch_axes(None)`` rule gives. ``ModelAPI.loss``
   is a mean over the kept tokens, so each row's loss is weighted by its
   share of the microbatch's kept-token count (``loss_mask``), not
   averaged.
3. The grads are reduce-scattered over the batch's axes back to the
   state's layout (an all-reduce of the shard's block for a leaf the
   spec does not split over them), combined in float32 and cast back to
   the parameter's dtype; with ``grad_accum > 1`` each shard adds them
   into float32, as the reference's scan does.
4. Compression, clipping and AdamW run shard-locally on each shard's
   pieces. What the reference computes over a whole leaf is reduced
   across the shards first: the error-feedback absmax of a leaf (an
   all-reduce max), the global norm (each distinct block's sum of
   squares once, a leaf replicated over some axes not once per
   replica), and the int8 moments' row absmax where the spec splits the
   last dim (an all-reduce max over its axes).

The compute stays data-parallel on gathered leaves also on a mesh with
"model" > 1: tensor-parallel compute in training is not ported (no
entry point of the JAX package runs it). MoE capacity groups are per
sequence, so splitting the batch does not change which tokens a layer
drops. On a (1, 1) mesh the step gives ``make_train_step``'s bits.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..launch import mesh as M
from ..launch.mesh import Mesh, axis_size, data_axes
from ..launch.sharding import (Policy, TreeSharding, dp_spec, param_pspecs,
                               q8_scale_pspec, shard_tree, train_policy,
                               unshard_tree)
from .optimizer import (_q8_from_amax, _q8_prep, _q8_row_amax,
                        adamw_leaf, bias_corrections, clip_by_norm,
                        ef8_leaf, warmup_cosine)
from .train_loop import TrainConfig, TrainState, init_state, value_and_grad

Pytree = Any


def _paths(tree: Pytree, prefix=()) -> List[Tuple[str, ...]]:
    """Leaf paths of a pspec tree (tuples are leaves) in sorted-key
    order, the order of ``optimizer.leaves``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _get(tree: Pytree, path: Sequence[str]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _build(paths: Sequence[Tuple[str, ...]], values: Sequence) -> Dict:
    out: Dict = {}
    for path, v in zip(paths, values):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def state_sharding(specs: Pytree, mesh: Mesh, cfg: TrainConfig,
                   policy: Optional[Policy] = None) -> TreeSharding:
    """The layout of a ``TrainState.as_dict()`` of ``cfg`` over ``mesh``
    (``bridge.param_specs`` leaves; ``policy`` default
    ``train_policy(mesh)``)."""
    pp = param_pspecs(specs, mesh, policy or train_policy(mesh))

    def q8(spec, ps):
        if isinstance(spec, dict):
            return {k: q8(spec[k], ps[k]) for k in spec}
        return {"q": ps, "s": q8_scale_pspec(ps, len(spec.shape))}

    mom = q8(specs, pp) if cfg.quant_moments else pp
    tree = {"params": pp, "opt": {"m": mom, "v": mom, "master": pp,
                                  "count": ()}, "step": ()}
    if cfg.compress_grads:
        tree["ef_error"] = pp
    return TreeSharding(mesh, tree)


def shard_state(state: TrainState, sharding: TreeSharding
                ) -> List[TrainState]:
    """One ``TrainState`` a shard, each leaf its block (fresh tensors on
    the shard's device)."""
    return [TrainState.from_dict(d) for d in
            shard_tree(state.as_dict(), sharding.pspecs, sharding.mesh)]


def unshard_state(shards: Sequence[TrainState], sharding: TreeSharding,
                  device=None) -> TrainState:
    """The whole state (fresh tensors on ``device``, default shard 0's)."""
    return TrainState.from_dict(unshard_tree(
        [s.as_dict() for s in shards], sharding.pspecs, sharding.mesh,
        device))


def init_sharded_state(params: Pytree, sharding: TreeSharding,
                       cfg: TrainConfig) -> List[TrainState]:
    """``init_state`` of each shard's block of the whole ``params``: the
    same as ``shard_state(init_state(params, cfg), sharding)``, without
    the whole optimizer state on one device."""
    return [init_state(p, cfg) for p in
            shard_tree(params, sharding.pspecs["params"], sharding.mesh)]


def make_sharded_train_step(api, cfg: TrainConfig, mesh: Mesh,
                            policy: Optional[Policy] = None
                            ) -> Callable[[List[TrainState], Dict],
                                          Tuple[List[TrainState], Dict]]:
    """api: ``models.zoo.ModelAPI``. Returns train_step(shards, batch) ->
    (new shards, {"loss", "grad_norm", "lr"}), ``make_train_step``'s
    step over ``mesh``: ``shards`` one ``TrainState`` a shard laid out
    by ``train_step.sharding``; batch leaves [global_batch, ...] on any
    device; the metrics float32 scalars on shard 0's device. The given
    shards are not modified."""
    sharding = state_sharding(api.specs, mesh, cfg, policy)
    pp = sharding.pspecs["params"]
    paths = _paths(pp)
    pspecs = [_get(pp, p) for p in paths]
    holders = [set(M.holders(mesh, ps)) for ps in pspecs]
    # the axes of a leaf's last dim, over which int8 moment rows span
    ndims = [len(_get(api.specs, p).shape) for p in paths]
    row_axes = [M.entry_axes(ps[-1]) if len(ps) == nd else ()
                for ps, nd in zip(pspecs, ndims)]
    dax = data_axes(mesh)
    unit_of = [tuple(M.coords(mesh, s)[a] for a in dax)
               for s in range(mesh.size)]
    first = {}
    for s, u in enumerate(unit_of):
        first.setdefault(u, s)
    units = list(first)
    sched = warmup_cosine(cfg.adamw.lr, cfg.warmup_steps, cfg.total_steps)
    n = mesh.size
    devs = mesh.devices

    def gather(shards: Sequence[TrainState]) -> Dict[Any, Pytree]:
        out = {}
        with torch.no_grad():
            for u in units:
                dev = devs[first[u]]
                leaves = [M.gather_whole(
                    [_get(s.params, p) for s in shards],
                    _get(api.specs, p).shape, ps, mesh, dev)
                    for p, ps in zip(paths, pspecs)]
                out[u] = _build(paths, leaves)
        return out

    def row_batch(mb: Dict, bspec, s: int) -> Dict:
        dev = devs[s]
        return {k: M.block_view(v, (bspec,) + (None,) * (v.dim() - 1),
                                mesh, s).to(dev)
                for k, v in mb.items()}

    def micro(whole: Dict[Any, Pytree], mb: Dict
              ) -> Tuple[torch.Tensor, List[List[torch.Tensor]]]:
        """One microbatch: its loss on shard 0's device and every shard's
        reduced grads, a list in ``paths`` order."""
        B = next(iter(mb.values())).shape[0]
        bspec = dp_spec(mesh, B)
        bax = M.entry_axes(bspec)
        split = axis_size(mesh, bax) > 1
        mask = mb.get("loss_mask")
        total = (torch.clamp(mask.float().sum(), min=1.0)
                 if split and mask is not None else None)
        losses, grads = {}, {}
        for u in units:
            rows = row_batch(mb, bspec, first[u])
            if not split:
                w = None
            elif mask is None:
                w = 1.0 / axis_size(mesh, bax)
            else:
                w = (torch.clamp(rows["loss_mask"].float().sum(), min=1.0)
                     / total.to(devs[first[u]]))

            def loss_fn(params, b, w=w):
                loss = api.loss(params, b, remat=cfg.remat)
                return loss if w is None else loss * w
            losses[u], g = value_and_grad(loss_fn, whole[u], rows)
            grads[u] = [_get(g, p) for p in paths]
        group0 = next(g for g in M.groups(mesh, bax) if 0 in g)
        loss = None
        for s in group0:
            x = losses[unit_of[s]].to(devs[0])
            loss = x if loss is None else loss + x
        red: List[List[torch.Tensor]] = [[] for _ in range(n)]
        with torch.no_grad():
            for j, ps in enumerate(pspecs):
                parts = [grads[unit_of[s]][j] for s in range(n)]
                if set(M.spec_axes(ps)) & set(bax):
                    out = M.reduce_scatter(parts, ps, mesh, bax)
                else:
                    out = M.all_reduce([M.block_view(parts[s], ps, mesh, s)
                                        for s in range(n)], mesh, axes=bax)
                for s in range(n):
                    red[s].append(out[s])
        return loss, red

    def train_step(shards: List[TrainState], batch: Dict
                   ) -> Tuple[List[TrainState], Dict]:
        A = cfg.grad_accum
        B = next(iter(batch.values())).shape[0]
        if B % A:
            raise ValueError(f"batch {B} does not split into {A} "
                             "microbatches")
        whole = gather(shards)
        if A > 1:
            mb = B // A
            loss = torch.zeros((), dtype=torch.float32, device=devs[0])
            grads = [[torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device)
                      for g in (_get(sh.params, p) for p in paths)]
                     for sh in shards]
            for i in range(A):
                lm, red = micro(whole, {k: v[i * mb:(i + 1) * mb]
                                        for k, v in batch.items()})
                loss = loss + lm
                grads = [[a + b.float() for a, b in zip(ga, gb)]
                         for ga, gb in zip(grads, red)]
            loss = loss / A
            grads = [[g / A for g in gs] for gs in grads]
        else:
            loss, grads = micro(whole, batch)
        del whole
        with torch.no_grad():
            return update(shards, grads, loss)

    def q8_encode(xs: List[torch.Tensor], sqrt_domain: bool,
                  axes: Tuple[str, ...]) -> List[Dict[str, torch.Tensor]]:
        """Each shard's int8 {"q", "s"} of its block, the row absmax
        taken over the shards that split the rows' last dim."""
        xs = [_q8_prep(x, sqrt_domain) for x in xs]
        amax = [_q8_row_amax(x) for x in xs]
        if axes:
            amax = M.all_reduce(amax, mesh, axes=axes, op="max")
        return [_q8_from_amax(x, a) for x, a in zip(xs, amax)]

    def update(shards, grads, loss):
        errors = [None] * n
        if cfg.compress_grads:
            es = [[_get(sh.ef_error, p) for p in paths] for sh in shards]
            amax = M.all_reduce(
                [torch.stack([torch.abs(g.float() + e).max()
                              for g, e in zip(gs, el)])
                 for gs, el in zip(grads, es)], mesh, op="max")
            outs = [[ef8_leaf(g, e, a) for g, e, a in zip(gs, el, am)]
                    for gs, el, am in zip(grads, es, amax)]
            grads = [[o[0] for o in os_] for os_ in outs]
            errors = [_build(paths, [o[1] for o in os_]) for os_ in outs]
        zero = [torch.zeros((), dtype=torch.float32, device=d) for d in devs]
        sq = M.all_reduce(
            [torch.stack([torch.sum(torch.square(g.float()))
                          if s in holders[j] else zero[s]
                          for j, g in enumerate(grads[s])])
             for s in range(n)], mesh)
        norms = [torch.sqrt(sum(v[j] for j in range(len(paths))))
                 for v in sq]
        trees = [clip_by_norm(_build(paths, grads[s]), norms[s],
                              cfg.adamw.clip_norm) for s in range(n)]
        grads = [[_get(t, p) for p in paths] for t in trees]
        counts = [sh.opt["count"] + 1 for sh in shards]
        bias = [bias_corrections(c, cfg.adamw) for c in counts]
        lrs = [sched(sh.step) for sh in shards]
        quant = cfg.quant_moments
        new_p, new_m, new_v, new_w = ([[] for _ in range(n)]
                                      for _ in range(4))
        for j, p in enumerate(paths):
            outs = [adamw_leaf(grads[s][j], _get(sh.opt["m"], p),
                               _get(sh.opt["v"], p),
                               _get(sh.opt["master"], p), cfg.adamw,
                               *bias[s], lrs[s], quant)
                    for s, sh in enumerate(shards)]
            ms, vs = [o[1] for o in outs], [o[2] for o in outs]
            if quant:
                ms = q8_encode(ms, False, row_axes[j])
                vs = q8_encode(vs, True, row_axes[j])
            for s, sh in enumerate(shards):
                new_w[s].append(outs[s][0])
                new_p[s].append(outs[s][0].to(_get(sh.params, p).dtype))
                new_m[s].append(ms[s])
                new_v[s].append(vs[s])
        new = [TrainState(
            params=_build(paths, new_p[s]),
            opt={"m": _build(paths, new_m[s]), "v": _build(paths, new_v[s]),
                 "master": _build(paths, new_w[s]), "count": counts[s]},
            ef_error=errors[s], step=sh.step + 1)
            for s, sh in enumerate(shards)]
        return new, {"loss": loss, "grad_norm": norms[0], "lr": lrs[0]}

    train_step.sharding = sharding
    return train_step
