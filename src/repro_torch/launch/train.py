"""Training entry point of the port (counterpart of the JAX package's
``launch/train.py``), over the reference's host mesh:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt [--reduced] \\
        [--shards N]

Runs on the card (``--device cuda``, the default) and raises where there
is none; ``--device cpu`` with ``--reduced`` is the CPU-sized smoke run.
The state is laid out by ``train_policy`` over ``make_host_mesh(n)``,
("data", "model") = (n, 1), and each step is data-parallel
(``train/sharded.py``): n is ``--shards``, which stands in for XLA's
forced host device count; by default one shard a visible device (the
cards, or one CPU), as the reference takes all its devices. More shards
than devices are placed round-robin, so one card or the CPU holds
several. A batch that n does not divide is replicated, as the
reference's ``--batch % data`` rule does. Parameters are random, drawn
from ``--seed`` with a ``torch.Generator`` on the first shard's device.
Data is the reference's synthetic LM stream (shifted tokens of a random
Markov chain, so the loss falls meaningfully).

Fault tolerance: with ``--ckpt-dir`` the state is saved every
``--ckpt-every`` steps and at the end; a run that finds a checkpoint
there resumes from its latest step ("resumed from step N"), restored
onto the current mesh, whatever mesh saved it (elastic). Checkpoints
share the JAX package's format (``train/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, reduced
from ..models import zoo
from ..train import (TrainConfig, latest_step, restore_checkpoint,
                     save_checkpoint)
from ..train.optimizer import AdamWConfig
from ..train.sharded import (init_sharded_state, make_sharded_train_step,
                             unshard_state)
from ..train.train_loop import TrainState
from .mesh import make_host_mesh, visible_devices


def synthetic_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                      n_states: int = 64, branching: int = 4,
                      device="cuda") -> Iterator[dict]:
    """Markov-chain token stream, the reference's arrays from the same
    numpy seed: each token depends on the previous one through a fixed
    random table, so the loss can fall to ln(branching). Yields
    {"tokens", "labels"} int32 [batch, seq] on ``device`` (default the
    card; it raises where there is none)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to make the "
                           "batches on the CPU")
    return _markov_stream(vocab, batch, seq, seed, n_states, branching,
                          device)


def _markov_stream(vocab, batch, seq, seed, n_states, branching, device):
    rng = np.random.default_rng(seed)
    K = min(vocab, n_states)
    support = rng.choice(vocab, size=min(vocab, K * branching),
                         replace=False)
    table = support[rng.integers(0, len(support), (K, branching))]
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        for t in range(seq):
            prev = toks[:, t] % K
            pick = rng.integers(0, branching, batch)
            toks[:, t + 1] = table[prev, pick]
        t = torch.from_numpy(toks).to(device)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the host mesh (n, 1); default one a "
                         "visible device")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """Train (or resume) as the flags say; returns the final state,
    gathered whole on the first shard's device."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (with "
                           "--reduced) to train on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    api = zoo.build(cfg)
    devs = ([device] if device.index is not None
            else visible_devices(device.type))
    n = args.shards or len(devs)
    mesh = make_host_mesh(n, devices=[devs[s % len(devs)]
                                      for s in range(n)])
    tc = TrainConfig(adamw=AdamWConfig(lr=args.lr),
                     warmup_steps=max(args.steps // 20, 1),
                     total_steps=args.steps,
                     grad_accum=args.grad_accum,
                     compress_grads=args.compress_grads)
    step_fn = make_sharded_train_step(api, tc, mesh)
    layout = step_fn.sharding

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        shards = [TrainState.from_dict(d) for d in
                  restore_checkpoint(args.ckpt_dir, shardings=layout)]
        start = int(shards[0].step)
        print(f"resumed from step {start}")
    else:
        gen = torch.Generator(device=mesh.devices[0]).manual_seed(args.seed)
        shards = init_sharded_state(api.init(gen, mesh.devices[0]), layout,
                                    tc)

    data = synthetic_batches(cfg.vocab_size, args.batch, args.seq,
                             args.seed, device=mesh.devices[0])
    t0 = time.time()
    for i in range(start, args.steps):
        shards, metrics = step_fn(shards, next(data))
        if (i + 1) % args.log_every == 0 or i == start:
            print(f"step {i+1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, [s.as_dict() for s in shards],
                            i + 1, shardings=layout)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, [s.as_dict() for s in shards],
                        args.steps, shardings=layout)
    print("done")
    return unshard_state(shards, layout)


if __name__ == "__main__":
    main()
