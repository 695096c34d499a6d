"""Training entry point of the port (counterpart of the JAX package's
``launch/train.py``), on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt [--reduced]

Runs on the card (``--device cuda``, the default) and raises where there
is none; ``--device cpu`` with ``--reduced`` is the CPU-sized smoke run.
Parameters are random, drawn from ``--seed`` with a ``torch.Generator``
on the device. Data is the reference's synthetic LM stream (shifted
tokens of a random Markov chain, so the loss falls meaningfully).

Fault tolerance: with ``--ckpt-dir`` the state is saved every
``--ckpt-every`` steps and at the end; a run that finds a checkpoint
there resumes from its latest step ("resumed from step N"). Checkpoints
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
from ..train import (TrainConfig, init_state, latest_step, make_train_step,
                     restore_checkpoint, save_checkpoint)
from ..train.optimizer import AdamWConfig
from ..train.train_loop import TrainState


def synthetic_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                      n_states: int = 64, branching: int = 4,
                      device="cpu") -> Iterator[dict]:
    """Markov-chain token stream, the reference's arrays from the same
    numpy seed: each token depends on the previous one through a fixed
    random table, so the loss can fall to ln(branching). Yields
    {"tokens", "labels"} int32 [batch, seq] on ``device``."""
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
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """Train (or resume) as the flags say; returns the final state."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (with "
                           "--reduced) to train on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    api = zoo.build(cfg)
    tc = TrainConfig(adamw=AdamWConfig(lr=args.lr),
                     warmup_steps=max(args.steps // 20, 1),
                     total_steps=args.steps,
                     grad_accum=args.grad_accum,
                     compress_grads=args.compress_grads)
    step_fn = make_train_step(api, tc)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state = TrainState.from_dict(restore_checkpoint(args.ckpt_dir,
                                                        device=device))
        start = int(state.step)
        print(f"resumed from step {start}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = init_state(api.init(gen, device), tc)

    data = synthetic_batches(cfg.vocab_size, args.batch, args.seq,
                             args.seed, device=device)
    t0 = time.time()
    for i in range(start, args.steps):
        state, metrics = step_fn(state, next(data))
        if (i + 1) % args.log_every == 0 or i == start:
            print(f"step {i+1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, state.as_dict(), i + 1)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, state.as_dict(), args.steps)
    print("done")
    return state


if __name__ == "__main__":
    main()
