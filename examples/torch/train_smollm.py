"""Train a SmolLM variant for a few hundred steps with checkpoint/restart
on the port: the end-to-end training run (the counterpart of
``examples/train_smollm.py``).

    PYTHONPATH=src python examples/torch/train_smollm.py [--steps 300] \\
        [--full] [--device cpu]

By default runs a small variant (4 layers, d 256); pass --full for the
~100M-param sibling (12 layers at smollm-360m's width, 8 x 512 tokens a
step). Runs on the card (``--device cuda``, the default) and raises where
there is none. The script deliberately drops the state and resumes from
its checkpoint halfway to demonstrate the restart path. ``run`` trains
and returns the printed lines with the figures behind them; ``main``
parses the flags, calls it and prints.
"""

import argparse
import dataclasses
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.models import zoo
from repro_torch.launch.train import synthetic_batches
from repro_torch.train import (TrainConfig, init_state, make_train_step,
                               latest_step, restore_checkpoint,
                               save_checkpoint)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainState


def variant(full):
    """(cfg, batch, seq) of the default variant or, with ``full``, of the
    ~100M-param sibling."""
    base = get_config("smollm-360m")
    if full:
        # ~100M-param smollm sibling: 12 layers of the same width
        return dataclasses.replace(base, n_layers=12), 8, 512
    return dataclasses.replace(base, n_layers=4, d_model=256,
                               n_heads=4, n_kv_heads=2, d_ff=1024,
                               vocab_size=2048, head_dim=64), 8, 128


def run(cfg, device, steps, batch, seq, params=None):
    """``steps`` train steps of ``cfg`` on ``device`` over the synthetic
    stream (``batch`` x ``seq``), dropping the state and restoring it
    from a checkpoint after half of them; ``params`` default to
    ``api.init`` from seed 0. Returns {"lines", "first_loss", "final",
    "half", "restored_step", "step_s" (the wall a step over each
    20-step span between logged losses), "ckpt_bytes"}."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    api = zoo.build(cfg)
    lines = [f"training {cfg.name} variant: {api.n_params:,} params"]

    tc = TrainConfig(adamw=AdamWConfig(lr=3e-3),
                     warmup_steps=10, total_steps=steps,
                     grad_accum=2, compress_grads=True)
    # the step leaves the state it is given alone: rebinding ``state``
    # each step frees the old one, as the reference's donation does
    step_fn = make_train_step(api, tc)
    data = synthetic_batches(cfg.vocab_size, batch, seq, seed=0,
                             device=device)

    ckpt = tempfile.mkdtemp(prefix="preble_train_")
    step_s = []

    def log(i, m, mark):
        loss = float(m["loss"])           # waits for the step
        t = time.perf_counter()
        lines.append(f"step {i+1:4d} loss={loss:.4f}")
        if mark is not None:
            step_s.append((t - mark) / 20)
        return t

    try:
        if params is None:
            params = api.init(torch.Generator(device=device).manual_seed(0),
                              device)
        state = init_state(params, tc)
        del params
        half = steps // 2
        first_loss, mark = None, None
        for i in range(half):
            state, m = step_fn(state, next(data))
            if first_loss is None:
                first_loss = float(m["loss"])
            if (i + 1) % 20 == 0:
                mark = log(i, m, mark)
        out = save_checkpoint(ckpt, state.as_dict(), half)
        ckpt_bytes = sum(f.stat().st_size for f in Path(out).iterdir())
        lines.append(f"-- checkpoint at step {half}; simulating restart --")
        del state

        state = TrainState.from_dict(restore_checkpoint(ckpt, device=device))
        restored = int(state.step)
        assert restored == half == latest_step(ckpt)
        mark = None
        for i in range(half, steps):
            state, m = step_fn(state, next(data))
            if (i + 1) % 20 == 0:
                mark = log(i, m, mark)
        final = float(m["loss"])
        lines.append(f"loss {first_loss:.3f} -> {final:.3f} "
                     f"across a checkpoint/restart boundary")
        assert final < first_loss, "loss should decrease"
        lines.append("OK")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"lines": lines, "first_loss": first_loss, "final": final,
            "half": half, "restored_step": restored, "step_s": step_s,
            "ckpt_bytes": ckpt_bytes}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--full", action="store_true",
                    help="the ~100M-param config (slow on CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on")
    args = ap.parse_args(argv)
    cfg, batch, seq = variant(args.full)
    res = run(cfg, args.device, args.steps, batch, seq)
    print("\n".join(res["lines"]))
    return res


if __name__ == "__main__":
    main()
