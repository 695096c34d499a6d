"""Quickstart on the port: serve a (reduced) SmolLM on one Preble engine
with batched requests and prefix caching, the 60-second tour of the API
(the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Runs on the card (``--device cuda``, the default) and raises where there
is none. ``run(cfg, device, params)`` serves and returns the printed
lines with the figures behind them; ``main`` parses the flags, calls it
on the reduced config and prints.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.request import Request
from repro_torch.models import zoo
from repro_torch.serving.engine import Engine, EngineConfig


def run(cfg, device, params=None):
    """Serve the example's 8 requests on one engine of ``cfg`` on
    ``device``; ``params`` default to ``api.init`` from seed 0. Returns
    {"lines", "saved", "done", "engine"}."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    # 1. pick an architecture (--arch would resolve the same way)
    api = zoo.build(cfg)
    if params is None:
        params = api.init(torch.Generator(device=device).manual_seed(0),
                          device)
    size = "" if cfg == get_config(cfg.name) else " (reduced)"
    lines = [f"model: {cfg.name}{size} — {api.n_params:,} params"]

    # 2. one engine = one model instance + local iteration scheduler
    eng = Engine(cfg, params, EngineConfig(
        instance_id=0, max_context=96, chunk_size=16,
        max_batch_tokens=96, capacity_tokens=8192, page_size=16),
        device=device)

    # 3. a batch of requests sharing a 30-token system prompt
    rng = np.random.default_rng(0)
    system = tuple(rng.integers(1, cfg.vocab_size, 30).tolist())
    reqs = [Request(tokens=system
                    + tuple(rng.integers(1, cfg.vocab_size, 6).tolist()),
                    max_new_tokens=6) for _ in range(8)]

    # 4. run the continuous-batching loop; the first request populates
    #    the radix cache, the rest arrive as it completes and hit it
    now, done = 0.0, []
    eng.scheduler.enqueue(reqs[0], now)
    while not done:
        done += eng.step(now)
        now += 0.01
    for r in reqs[1:]:
        eng.scheduler.enqueue(r, now)
    while len(done) < len(reqs):
        done += eng.step(now)
        now += 0.01

    for r in done[:4]:
        lines.append(f"req {r.request_id}: cached {r.cached_len}/"
                     f"{r.prompt_len} prompt tokens -> output "
                     f"{r.output_tokens}")
    st = eng.stats
    saved = st["reused_tokens"] / (st["reused_tokens"]
                                   + st["prefilled_tokens"])
    lines.append(f"prefix cache saved {saved:.0%} of prefill compute "
                 f"({st['reused_tokens']} tokens reused)")
    assert saved > 0.4, "expected significant prefix reuse"
    lines.append("OK")
    return {"lines": lines, "saved": saved, "done": done, "engine": eng}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on")
    args = ap.parse_args(argv)
    res = run(reduced(get_config("smollm-360m")), args.device)
    print("\n".join(res["lines"]))
    return res


if __name__ == "__main__":
    main()
