"""Distributed serving entry point of the port: a Preble cluster of N
engine instances on one card, driven by a generated workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --instances 2 --requests 24 --workload toolbench --policy e2

Runs on the card (``--device cuda``, the default) unless asked for the
CPU. Without ``--reduced`` the config is served at its full width (real
forwards of randomly initialized weights, drawn from ``--seed``);
``--reduced`` applies ``configs.reduced`` for a CPU-sized smoke run.
``--arch`` takes every config of the zoo but whisper-tiny (an
encoder-decoder has no chunk extension, and the engine refuses it); the
engine serves the recurrent, hybrid and VLM stacks (rwkv6-7b,
jamba-v0.1-52b, llama-3.2-vision-11b) on the dense plane.
``--chips-per-instance 2,1`` makes instance 0 a tensor-parallel instance
over 2 devices (the mesh-of-meshes, ``serving/cluster.py``): on the CPU
the shards are emulated; on CUDA it needs as many visible cards as the
instances take in all, and raises with fewer.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, reduced
from ..core.request import Request
from ..data import assign_arrivals, gen_workload, poisson_arrivals
from ..models import zoo
from ..serving.cluster import ClusterRuntime
from ..serving.engine import EngineConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--workload", default="toolbench")
    ap.add_argument("--policy", default="e2", choices=["e2", "rr"])
    ap.add_argument("--rps", type=float, default=50.0)
    ap.add_argument("--max-context", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips-per-instance", default=None,
                    help="comma list of TP degrees, one per instance "
                         "(one value: every instance)")
    ap.add_argument("--device", default="cuda",
                    help="torch device every instance runs on")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (CPU-runnable)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace) -> Dict:
    """Build the model, the workload and the cluster (no serving yet)."""
    chips = None
    if args.chips_per_instance is not None:
        parts = [int(p) for p in str(args.chips_per_instance).split(",")]
        chips = (parts * args.instances)[:args.instances] \
            if len(parts) == 1 else parts
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    api = zoo.build(cfg)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(gen, device)

    # scale the workload's token ids + lengths down to engine size
    raw = gen_workload(args.workload, args.requests, seed=args.seed)
    scale = args.max_context // 3
    reqs = []
    for r in raw:
        toks = tuple(t % cfg.vocab_size for t in r.tokens[:scale])
        reqs.append(Request(tokens=toks,
                            max_new_tokens=min(max(r.max_new_tokens, 2), 8),
                            workload=r.workload))
    reqs = assign_arrivals(
        reqs, poisson_arrivals(len(reqs), args.rps, args.seed))

    cl = ClusterRuntime(cfg, params, num_instances=args.instances,
                        engine_cfg=EngineConfig(
                            max_context=args.max_context,
                            chunk_size=16, max_batch_tokens=64,
                            capacity_tokens=64 * args.max_context,
                            page_size=16),
                        policy=args.policy,
                        chips_per_instance=chips,
                        device=device)
    return {"cluster": cl, "requests": reqs, "cfg": cfg, "params": params,
            "device": device}


def run(args: argparse.Namespace) -> Dict:
    """Set up and serve the workload; returns ``setup``'s dict plus the
    finished requests (``done``) and the serving wall time (``wall``,
    seconds, after the device finished)."""
    res = setup(args)
    device, cl = res["device"], res["cluster"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res["done"] = cl.run(res["requests"], dt=0.01)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    res["wall"] = time.perf_counter() - t0
    return res


def report(args: argparse.Namespace, res: Dict) -> None:
    cl, done, reqs, wall = res["cluster"], res["done"], res["requests"], \
        res["wall"]
    lats = sorted(r.latency() for r in done)
    reused = sum(e.stats["reused_tokens"] for e in cl.engines.values())
    prefilled = sum(e.stats["prefilled_tokens"] for e in cl.engines.values())
    chips = [e.chips for e in cl.engines.values()]
    print(f"policy={args.policy} finished={len(done)}/{len(reqs)} "
          f"wall={wall:.1f}s device={args.device} chips={chips}")
    print(f"virtual latency avg={np.mean(lats):.3f}s "
          f"p99={lats[int(len(lats)*0.99)]:.3f}s")
    print(f"prefix reuse: {reused} tokens reused, {prefilled} prefilled "
          f"({reused/(reused+prefilled):.0%} saved)")
    for i, e in cl.engines.items():
        print(f"  engine{i}: iters={e.stats['iterations']} "
              f"decodes={e.stats['decode_steps']} "
              f"reused={e.stats['reused_tokens']}")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    res = run(args)
    report(args, res)
    return res


if __name__ == "__main__":
    main()
