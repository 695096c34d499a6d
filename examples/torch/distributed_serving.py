"""Distributed serving end-to-end on the port: the paper in miniature
(the counterpart of ``examples/distributed_serving.py``).

4 logical instances, real forwards, ToolBench-style shared-prefix
load. Compares Preble's E2 scheduler against round-robin data
parallelism (the paper's baseline), then demonstrates fault tolerance:
an instance dies mid-run and its requests are re-scheduled.

    PYTHONPATH=src python examples/torch/distributed_serving.py \\
        [--device cpu]

Runs on the card (``--device cuda``, the default; the 4 instances share
it) and raises where there is none. ``run(cfg, device, params)`` serves
and returns the printed lines with the figures behind them; ``main``
parses the flags, calls it on the reduced 2-layer config and prints.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.request import Request
from repro_torch.data import assign_arrivals, poisson_arrivals
from repro_torch.models import zoo
from repro_torch.serving.cluster import ClusterRuntime
from repro_torch.serving.engine import EngineConfig


def toolbench_mini(n, vocab, rng, n_tools=4):
    """Tool-calling structure at engine scale: shared system prompt +
    per-tool instructions + unique question."""
    system = tuple(rng.integers(1, vocab, 16).tolist())
    tools = [tuple(rng.integers(1, vocab, 24).tolist())
             for _ in range(n_tools)]
    reqs = []
    for i in range(n):
        tool = tools[rng.integers(0, n_tools)]
        q = tuple(rng.integers(1, vocab, 8).tolist())
        reqs.append(Request(tokens=system + tool + q, max_new_tokens=4,
                            workload="toolbench"))
    return reqs


def run_policy(policy, cfg, params, reqs, device):
    cl = ClusterRuntime(cfg, params, num_instances=4,
                        engine_cfg=EngineConfig(
                            max_context=96, chunk_size=16,
                            max_batch_tokens=64, capacity_tokens=8192,
                            page_size=16),
                        policy=policy, device=device)
    t0 = time.perf_counter()
    done = cl.run(list(reqs), dt=0.01)
    wall = time.perf_counter() - t0
    reused = sum(e.stats["reused_tokens"] for e in cl.engines.values())
    pre = sum(e.stats["prefilled_tokens"] for e in cl.engines.values())
    lats = sorted(r.latency() for r in done)
    return {"done": len(done), "reuse_frac": reused / (reused + pre),
            "avg_lat": float(np.mean(lats)),
            "p99_lat": lats[int(len(lats) * 0.99)], "cluster": cl,
            "wall": wall}


def run(cfg, device, params=None):
    """E2 and round-robin over 4 instances of ``cfg`` on ``device``, then
    the failover; ``params`` default to ``api.init`` from seed 0.
    Returns {"lines", "results" (per policy: the printed figures, the
    cluster and its host wall), "rerouted", "extra"}."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    api = zoo.build(cfg)
    if params is None:
        params = api.init(torch.Generator(device=device).manual_seed(0),
                          device)
    rng = np.random.default_rng(1)

    reqs = toolbench_mini(24, cfg.vocab_size, rng)
    times = poisson_arrivals(len(reqs), rps=100.0, seed=2)

    lines = ["== E2 (Preble) vs round-robin, 4 instances, real forwards =="]
    results = {}
    for policy in ("e2", "rr"):
        rs = assign_arrivals(toolbench_mini(24, cfg.vocab_size,
                                            np.random.default_rng(1)),
                             times)
        results[policy] = run_policy(policy, cfg, params, rs, device)
        r = results[policy]
        lines.append(f"  {policy}: finished={r['done']} "
                     f"prefill-saved={r['reuse_frac']:.0%} "
                     f"avg={r['avg_lat']:.3f}s p99={r['p99_lat']:.3f}s")
    assert results["e2"]["reuse_frac"] >= results["rr"]["reuse_frac"], \
        "E2 should reuse at least as much prefix compute as RR"

    lines.append("== failover: kill instance 0 mid-run ==")
    cl = results["e2"]["cluster"]
    extra = toolbench_mini(8, cfg.vocab_size, rng)
    for r in extra:
        cl.submit(r, 100.0)
    cl.step(100.0)
    n_rerouted = cl.fail_instance(0, 100.1)
    t = 100.2
    while any(r.state.value != "finished" for r in extra):
        cl.step(t)
        t += 0.01
    lines.append(f"  rerouted {n_rerouted} in-flight requests; "
                 f"all {len(extra)} finished on surviving instances")
    lines.append("OK")
    return {"lines": lines, "results": results, "rerouted": n_rerouted,
            "extra": extra}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the 4 instances share")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(reduced(get_config("smollm-360m")),
                              n_layers=2)
    res = run(cfg, args.device)
    print("\n".join(res["lines"]))
    return res


if __name__ == "__main__":
    main()
