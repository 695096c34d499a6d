"""What the pure-decode CUDA graphs do in a served cell, on the card: one
JSON line a run. A development tool, not part of the port or of the
benchmark.

    python3 tools/decode_graph_census.py --workload <cell> --seed <n> \\
        [--seconds 51] [--census-steps 60] [--out census.jsonl]

It serves the cell's traced run (``perfbench/benchlib/cell.py``
``serve_window`` with the device slice) and reports:

  * the host syncs of engine steps (``torch.cuda.set_sync_debug_mode(
    "warn")`` around ``ClusterRuntime.step`` for the first
    ``--census-steps`` steps of the open loop), per decode and per mixed
    step, and where in the source each was called;
  * the engagement share over the window: ``decode_graph_replays`` over
    the pure-decode dispatches, ``model_dispatches`` less
    ``fused_iterations`` on the cell's paged fused engine (engine
    counters at the window's open and close);
  * the graphs' capture: seconds, graphs captured, device memory reserved
    by it;
  * in the device slice, ``paged_split_kernel`` launches against
    n_layers x the slice's steps with decode lanes, and the accepted
    per-layer readers (``perfbench/metrics``) on the slice;
  * the peak device memory and the window's end-to-end numbers (host
    clock; the census's warnings slow its steps, so these are not the
    benchmark's numbers).
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "perfbench"))
import run as R  # noqa: E402  (the benchmark's environment and paths)

COUNTERS = ("model_dispatches", "fused_iterations", "decode_graph_replays",
            "decode_graph_captures", "decode_batches")


def _site(w) -> str:
    path = Path(w.filename)
    try:
        path = path.resolve().relative_to(ROOT)
    except ValueError:
        pass
    return f"{path}:{w.lineno}"


def measure(cell, seed: int, seconds: int, census_steps: int,
            device="cuda"):
    """``device`` "cpu" rehearses the reading on a tiny cell (no sync,
    graph or device number there)."""
    import torch
    from benchlib import cell as C
    from benchlib import serve
    from benchlib.flops import Dims
    from repro_torch.serving import cluster, decode_graph

    capture = {"seconds": 0.0, "calls": 0, "reserved_bytes": 0}
    orig_capture = decode_graph.DecodeGraphs.capture

    def timed_capture(self):
        torch.cuda.synchronize()
        r0, t0 = torch.cuda.memory_reserved(), time.perf_counter()
        orig_capture(self)
        torch.cuda.synchronize()
        capture["seconds"] += time.perf_counter() - t0
        capture["calls"] += 1
        capture["reserved_bytes"] += torch.cuda.memory_reserved() - r0

    snapshot = serve.Loop._snapshot

    def with_graphs(loop):
        snap = snapshot(loop)
        snap.update((k, loop.engine.stats[k]) for k in COUNTERS
                    if k in loop.engine.stats)
        return snap

    census = {"left": -1, "steps": collections.defaultdict(list),
              "sites": collections.defaultdict(collections.Counter)}
    orig_run, orig_step = serve.Loop.run, cluster.ClusterRuntime.step

    def run(loop, profiler=None):
        census["left"] = census_steps
        census["engine"] = loop.engine
        return orig_run(loop, profiler)

    def step(self, now):
        if census["left"] <= 0:
            return orig_step(self, now)
        census["left"] -= 1
        st = census["engine"].stats
        before = (st["prefilled_tokens"],
                  st["model_dispatches"] - st["fused_iterations"])
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            if device != "cpu":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                done = orig_step(self, now)
            finally:
                if device != "cpu":
                    torch.cuda.set_sync_debug_mode(0)
        kind = ("mixed" if st["prefilled_tokens"] > before[0] else
                "decode" if (st["model_dispatches"]
                             - st["fused_iterations"]) > before[1]
                else "other")
        syncs = [w for w in got
                 if "called a synchronizing" in str(w.message)]
        census["steps"][kind].append(len(syncs))
        census["sites"][kind].update(_site(w) for w in syncs)
        return done

    with mock.patch.object(decode_graph.DecodeGraphs, "capture",
                           timed_capture), \
            mock.patch.object(serve.Loop, "_snapshot", with_graphs), \
            mock.patch.object(serve.Loop, "run", run), \
            mock.patch.object(cluster.ClusterRuntime, "step", step):
        served = C.serve_window(cell, seed, seconds, device, trace=True)
    loop = served.loop
    lo = served.t_loop + served.warm
    win = [s for s in loop.steps if lo <= s.t0 < lo + seconds]
    view = C.RunView(Dims.of(cell.config),
                     [s for s in win if not s.profiled],
                     [s for s in loop.steps if s.profiled],
                     loop.device_slice, loop.spans, loop.submit_s,
                     loop.counters)
    out = {"workload": cell.name, "seed": seed}
    res = C.e2e(loop.tracked, loop.end)
    out.update({k: res.get(k) for k in ("ttft_p95_ms", "tpot_p50_ms",
                                        "latency_mean_s", "latency_p95_s",
                                        "attempted", "failed")})
    a, b = loop.counters.get("open", {}), loop.counters.get("close", {})
    if all(k in a and k in b for k in COUNTERS):
        win_counts = {k: b[k] - a[k] for k in COUNTERS}
        disp = (win_counts["model_dispatches"]
                - win_counts["fused_iterations"])
        rep = win_counts["decode_graph_replays"]
        out["window_counters"] = win_counts
        out["engagement_share"] = rep / disp if disp else None
    out["capture"] = capture
    out["census"] = {
        kind: {"steps": len(n), "syncs_per_step": sorted(set(n)),
               "mean": sum(n) / len(n) if n else None,
               "sites": dict(census["sites"][kind].most_common(8))}
        for kind, n in census["steps"].items()}
    sl = view.device
    if sl is not None:
        n_layers = Dims.of(cell.config).n_layers
        with_lanes = sum(1 for s in view.slice_steps if s.decode_lens)
        out["paged_split_kernel"] = {
            "launches": sum(1 for n, _, _ in sl.kernels()
                            if "paged_split_kernel" in n),
            "expected": n_layers * with_lanes,
            "slice_steps": len(view.slice_steps)}
        out.update(busy_s=sl.busy_s, window_s=sl.window_s)
    out["per_layer"] = {m.name: m.read(view) for m in cell.per_layer}
    out["memory_peak_bytes"] = served.peak
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=int, default=51)
    ap.add_argument("--census-steps", type=int, default=60)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    R._env()
    import torch
    torch.set_num_threads(1)
    from benchlib import cell as C
    from benchlib.spec import load_cell
    out = measure(load_cell(args.workload), args.seed, args.seconds,
                  args.census_steps)
    out["card"] = C.power_limit()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
