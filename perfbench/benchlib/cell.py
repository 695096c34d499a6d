"""One run of one cell: set-up, the measured window, the check, the
result line's contents."""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, devtrace, model, serve, stats, traffic
from .flops import Dims
from .spec import Cell

DRAIN_LIMIT = 60.0          # seconds past the close a window request may take
PROFILE_STEPS = 16          # steps in the traced run's device slice ...
PROFILE_SECONDS = 8.0       # ... or its seconds, whichever ends first
PROFILE_AT = 0.5            # where in the window the slice starts


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class RunView:
    """What a per-layer metric's reader is given."""
    dims: Dims
    steps: List[serve.StepRecord]        # the window's unprofiled steps
    slice_steps: List[serve.StepRecord]  # the steps of the device slice
    device: Optional[devtrace.DeviceSlice]
    spans: List[Tuple[str, float, float]]
    submit_s: List[float]
    counters: Dict[str, Dict[str, float]]   # summed over the instances
    chips: int = 1                          # cards, one instance each
    requests: Dict[str, Any] = field(default_factory=dict)  # e2e()


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def build(cell: Cell, seed: int, device):
    """The run's weights and the program's cluster: one paged fused
    engine instance a chip under E2, as every cell serves. With one chip
    the instance runs on ``device``; with ``chips`` n, n single-card
    instances on the first n cards (on the CPU, n instances beside each
    other), the weights drawn on the first and copied to the others."""
    from repro_torch.core.cost_model import cost_model_for
    from repro_torch.serving.cluster import ClusterRuntime
    from repro_torch.serving.engine import EngineConfig
    pcfg = model.port_config(cell.config, cell.config_name)
    params = model.make_weights(pcfg, cell.config, seed, device)
    eng = cell.config["engine"]
    econf = EngineConfig(
        max_context=eng["max_context"], chunk_size=eng["chunk_size"],
        max_batch_tokens=eng["max_batch_tokens"],
        max_batch_requests=eng["max_batch_requests"],
        capacity_tokens=eng["capacity_tokens"], page_size=eng["page_size"],
        paged=True)
    kw = {}
    if cell.chips > 1:
        kw = dict(chips_per_instance=[1] * cell.chips,
                  devices=(["cpu"] * cell.chips if device == "cpu" else
                           [f"cuda:{c}" for c in range(cell.chips)]))
    return params, ClusterRuntime(pcfg, params, cell.chips, econf,
                                  cost_model=cost_model_for("mistral-7b"),
                                  policy="e2", device=device, **kw)


def serve_to_end(cluster, reqs, max_steps: int = 100000) -> None:
    """Submit every request at once and step until each has finished."""
    for r in reqs:
        cluster.submit(r, 0.0)
    for _ in range(max_steps):
        if all(len(r.output_tokens) >= r.max_new_tokens for r in reqs):
            return
        cluster.step(0.0)
    raise RuntimeError("requests served before the clock did not finish")


def first_requests(cluster, make_request, vocab: int, seed: int,
                   rounds: int = 4) -> None:
    """Serve two short requests an instance to the end before the clock
    starts, so the program's kernels are built and loaded on every card
    in set-up. E2 spreads requests that share nothing over the
    instances; where an instance still served nothing, serve another
    round, and after ``rounds`` fail set-up: that instance would load
    its kernels inside the window."""
    rng = np.random.default_rng([seed, 4])
    for _ in range(rounds):
        serve_to_end(cluster, [
            make_request(tuple(int(t) for t in rng.integers(0, vocab, 40)),
                         4)
            for _ in range(2 * len(cluster.engines))])
        idle = [i for i, e in cluster.engines.items()
                if not e.stats["iterations"]]
        if not idle:
            return
    raise RuntimeError(f"instances {idle} served nothing in set-up")


def prime(cluster, make_request, planned) -> List[Any]:
    """Serve the plan's prime phase to the end; return the timed rest."""
    serve_to_end(cluster, [make_request(p.tokens, p.max_new)
                           for p in planned if p.phase == "prime"])
    return [p for p in planned if p.phase != "prime"]


def e2e(tracked: List[serve.Tracked], end: float) -> Dict[str, Any]:
    """The end-to-end numbers of the window's requests: every one counts,
    an unfinished one with what it had waited when the run ended."""
    win = [t for t in tracked if t.phase == "window"]
    ttft, lat, gaps, late = [], [], [], []
    for t in win:
        ttft.append((t.stamps[0] if t.stamps else end) - t.due)
        lat.append((t.stamps[-1] if t.ok else end) - t.due)
        gaps.extend(np.diff(t.stamps).tolist())
        late.append(t.late)
    out = {"attempted": len(win), "failed": sum(not t.ok for t in win)}
    if win:
        out.update(ttft_p95_ms=stats.percentile(ttft, 95) * 1e3,
                   latency_mean_s=stats.mean(lat),
                   latency_p95_s=stats.percentile(lat, 95),
                   ttft_beyond=stats.beyond(ttft, 95),
                   late_p95_ms=stats.percentile(late, 95) * 1e3,
                   late_max_ms=max(late) * 1e3)
    if gaps:
        out.update(tpot_mean_ms=stats.mean(gaps) * 1e3,
                   tpot_p50_ms=stats.percentile(gaps, 50) * 1e3,
                   tpot_p95_ms=stats.percentile(gaps, 95) * 1e3,
                   tpot_samples=len(gaps))
    if win:
        out.update(ttft_p50_ms=stats.percentile(ttft, 50) * 1e3)
    return out


@dataclass
class Served:
    """What ``serve_window`` leaves: the run's weights, the loop with its
    records (it holds the cluster), the loop clock's origin, the warm
    phase's length and the device memory peak."""
    params: Any
    loop: serve.Loop
    t_loop: float
    warm: float
    peak: int


def serve_window(cell: Cell, seed: int, seconds: int, device="cuda",
                 trace: bool = False, rate: Optional[float] = None
                 ) -> Served:
    """Set-up and the window, as every run serves them: weights and the
    cluster, two first requests, the mix's prime phase, then the warm
    phase and the window open loop until every window request is done
    (or ``DRAIN_LIMIT`` past the close). ``rate`` replaces the mix's
    (a knee sweep); ``trace`` records spans and a device slice."""
    from repro_torch.core.request import Request
    from repro_torch.models import layers
    cfg, mix = cell.config, cell.traffic
    if rate is not None:
        mix = dict(mix, rate_rps=rate)
    t = time.perf_counter()
    params, cluster = build(cell, seed, device)
    log(f"weights and engine: {time.perf_counter() - t:.3f} s")

    def make_request(tokens, max_new):
        return Request(tokens=tokens, max_new_tokens=max_new)

    t = time.perf_counter()
    first_requests(cluster, make_request, cfg["vocab_size"], seed)
    log(f"first requests: {time.perf_counter() - t:.3f} s")
    planned = traffic.plan(mix, seed, seconds, cfg["vocab_size"],
                           cfg["engine"]["max_context"])
    t = time.perf_counter()
    planned = prime(cluster, make_request, planned)
    log(f"prime: {time.perf_counter() - t:.3f} s")
    warm = float(mix["warm_seconds"])
    profiler = None
    if trace:
        dtype = torch.device(device).type
        devtrace.warm(dtype)
        profiler = devtrace.DeviceProfiler(dtype, cell.chips)
    routed = cluster.engines[0].model_cfg.n_experts
    loop = serve.Loop(
        cluster, make_request, planned,
        (warm, warm + seconds), DRAIN_LIMIT, trace=trace,
        profile_at=warm + PROFILE_AT * seconds, profile_steps=PROFILE_STEPS,
        profile_seconds=PROFILE_SECONDS,
        moe_stats=layers.MOE_STATS if routed else None)
    del cluster
    # the plan and set-up's objects stay out of the collector's passes
    # while the clock runs
    gc.collect()
    gc.freeze()
    t_loop = time.perf_counter()
    try:
        loop.run(profiler)
    finally:
        gc.unfreeze()
    if device != "cpu":
        # the fullest card's
        peak = 0
        for c in range(cell.chips):
            torch.cuda.synchronize(c)
            peak = max(peak, torch.cuda.max_memory_allocated(c))
    else:
        peak = 0
    return Served(params, loop, t_loop, warm, int(peak))


def free_program(device) -> None:
    """Return the freed program state's memory before the reference
    runs."""
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: int, trace: bool, t_start: float,
        device="cuda") -> Dict[str, Any]:
    cfg = cell.config
    served = serve_window(cell, seed, seconds, device, trace)
    loop, params, peak = served.loop, served.params, served.peak
    setup_s = served.t_loop + served.warm - t_start
    res = e2e(loop.tracked, loop.end)
    log(f"window: {res['attempted']} requests due, {res['failed']} failed, "
        f"{res.get('tpot_samples', 0)} token gaps, "
        f"{res.get('ttft_beyond', 0)} beyond the TTFT p95; generator late "
        f"p95 {res.get('late_p95_ms', 0):.3f} ms, max "
        f"{res.get('late_max_ms', 0):.3f} ms; loop ended at "
        f"{loop.end:.3f} s")

    view = None
    if trace:
        lo = served.t_loop + served.warm
        hi = lo + seconds
        win = [s for s in loop.steps if lo <= s.t0 < hi]
        view = RunView(Dims.of(cfg), [s for s in win if not s.profiled],
                       [s for s in loop.steps if s.profiled],
                       loop.device_slice, loop.spans, loop.submit_s,
                       loop.counters, cell.chips, res)
        bad = sum(not s.counted for s in win)
        log(f"{len(win)} window steps, {len(view.slice_steps)} in the "
            f"device slice; {bad} whose chunk starts were inferred apart "
            "from the engine's own reuse")

    # the check, once the program's state is freed
    done = [t.req for t in loop.tracked if t.phase == "window" and t.ok]
    del served, loop
    free_program(device)
    t = time.perf_counter()
    chk = cfg["check"]
    sample = check.draw_sample(done, seed, chk["sample_tokens"])
    if sample:
        ref = check.reference_logits(cell.reference, params, cfg, sample,
                                     "float32")
        numbers = check.served_gaps(sample, ref)
        correct, compared = check.judge(numbers, chk["limits"],
                                        res["failed"])
    else:
        numbers, correct = {"tokens": 0}, False
        compared = {"served": {"value": 0, "limit": 1}}
    log(f"reference over {len(sample)} requests, {numbers['tokens']} "
        f"served tokens: {time.perf_counter() - t:.3f} s")

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = m.read(view)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] != "setup_s" and m["name"] in res:
                metrics[m["name"]] = {"value": res[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if device != "cpu"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": res["attempted"],
                           "failed": res["failed"], "metrics": metrics,
                           "device": dev}
    if trace and view.device is not None:
        sl = view.device
        dev.update(busy_s=sl.busy_s, window_s=sl.window_s)
        ops = sorted(sl.time_by_name().items(), key=lambda kv: -kv[1][0])
        idle = sorted(sl.idle_by_host(view.spans).items(),
                      key=lambda kv: -kv[1])
        out["breakdown"] = {
            "device_ops": [[k[:160], v[0]] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in idle[:10]]}
    # more of the window, for reading: the TTFT median, the token gaps'
    # mean and tail (not gated: the 95th percentile falls between the
    # decode steps' and the fused steps' modes, PERF.md) and how late
    # the generator submitted
    out["window"] = {k: res[k] for k in (
        "ttft_p50_ms", "tpot_mean_ms", "tpot_p95_ms", "tpot_samples",
        "late_p95_ms", "late_max_ms") if k in res}
    out["compared"] = compared
    return out
