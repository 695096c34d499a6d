"""Where an engine step's time goes: a cell served as a traced run serves
its window (``cell.serve_window``, the device slice included), with the
program's telemetry attached to the cluster, and the step split by the
program's own host spans (``benchlib/spans.py``). One JSON line a run.

    python3 perfbench/step_phases.py --workload <cell> --seed <n> \
        [--seconds 51] [--telemetry 1] [--out phases.jsonl]

It fills in what a benchmark run does not carry yet: a ``Telemetry``
passed to ``ClusterRuntime`` and the fused dispatches' slot counters read
at the window's open and close. ``--telemetry 0`` serves the same traced
run without the Telemetry, for what the spans cost: compare its
``step_ms.*`` and ``route_ms`` (the accepted readers) with a
``--telemetry 1`` run's. Run on the card; a tool for reading the program,
not a part of any run.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from unittest import mock

import run as R

COUNTERS = ("fused_padded_tokens", "fused_slot_tokens")


def measure(cell, seed: int, seconds: int, device="cuda",
            telemetry: bool = True):
    from benchlib import cell as C
    from benchlib import serve, spans as S
    from benchlib.stats import percentile
    from benchlib.flops import Dims
    from repro_torch.serving import cluster
    from repro_torch.serving.telemetry import Telemetry

    tel = Telemetry() if telemetry else None
    snapshot = serve.Loop._snapshot

    def with_slots(loop):
        snap = snapshot(loop)
        engines = loop.cluster.engines.values()
        snap.update(serve.engine_sums(loop.cluster, [
            k for k in COUNTERS if all(k in e.stats for e in engines)]))
        return snap

    with mock.patch.object(cluster, "ClusterRuntime", functools.partial(
            cluster.ClusterRuntime, telemetry=tel)), \
            mock.patch.object(serve.Loop, "_snapshot", with_slots):
        served = C.serve_window(cell, seed, seconds, device, trace=True)
    loop = served.loop
    lo = served.t_loop + served.warm
    win = [s for s in loop.steps if lo <= s.t0 < lo + seconds]
    view = C.RunView(Dims.of(cell.config), [s for s in win if not s.profiled],
                     [s for s in loop.steps if s.profiled],
                     loop.device_slice, loop.spans, loop.submit_s,
                     loop.counters, cell.chips)
    res = C.e2e(loop.tracked, loop.end)
    out = {"workload": cell.name, "seed": seed, "telemetry": telemetry}
    out.update({k: res.get(k) for k in ("ttft_p95_ms", "tpot_p50_ms",
                                        "latency_mean_s", "attempted",
                                        "failed")})
    for m in cell.per_layer:
        if m.name in ("step_ms.mixed", "step_ms.decode", "route_ms",
                      "device_idle_share", "launches_per_step",
                      "moe_syncs_per_step"):
            out[m.name] = m.read(view)
    prog = tel.spans if tel is not None else []
    within = S.Within(prog)
    out["steps"] = {k: sum(s.kind == k for s in view.steps)
                    for k in ("mixed", "decode")}
    out["phase_ms"] = {
        k: {n: S.per_step_ms(view.steps, within, (n,), (k,))
            for n in S.NAMES}
        for k in ("mixed", "decode")}
    both = view.spans + prog
    out.update({
        "dispatch_ms.decode": S.per_step_ms(view.steps, within,
                                            ("model.dispatch",),
                                            ("decode",)),
        "host_ms.decode": S.per_step_ms(view.steps, within, S.HOST,
                                        ("decode",)),
        "idle_share.dispatch": S.idle_share(view.device, both, S.DISPATCH),
        "idle_share.host": S.idle_share(view.device, both, S.HOST),
        "moe_sync_ms": (S.per_step_ms(view.steps, within, ("moe.sync",),
                                      ("mixed", "decode"))
                        if loop.moe_stats is not None else None),
        "pad_share.mixed": S.pad_share(view.counters)})
    waits = S.queue_waits(loop.tracked)
    out["queue_wait_p95_ms"] = (percentile(waits, 95) * 1e3
                                if waits else None)
    sl = view.device
    if sl is not None:
        idle = S.idle_by_innermost(sl, both)
        out.update(busy_s=sl.busy_s, window_s=sl.window_s,
                   idle_s=sl.window_s - sl.busy_s,
                   idle_gaps=sorted(([k, v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1]))
    if tel is not None:
        out.update(program_spans=len(prog), dropped_spans=tel.dropped_spans)
    out["memory_peak_bytes"] = served.peak
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=int, default=51)
    ap.add_argument("--telemetry", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    R._env()
    import torch
    torch.set_num_threads(1)
    from benchlib import cell as C
    from benchlib.spec import load_cell
    out = measure(load_cell(args.workload), args.seed, args.seconds,
                  telemetry=bool(args.telemetry))
    out["card"] = C.power_limit()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
