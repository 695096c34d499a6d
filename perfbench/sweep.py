"""Find a cell's knee: its traffic offered at several fixed rates in turn,
each served as a timed run serves its window (``cell.serve_window``: the
same seed's weights, a fresh cluster), one JSON line a rate.

    python3 perfbench/sweep.py --workload <cell> --rates 4,6,8 \
        [--seconds 20] [--seed 1] [--out sweep.jsonl]

A rate is sustained while the window's requests all finish and their
time to first token does not grow from the window's first third to its
last (``ttft_growth`` near 1); above the knee the queue grows all
through the window. Run on the card; a tool for defining cells, not a
part of any run.
"""

from __future__ import annotations

import argparse
import json
import sys

import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    R._env()
    import numpy as np
    import torch
    from benchlib import cell as C
    from benchlib.spec import load_cell
    cell = load_cell(args.workload)

    for rate in [float(r) for r in args.rates.split(",")]:
        # the timed run's set-up and window, at this rate
        torch.cuda.reset_peak_memory_stats()
        try:
            served = C.serve_window(cell, args.seed, args.seconds, "cuda",
                                    rate=rate)
        except torch.OutOfMemoryError as e:
            print(json.dumps(dict(workload=args.workload, rate_rps=rate,
                                  oom=str(e)[:200])), flush=True)
            C.free_program("cuda")
            continue
        loop = served.loop
        res = C.e2e(loop.tracked, loop.end)
        win = sorted((t for t in loop.tracked if t.phase == "window"),
                     key=lambda t: t.due)
        third = max(1, len(win) // 3)
        ttft = [(t.stamps[0] if t.stamps else loop.end) - t.due for t in win]
        out = dict(workload=args.workload, rate_rps=rate, **res,
                   ttft_first_third_s=float(np.mean(ttft[:third])),
                   ttft_last_third_s=float(np.mean(ttft[-third:])),
                   done_per_s=sum(t.ok for t in win) / args.seconds,
                   loop_end_s=loop.end, peak_bytes=served.peak)
        out["ttft_growth"] = out["ttft_last_third_s"] / max(
            out["ttft_first_third_s"], 1e-9)
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del served, loop
        C.free_program("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
