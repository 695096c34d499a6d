"""The readings a cell's limits are set from: on each seed, the
program's compared numbers and those of the control (the reference
computed in fp8, the nearest precision below the configuration's bf16,
put in the program's place, at each position of the same prompts and
served tokens), at the cell's own size and load.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 10] [--out control.jsonl]

One JSON line a seed: both sides' numbers, and each judged by
``check.judge`` under the cell's committed limits (``program_correct``,
``control_correct``), as a run judges the program. The set-up and window
are the timed run's own (``cell.serve_window``). Run on the card; not a
part of any run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    R._env()
    from benchlib import cell as C
    from benchlib import check
    from benchlib.spec import load_cell
    cell = load_cell(args.workload)
    chk = cell.config["check"]

    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        # the timed run's set-up and window, on this seed
        served = C.serve_window(cell, seed, args.seconds, "cuda")
        done = [t.req for t in served.loop.tracked
                if t.phase == "window" and t.ok]
        failed = sum(not t.ok for t in served.loop.tracked
                     if t.phase == "window")
        params = served.params
        del served
        C.free_program("cuda")
        sample = check.draw_sample(done, seed, chk["sample_tokens"])
        ref = check.reference_logits(cell.reference, params, cell.config,
                                     sample, "float32")
        ctl = check.reference_logits(cell.reference, params, cell.config,
                                     sample, "fp8")
        program = check.served_gaps(sample, ref)
        control = check.control_gaps(ref, ctl)
        # each side judged as a run judges the program: the control has
        # to come out not correct under the cell's committed limits
        line = json.dumps(dict(
            workload=args.workload, seed=seed, requests=len(sample),
            program=program, control=control,
            program_correct=check.judge(program, chk["limits"], failed)[0],
            control_correct=check.judge(control, chk["limits"], 0)[0],
            limits=chk["limits"], wall_s=time.perf_counter() - t))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del params, ref, ctl
        C.free_program("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
