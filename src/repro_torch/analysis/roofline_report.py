"""The three-term H100 roofline table of the port's dry-run records, a
row per (arch x shape) (counterpart of the JAX package's
``benchmarks/roofline_report.py``):

    PYTHONPATH=src python -m repro_torch.analysis.roofline_report \\
        [--pod2] [--dir results/dryrun_torch]

The table is printed as CSV (floats to 4 significant digits, as the
reference's ``emit``) and written to ``<dir>/roofline_<pod>.csv``.
``peak_GiB`` is empty: a meta count knows no peak
(``launch/dryrun.py``); ``args_GiB`` is the per-device argument size
instead.
"""

from __future__ import annotations

import argparse
import csv
import glob
import io
import json
import os
from typing import Any, Dict, List

from .roofline import roofline_from_record


def load_records(dryrun_dir: str = "results/dryrun_torch",
                 pod: str = "pod1") -> List[Dict[str, Any]]:
    """The untagged records of ``pod`` ("pod1" or "pod2") in the dir."""
    recs = []
    for p in sorted(glob.glob(os.path.join(dryrun_dir, f"*__{pod}.json"))):
        if os.path.basename(p).count("__") != 2:
            continue
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def rows_from(recs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    rows = []
    for rec in recs:
        t = roofline_from_record(rec, rec["model"]["model_flops"])
        peak = rec["memory"].get("peak_bytes")
        rows.append({
            "arch": rec["arch"], "shape": rec["shape"],
            "compute_s": t.compute_s, "memory_s": t.memory_s,
            "collective_s": t.collective_s,
            "bound": t.dominant,
            "step_s": t.step_time_s,
            "roofline_frac": t.roofline_fraction,
            "useful": t.useful_ratio,
            "peak_GiB": None if peak is None else peak / 2**30,
            "args_GiB": rec["memory"]["argument_bytes"] / 2**30,
        })
    return rows


def run(dryrun_dir: str = "results/dryrun_torch", pod: str = "pod1"
        ) -> List[Dict[str, Any]]:
    recs = load_records(dryrun_dir, pod)
    if not recs:
        print(f"[roofline] no dry-run records under {dryrun_dir} ({pod}) "
              "- run `python -m repro_torch.launch.dryrun --all` first")
        return []
    rows = rows_from(recs)
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=list(rows[0]))
    w.writeheader()
    for r in rows:
        w.writerow({k: (f"{v:.4g}" if isinstance(v, float) else v)
                    for k, v in r.items()})
    print(f"===== roofline_{pod} =====")
    print(buf.getvalue())
    with open(os.path.join(dryrun_dir, f"roofline_{pod}.csv"), "w") as f:
        f.write(buf.getvalue())
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pod2", action="store_true")
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    run(dryrun_dir=args.dir, pod="pod2" if args.pod2 else "pod1")


if __name__ == "__main__":
    main()
