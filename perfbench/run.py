"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout. Builds the cell's configuration of the
program (``src/repro_torch``) on the card, warms it with the cell's own
traffic, offers the traffic open loop for ``--seconds`` through the
program's cluster runtime, checks a sample of what it served against the
configuration's plain reference and prints one JSON object as the last
line of standard output. ``--trace 0`` reports the end-to-end metrics,
``--trace 1`` the per-layer ones. Exits non-zero, printing no result,
without enough CUDA devices or if the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _env() -> None:
    """Caches of the program and its libraries at fixed paths inside the
    checkout; no library loads JAX; one host thread for the CPU-side
    math (the host drives the card, and idle worker threads spinning
    beside it only add jitter)."""
    build = ROOT / "build"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    torch.set_num_threads(1)
    from benchlib import cell as C
    from benchlib.spec import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    C.log(f"card: {C.power_limit()}; torch {torch.__version__}")
    out = C.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
