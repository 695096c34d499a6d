"""The kernel library's benchmark entry point: each attention kernel
against its ``ref`` oracle over a sweep of shapes, with the flop count and
arithmetic intensity of each case. Counterpart of the JAX package's
``benchmarks/bench_kernels.py::run`` (same cases, same row keys), without
writing any file.

    python -m repro_torch.kernels.bench [--device cuda|cpu] [--quick]

Prints one JSON row per case: ``kernel``, ``case``, ``max_err``, ``ok``,
``flops``, ``intensity``. Runs on the card unless ``--device cpu`` is
given (then each wrapper takes its plain version); fails without a card,
and fails (exit 1) when any row is not ``ok``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import full_precision_matmuls
from . import ref
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .prefix_attention import prefix_attention

# the JAX package's kernel test cases (tests/test_kernels.py), for the
# card's checks of each kernel against its plain version
FLASH_CASES = [
    # B, H, KH, Sq, Skv, D, causal, window
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 8, 96, 96, 128, True, 0),      # MHA
    (2, 4, 1, 64, 192, 64, False, 0),     # cross-shape, MQA
    (1, 6, 2, 256, 256, 64, True, 64),    # sliding window
    (2, 2, 2, 40, 72, 32, True, 0),       # non-block-multiple
]
# B, H, KH, S, D, n_splits
DEC_CASES = [(4, 8, 2, 256, 64, 4), (2, 4, 4, 100, 128, 3),
             (1, 16, 8, 512, 64, 8), (3, 6, 6, 64, 32, 1)]
# B, H, KH, Sp, Ss, D
PRE_CASES = [(4, 8, 2, 256, 32, 64), (2, 4, 4, 128, 16, 128),
             (1, 8, 1, 512, 8, 64)]

TOL = 2e-5          # max |kernel - oracle| of an ok row (f32 inputs)


def _flash_stats(B, H, KH, S, D, causal):
    flops = 4 * B * H * S * S * D * (0.5 if causal else 1.0)
    bytes_ = 2 * (B * H * S * D + 2 * B * KH * S * D + B * H * S * D)
    return flops, bytes_


def run(device: str = "cuda", quick: bool = False):
    """Every case on ``device``; returns the rows, raises RuntimeError
    after printing them when a row is not ok."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu to check "
                           "the plain versions")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: cuda or cpu")
    full_precision_matmuls()
    rng = np.random.default_rng(0)

    def rnd(*s):
        return torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(device)

    def err(out, exp):
        return float((out.float() - exp.float()).abs().max())

    rows = []
    flash_cases = [(2, 4, 2, 128, 64, True), (1, 8, 8, 256, 128, True),
                   (2, 4, 1, 192, 64, False)]
    if not quick:
        flash_cases += [(1, 16, 4, 512, 64, True), (3, 6, 2, 96, 32, True)]
    for (B, H, KH, S, D, causal) in flash_cases:
        q, k, v = rnd(B, H, S, D), rnd(B, KH, S, D), rnd(B, KH, S, D)
        out = flash_attention(q, k, v, causal=causal, block_q=64,
                              block_k=64)
        e = err(out, ref.flash_attention_ref(q, k, v, causal=causal))
        fl, by = _flash_stats(B, H, KH, S, D, causal)
        rows.append({"kernel": "flash", "case": f"B{B}H{H}/{KH}S{S}D{D}",
                     "max_err": e, "ok": e < TOL,
                     "flops": fl, "intensity": fl / by})

    dec_cases = [(4, 8, 2, 256, 64, 4), (2, 4, 4, 128, 128, 2)]
    if not quick:
        dec_cases += [(1, 16, 8, 1024, 64, 8)]
    for (B, H, KH, S, D, ns) in dec_cases:
        q, k, v = rnd(B, H, D), rnd(B, KH, S, D), rnd(B, KH, S, D)
        lens = torch.from_numpy(np.random.default_rng(0).integers(
            1, S + 1, B).astype(np.int32)).to(device)
        out = decode_attention(q, k, v, lens, n_splits=ns)
        e = err(out, ref.decode_attention_ref(q, k, v, lens))
        fl = 4 * B * H * S * D
        by = 2 * (2 * B * KH * S * D)
        rows.append({"kernel": "decode", "case": f"B{B}H{H}/{KH}S{S}x{ns}",
                     "max_err": e, "ok": e < TOL,
                     "flops": fl, "intensity": fl / by})

    pre_cases = [(4, 8, 2, 256, 32, 64), (2, 4, 4, 128, 16, 128)]
    for (B, H, KH, Sp, Ss, D) in pre_cases:
        q = rnd(B, H, D)
        kp, vp = rnd(KH, Sp, D), rnd(KH, Sp, D)
        ks, vs = rnd(B, KH, Ss, D), rnd(B, KH, Ss, D)
        lens = torch.from_numpy(np.random.default_rng(1).integers(
            1, Ss + 1, B).astype(np.int32)).to(device)
        out = prefix_attention(q, kp, vp, ks, vs, lens)
        e = err(out, ref.prefix_attention_ref(q, kp, vp, ks, vs, lens))
        # Hydragen win: prefix KV read once vs B times
        naive_bytes = 2 * B * (2 * KH * Sp * D)
        hydra_bytes = 2 * (2 * KH * Sp * D) + 2 * B * 2 * KH * Ss * D
        rows.append({"kernel": "prefix", "case": f"B{B}Sp{Sp}Ss{Ss}",
                     "max_err": e, "ok": e < TOL,
                     "flops": 4 * B * H * (Sp + Ss) * D,
                     "intensity": naive_bytes / hydra_bytes})
    for r in rows:
        print(json.dumps(r))
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernel mismatch vs oracle: {bad}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true", help="fewer cases")
    args = ap.parse_args(argv)
    try:
        run(device=args.device, quick=args.quick)
    except RuntimeError as e:
        print(f"bench: FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
