"""What bounds the split-K decode kernel, without a profiler that sees
inside a kernel: build copies of ``csrc/decode_attention.cu`` whose
split-KV body (``csrc/split_kv.cuh``) has its cp.async copies or its
products and softmax switched off, and time each beside the kernel as it
is on the full-width decode calls of ``chip_smoke.py`` (smollm-360m and
mistral-7b heads, B 8, ragged lens with one full lane), and on the same
tensors with every lane full. A copy's output is wrong by design: only
its time is read. A development tool, not part of the port; on the card
only, from the root of the repo:

    PYTHONPATH=src python tools/ablate_decode.py

Prints one JSON line per variant and case (device-only CUDA-event times,
mean of 20, no L2 flush), with the call's byte bound. Each switch is a
text edit that must apply exactly, as in ``tools/ablate_flash.py``.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import sys
from pathlib import Path

import torch

from ablate_flash import build_variants, time_ms

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the shared full-width inputs)

DA = importlib.import_module("repro_torch.kernels.decode_attention")

# (source file under csrc/, original text, replacement) of each edit
_SWITCHES = {
    "copies": ("split_kv.cuh",
               "        cp_async16(ks + tt * D + cc * kVec, rows.k + off, "
               "valid);\n        cp_async16(vs + tt * D + cc * kVec, "
               "rows.v + off, valid);\n",
               "        (void)off;\n"),
    "compute open": ("split_kv.cuh",
                     "    const int t0 = t_begin + tile * TT;\n\n"
                     "    float s[kSteps][G];\n",
                     "    const int t0 = t_begin + tile * TT;\n"
                     "    if (tile < 0) {\n    float s[kSteps][G];\n"),
    "compute close": ("split_kv.cuh",
                      "          acc[g][e] = fmaf(s[st][g], vf[e], "
                      "acc[g][e]);\n    }\n  }\n",
                      "          acc[g][e] = fmaf(s[st][g], vf[e], "
                      "acc[g][e]);\n    }\n    }\n  }\n"),
}
VARIANTS = {
    "kernel": (),
    "no copies": ("copies",),
    "no products or softmax": ("compute open", "compute close"),
    "loop and barriers only": ("copies", "compute open", "compute close"),
}


def run() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("ablate: needs an NVIDIA GPU")
    libs = build_variants("decode_attention.cu", _SWITCHES, VARIANTS)
    cases = []
    for c in chip_smoke.full_width_cases(torch):
        if c["kind"] != "decode":
            continue
        q, k, v, lens = c["args"]
        S, KH, D = k.shape[2], c["KH"], c["D"]
        full = torch.full_like(lens, S)
        per_tok = KH * D * 2 * 2
        other = c["bytes"] - int(lens.sum()) * per_tok
        for name, ln in (("ragged", lens), ("full lanes", full)):
            b_ms = chip_smoke.bound(int(ln.sum()) * per_tok + other, 0)[0]
            cases.append((f"{c['width']} {name}", (q, k, v, ln), b_ms))
    real_lib = DA._lib
    rows = []
    try:
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            DA._lib = lambda lib=lib: DA._declare(lib)
            for case, args, b_ms in cases:
                row = {"variant": name, "case": case,
                       "ms": time_ms(lambda a=args: DA.decode_attention(*a)),
                       "bound_ms": b_ms}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        DA._lib = real_lib
    return rows


if __name__ == "__main__":
    run()
