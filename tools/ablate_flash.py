"""Where the bf16 flash kernel's time goes, without a profiler that sees
inside a kernel: build copies of ``csrc/flash_attention.cu`` with parts
switched off (the TMA copies, the two products, the softmax) and time
each beside the kernel as it is, on causal and full attention at
smollm-360m width (B 1, S 2048, 15 / 5 heads, D 64, bf16). A copy's
output is wrong by design: only its time is read. A development tool,
not part of the port: it builds its copies beside the port's own
libraries in ``build/kernels/`` and swaps them in for the length of the
run. On the card only, from the root of the repo:

    PYTHONPATH=src python tools/ablate_flash.py

Prints one JSON line per variant (device-only CUDA-event times, mean of
20, no L2 flush). Each switch is a text edit of the source that must
apply exactly, so an edited kernel fails here loudly instead of being
timed half switched off.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import json
import os
import subprocess

import torch

from repro_torch.kernels import build

# the module (the package's name ``flash_attention`` is the function)
FA = importlib.import_module("repro_torch.kernels.flash_attention")

# (source file under csrc/, original text, replacement) of each switch
_SWITCHES = {
    "tma": ("flash_attention.cu",
            "    bar_expect(full + s, 2 * C::tile_bytes);\n#pragma unroll\n"
            "    for (int c = 0; c < D / C::CB; ++c) {",
            "    bar_arrive(full + s);\n    for (int c = 0; c < 0; ++c) {"),
    "products": ("flash_attention.cu",
                 "    for (int kk = 0; kk < D / 16; ++kk)\n"
                 "      wgmma_ss_n64(",
                 "    for (int kk = 0; kk < 0; ++kk)\n      wgmma_ss_n64("),
    "pv": ("wgmma.cuh",
           "  for (int u = 0; u < kBK / 16; ++u)\n    wgmma_pv<D>(",
           "  for (int u = 0; u < 0; ++u)\n    wgmma_pv<D>("),
    "softmax": ("flash_attention.cu",
                "    for (int h2 = 0; h2 < 2; ++h2) {\n      const int qpos",
                "    for (int h2 = 0; h2 < 0; ++h2) {\n      const int qpos"),
}
VARIANTS = {
    "kernel": (),
    "no TMA copies": ("tma",),
    "no products": ("products", "pv"),
    "no softmax": ("softmax",),
    "products only": ("tma", "softmax"),
    "softmax only": ("tma", "products", "pv"),
    "loop and barriers only": ("tma", "products", "pv", "softmax"),
}


def _sources(main: str, table: dict, switches) -> dict:
    """The edited files of a variant of csrc/``main``: file name -> text,
    after the edits ``table[name]`` = (file, old, new) of each switch."""
    files = {main: (build.CSRC / main).read_text()}
    for name in switches:
        fname, old, new = table[name]
        src = files.get(fname) or (build.CSRC / fname).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"ablate: switch {name!r} no longer applies "
                               f"to csrc/{fname}")
        files[fname] = src.replace(old, new)
    return files


def build_variants(main: str, table: dict, variants: dict) -> dict:
    """Build a library of csrc/``main`` for each variant (name -> the
    switches of ``table`` it turns on): one nvcc per variant, all started
    together. A variant's edited files go to a directory of its own,
    found before csrc/ for every include, so an edited header reaches
    only that variant. Returns name -> library path."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    stem = main.rsplit(".", 1)[0]
    procs = {}
    for name, switches in variants.items():
        files = _sources(main, table, switches)
        tag = hashlib.sha256(repr(sorted(files.items())).encode()) \
            .hexdigest()[:12]
        vdir = build.BUILD_DIR / f"ablate-{tag}"
        vdir.mkdir(exist_ok=True)
        for fname, text in files.items():
            (vdir / fname).write_text(text)
        so = vdir / f"{stem}.so"
        tmp = vdir / f"{stem}.{os.getpid()}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(tmp),
               str(vdir / main)]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        os.replace(tmp, so)            # never a half-written library
        libs[name] = so
    return libs


def time_ms(fn, n=20):
    """Mean device time of fn: CUDA events around each call, a ~1 ms spin
    kernel queued ahead of it (no L2 flush)."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(n):
        torch.cuda._sleep(2_000_000)   # the device is busy while we enqueue
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / n


def run() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("ablate: needs an NVIDIA GPU")
    libs = build_variants("flash_attention.cu", _SWITCHES, VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, h, 2048, 64, generator=g, device="cuda")
               .bfloat16() for h in (15, 5, 5))
    real_lib = FA._lib
    rows = []
    try:
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            FA._lib = lambda lib=lib: FA._declare(lib)
            row = {"variant": name}
            for causal in (True, False):
                row["causal_ms" if causal else "full_ms"] = time_ms(
                    lambda: FA.flash_attention(q, k, v, causal=causal))
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        FA._lib = real_lib
    return rows


if __name__ == "__main__":
    run()
