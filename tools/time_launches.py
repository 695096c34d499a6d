"""Device time of the library's attention calls and of each kernel launch
inside them, for one source tree of the port, on the card. A development
tool, not part of the port: it times the tree whose ``src`` it is given,
so two trees (a parent commit unpacked beside this one, and this one)
can be read in turns inside one chip call.

    python tools/time_launches.py --src src --label change [--sweep]

The inputs are those ``chip_smoke.py`` times (its ``full_width_cases``,
random bf16 tensors from a fixed seed at the head widths of smollm-360m
and mistral-7b: flash, decode B 8 with ragged lens, shared-prefix decode
B 32), plus paged decode B 8 over 128 pages of 16 at smollm width.

Prints one JSON line per call: ``ms``, the mean device time of the whole
call (CUDA events, the 50 MB L2 flushed and a ~1 ms spin kernel queued
before each call, as ``chip_smoke.py`` times), ``bound_ms`` where the
call has one, and ``launches``, each kernel's mean device time per launch
from torch.profiler over the same kind of loop. ``--sweep`` adds the
decode and shared-prefix calls at a range of split counts (through the
wrappers' private ``_launch``), with the f32 partial bytes each writes.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the shared full-width inputs)

SPIN_CYCLES = 2_000_000
SKIP = ("spin", "sleep", "elementwise", "Memset")   # spin and L2 flush


def _short(name: str) -> str:
    base = name.replace("(anonymous namespace)::", "")
    return base.split("(")[0].split("<")[0].split("::")[-1].split(" ")[-1]


def run(opts) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_launches: needs an NVIDIA GPU")
    sys.path.insert(0, opts.src)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("decode_attention", "prefix_attention",
                      "paged_attention", "flash_attention")}
    DA, PF = mods["decode_attention"], mods["prefix_attention"]
    PA, FA = mods["paged_attention"], mods["flash_attention"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(4)   # the paged inputs

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(bf)

    def ragged(n, hi):
        lens = torch.randint(1, hi + 1, (n,), generator=g, device="cuda")
        lens[0] = hi
        return lens.to(torch.int32)

    def once(fn):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        fn()

    def timed(name, fn, n=opts.n, **extra):
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(n):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                once(fn)
            torch.cuda.synchronize()
        launches = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or any(
                    s in e.key for s in SKIP):
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            k = _short(e.key)
            cnt, tot = launches.get(k, (0, 0.0))
            launches[k] = (cnt + e.count, tot + us)
        row = dict(label=opts.label, call=name, ms=total / n,
                   launches={k: dict(per_call=c / n, ms=t / c / 1e3)
                             for k, (c, t) in sorted(launches.items())},
                   **extra)
        print(json.dumps(row), flush=True)

    for case in chip_smoke.full_width_cases(torch):
        kind, width, inp = case["kind"], case["width"], case["args"]
        bound_ms = chip_smoke.bound(case["bytes"], case["flops"])[0]
        if kind == "flash":
            win = case["window"]
            timed(f"flash {width}",
                  lambda a=inp, w=win: FA.flash_attention(*a, window=w),
                  n=10 if win else opts.n, bound_ms=bound_ms)
        elif kind == "decode":
            timed(f"decode {width}",
                  lambda a=inp: DA.decode_attention(*a), bound_ms=bound_ms)
            if opts.sweep:
                q, k = inp[0], inp[1]
                tile = PA.tile_tokens(bf, case["D"])
                n_tiles = -(-k.shape[2] // tile)
                for n in (4, 8, 16, 32, 64):
                    per = -(-n_tiles // n)
                    plan = (-(-n_tiles // per), per * tile)
                    timed(f"decode {width} sweep",
                          lambda a=inp, p=plan: DA._launch(*a, p),
                          bound_ms=bound_ms, n_split=plan[0],
                          partial_mb=plan[0] * q.numel() * 4 / 1e6)
        else:
            timed(f"prefix {width}", lambda a=inp: PF.prefix_attention(*a),
                  bound_ms=bound_ms)
            if opts.sweep:
                q, kp, vp, ks, vs, lens = inp
                sfx = PF.plan_for(q, kp, ks)[1]
                tiles = -(-kp.shape[1] // PF.TILE_K)
                for n in (4, 8, 12, 16, 22, 32, 64):
                    per = -(-tiles // n)
                    plan = ((-(-tiles // per), per * PF.TILE_K), sfx)
                    timed(f"prefix {width} sweep",
                          lambda p=plan: PF._launch(q, kp, vp,
                                                    (ks, vs, lens), p),
                          bound_ms=bound_ms, n_split=plan[0][0],
                          partial_mb=plan[0][0] * q.numel() * 4 / 1e6)

    B, H, KH, D, PS, P = 8, 15, 5, 64, 16, 128
    n_pages = B * P + 1
    kpool, vpool = rand(n_pages, PS, KH, D), rand(n_pages, PS, KH, D)
    q = rand(B, H, D)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
    pt = perm[:B * P].view(B, P).to(torch.int32).contiguous()
    lens = ragged(B, P * PS)
    timed("paged smollm-360m",
          lambda: PA.paged_decode_attention(q, kpool, vpool, pt, lens))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src",
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", default="change")
    ap.add_argument("--sweep", action="store_true",
                    help="also the decode and prefix split-count sweeps")
    ap.add_argument("-n", type=int, default=30, help="calls a reading")
    run(ap.parse_args())


if __name__ == "__main__":
    main()
