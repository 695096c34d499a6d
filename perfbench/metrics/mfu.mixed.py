"""mfu.mixed: model operations of the window's prefilling steps over their
host time and the H100's bf16 peak, in %. Operations are the benchmark's
own count (``benchlib.flops.step_flops``): every token through each
layer's active weights, the output head for each token emitted, attention
over the visible (query, key) pairs."""

from benchlib.flops import PEAK_FLOPS


def read(run):
    steps = [s for s in run.steps if s.kind == "mixed"]
    wall = sum(s.t1 - s.t0 for s in steps)
    if wall <= 0:
        return None
    return 100.0 * sum(s.flops(run.dims) for s in steps) / (wall * PEAK_FLOPS)
