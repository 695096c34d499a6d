"""mfu.mixed: model operations of the window's prefilling steps over their
host time and the bf16 peak of the cell's H100s (chips x peak), in %.
Operations are the benchmark's own count (``benchlib.flops.step_flops``):
every token through each layer's active weights, the output head for
each token emitted, attention over the visible (query, key) pairs of the
attention layers, each Mamba layer's scan."""

from benchlib.flops import PEAK_FLOPS


def read(run):
    steps = [s for s in run.steps if s.kind == "mixed"]
    wall = sum(s.t1 - s.t0 for s in steps)
    if wall <= 0:
        return None
    ops = sum(s.flops(run.dims) for s in steps)
    return 100.0 * ops / (wall * PEAK_FLOPS * run.chips)
