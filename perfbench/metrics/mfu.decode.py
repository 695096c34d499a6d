"""mfu.decode: as mfu.mixed, over the window's decode-only steps, in %."""

from benchlib.flops import PEAK_FLOPS


def read(run):
    steps = [s for s in run.steps if s.kind == "decode"]
    wall = sum(s.t1 - s.t0 for s in steps)
    if wall <= 0:
        return None
    ops = sum(s.flops(run.dims) for s in steps)
    return 100.0 * ops / (wall * PEAK_FLOPS * run.chips)
