"""step_ms.mixed: mean host time of ``ClusterRuntime.step`` over the
window's steps that prefilled (the engine's prefilled-token counter
grew), in ms. Each step ends in a host fetch of its tokens."""

from benchlib.stats import mean


def read(run):
    m = mean([s.t1 - s.t0 for s in run.steps if s.kind == "mixed"])
    return None if m is None else m * 1e3
