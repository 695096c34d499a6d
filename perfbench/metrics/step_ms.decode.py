"""step_ms.decode: mean host time of ``ClusterRuntime.step`` over the
window's decode-only steps, in ms."""

from benchlib.stats import mean


def read(run):
    m = mean([s.t1 - s.t0 for s in run.steps if s.kind == "decode"])
    return None if m is None else m * 1e3
