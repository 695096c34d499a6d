"""route_ms: mean host time of ``ClusterRuntime.submit`` (E2 placement
and the local enqueue) over the window's requests, in ms."""

from benchlib.stats import mean


def read(run):
    m = mean(run.submit_s)
    return None if m is None else m * 1e3
