"""latency_p95_s.traced: the 95th percentile, over the window's requests,
of the time from a request's due time to its last token, in s, as the
end-to-end ``latency_p95_s`` is taken (an unfinished request with what
it had waited), read from the traced run.

For a cell whose end-to-end ``latency_p95_s`` spreads too widely run to
run for the largest bound, so the tail is followed per layer there
(PERF.md)."""


def read(run):
    return run.requests.get("latency_p95_s")
