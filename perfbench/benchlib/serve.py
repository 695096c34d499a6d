"""The timed path: open-loop traffic offered to the program's cluster
runtime, every request stamped on the host clock.

The loop submits each request when it is due (``ClusterRuntime.submit``),
steps the cluster (``ClusterRuntime.step``, which ends in a host fetch of
the step's tokens) and, after every step, stamps the tokens each request
gained on ``time.perf_counter()``. A request is timed from its due time,
so a step that holds up submission counts against the requests behind
it; how late each submission was is kept as well. The program's own time
stamps (``Request.first_token_time`` and the like) hold the ``now`` its
caller passed at the start of a step and are not read.

With ``trace`` on, the loop also records a span around each call into the
program (submit, step), around its own stamping and its waits for
arrivals, each step's composition (the prefill chunks and decode lanes it
carried, from the requests' progress and the engines' counters) and, for
a bounded slice of steady steps, a device trace (``devtrace``).

A step is one ``ClusterRuntime.step``: every instance's engine step. The
engines' counters are read as their sums over the instances.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import flops as F


@dataclass
class Tracked:
    req: Any
    due: float
    phase: str
    late: float                         # submission time - due time
    stamps: List[float] = field(default_factory=list)
    pf: int = 0                         # prompt tokens prefilled so far
    ok: bool = False
    done: bool = False


@dataclass
class StepRecord:
    t0: float
    t1: float
    kind: str                           # "mixed" | "decode" | "idle"
    prefilled: int
    chunks: List[Tuple[int, int]]       # (start, tokens) of each chunk
    decode_lens: List[int]              # valid keys of each decode lane
    produced: int                       # tokens the step emitted
    moe_syncs: int
    profiled: bool
    counted: bool                       # chunks add up to the counter
    decode_inst: List[int] = field(default_factory=list)  # each lane's

    def decode_calls(self) -> List[List[int]]:
        """The decode lanes' valid keys, one list an instance: what each
        instance's decode attention call carried."""
        calls: Dict[int, List[int]] = {}
        for n, i in zip(self.decode_lens,
                        self.decode_inst or [0] * len(self.decode_lens)):
            calls.setdefault(i, []).append(n)
        return list(calls.values())

    def flops(self, dims: F.Dims) -> float:
        """Tokens from the engine's counter; attention pairs from the
        chunks as the requests' progress shows them (a newly admitted
        request's chunk starts where its cached prefix ends, as the
        scheduler matched it)."""
        pairs = sum(F.pairs_of_chunk(s, n) for s, n in self.chunks) \
            + sum(self.decode_lens)
        tokens = self.prefilled + len(self.decode_lens)
        return F.step_flops(dims, tokens, self.produced, pairs)


COUNTED = ("reused_tokens", "prefilled_tokens", "decode_steps", "iterations",
           "model_dispatches", "fused_iterations")


def engine_sums(cluster, keys) -> Dict[str, float]:
    """Each of the engines' counters ``keys``, summed over the cluster's
    instances."""
    engines = list(cluster.engines.values())
    return {k: sum(e.stats[k] for e in engines) for k in keys}


@dataclass
class Loop:
    cluster: Any
    make_request: Any                   # (tokens, max_new) -> Request
    planned: List[Any]
    window: Tuple[float, float]         # [open, close) on the loop clock
    drain_limit: float
    trace: bool = False
    profile_at: float = 0.0             # loop time the device slice starts
    profile_steps: int = 0
    profile_seconds: float = 0.0
    moe_stats: Optional[Dict[str, int]] = None
    # results
    tracked: List[Tracked] = field(default_factory=list)
    steps: List[StepRecord] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    submit_s: List[float] = field(default_factory=list)
    counters: Dict[str, Dict[str, float]] = field(default_factory=dict)
    device_slice: Any = None
    end: float = 0.0

    @property
    def engine(self):
        """The first instance's engine (for tools that read one)."""
        return self.cluster.engines[0]

    def _snapshot(self) -> Dict[str, float]:
        snap = engine_sums(self.cluster, COUNTED)
        if self.moe_stats is not None:
            snap["moe_host_syncs"] = self.moe_stats["host_syncs"]
        return snap

    def run(self, profiler=None) -> None:
        clock = time.perf_counter
        plan, n = self.planned, len(self.planned)
        open_t, close_t = self.window
        inflight: Dict[int, Tracked] = {}
        left = sum(1 for p in plan if p.phase == "window")
        origin = clock()
        i, opened, prof_left, prof_end = 0, False, -1, 0.0
        while True:
            now = clock() - origin
            if not opened and now >= open_t:
                self.counters["open"] = self._snapshot()
                opened = True
            while i < n and plan[i].due <= now:
                p = plan[i]
                req = self.make_request(p.tokens, p.max_new)
                t0 = clock()
                self.cluster.submit(req, t0 - origin)
                t1 = clock()
                tr = Tracked(req, p.due, p.phase, t0 - origin - p.due)
                inflight[req.request_id] = tr
                self.tracked.append(tr)
                if p.phase == "window":
                    self.submit_s.append(t1 - t0)
                if self.trace:
                    self.spans.append(("submit", t0, t1))
                i += 1
            now = clock() - origin
            if now >= close_t and "close" not in self.counters:
                self.counters["close"] = self._snapshot()
            if (now >= close_t and left == 0) or now >= close_t + \
                    self.drain_limit:
                break
            if not inflight:
                if i >= n:
                    break
                t0 = clock()
                wait = plan[i].due - (t0 - origin)
                if wait > 0:
                    time.sleep(wait)
                if self.trace:
                    self.spans.append(("wait", t0, clock()))
                continue
            if (self.trace and profiler is not None and prof_left < 0
                    and now >= self.profile_at):
                profiler.start()
                prof_left, prof_end = self.profile_steps, \
                    now + self.profile_seconds
            profiled = prof_left > 0
            before = self._snapshot() if self.trace else None
            t0 = clock()
            done = self.cluster.step(t0 - origin)
            t1 = clock()
            rec = self._record(inflight, t1 - origin, before, t0, t1,
                               profiled) if self.trace else None
            if not self.trace:
                stamp = t1 - origin
                for tr in inflight.values():
                    k = len(tr.req.output_tokens)
                    if k > len(tr.stamps):
                        tr.stamps.extend([stamp] * (k - len(tr.stamps)))
            for r in done:
                tr = inflight.pop(r.request_id, None)
                if tr is None:
                    continue
                tr.done = True
                tr.ok = len(r.output_tokens) == r.max_new_tokens
                if tr.phase == "window":
                    left -= 1
            t2 = clock()
            if self.trace:
                self.steps.append(rec)
                self.spans.append(("step", t0, t1))
                self.spans.append(("stamp", t1, t2))
            if profiled:
                prof_left -= 1
                if prof_left == 0 or t2 - origin >= prof_end:
                    prof_left = 0
                    self.device_slice = profiler.stop()
        if prof_left > 0:
            self.device_slice = profiler.stop()
        self.end = clock() - origin
        if "close" not in self.counters:
            self.counters["close"] = self._snapshot()

    def _record(self, inflight, stamp, before, t0, t1, profiled
                ) -> StepRecord:
        """Stamp the step's tokens and read what it carried."""
        chunks, lens, inst, produced = [], [], [], 0
        for tr in inflight.values():
            r = tr.req
            k, seen = len(r.output_tokens), len(tr.stamps)
            if k > seen:
                produced += k - seen
                if seen:
                    lens.append(r.prompt_len + seen)
                    inst.append(r.instance)
                tr.stamps.extend([stamp] * (k - seen))
            pf = min(r.prefill_done, r.prompt_len)
            if pf > tr.pf:
                start = tr.pf if tr.pf else min(r.cached_len,
                                                r.prompt_len - 1)
                chunks.append((start, pf - start))
                tr.pf = pf
        after = self._snapshot()
        pre = after["prefilled_tokens"] - before["prefilled_tokens"]
        kind = "mixed" if pre else ("decode" if lens else "idle")
        syncs = (after["moe_host_syncs"] - before["moe_host_syncs"]
                 if self.moe_stats is not None else 0)
        return StepRecord(t0, t1, kind, pre, chunks, lens, produced, syncs,
                          profiled, sum(n for _, n in chunks) == pre, inst)
