"""The program's own host spans read beside the harness's records.

A ``repro_torch.serving.telemetry.Telemetry`` attached to the cluster
records ``(name, t0, t1)`` on ``time.perf_counter`` seconds, the clock of
the harness's spans and step records and the one ``devtrace`` maps the
device trace onto: the engine step's phases (``sched.form_batch``,
``engine.admit``, ``engine.lower``, ``model.dispatch``, ``engine.fetch``,
``sched.complete``) and each routed MoE host sync (``moe.sync``, inside
``model.dispatch``). A step's spans are those that lie within its
``StepRecord`` [t0, t1].

No run of the benchmark reads these yet: ``cell.build`` attaches no
Telemetry, ``RunView`` carries neither the program's spans nor the queue
waits, and ``serve.Loop._snapshot`` reads a fixed list of counters.
``perfbench/step_phases.py`` serves a cell with those three filled in and
reads them here.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import stats
from .devtrace import mean_by_card

Span = Tuple[str, float, float]

PHASES = ("sched.form_batch", "engine.admit", "engine.lower",
          "model.dispatch", "engine.fetch", "sched.complete")
NAMES = PHASES + ("moe.sync",)              # every span the program records
HOST = ("sched.form_batch", "engine.admit", "engine.lower", "sched.complete")
DISPATCH = ("model.dispatch", "moe.sync")


class Within:
    """Spans by start, for the seconds of named spans inside an interval."""

    def __init__(self, spans: Iterable[Span]):
        self._spans = sorted(spans, key=lambda sp: sp[1])
        self._starts = [sp[1] for sp in self._spans]

    def __len__(self) -> int:
        return len(self._spans)

    def seconds(self, t0: float, t1: float, names: Sequence[str]) -> float:
        """Seconds of the spans named ``names`` that lie within [t0, t1]."""
        total = 0.0
        for i in range(bisect.bisect_left(self._starts, t0), len(self._spans)):
            name, s, e = self._spans[i]
            if s > t1:
                break
            if e <= t1 and name in names:
                total += e - s
        return total


def per_step_ms(steps, within: Within, names: Sequence[str],
                kinds: Sequence[str]) -> Optional[float]:
    """Mean over the steps of ``kinds`` of the named spans' seconds within
    each step, in ms; None without such a step or without program spans."""
    steps = [s for s in steps if s.kind in kinds]
    if not steps or not len(within):
        return None
    return 1e3 * sum(within.seconds(s.t0, s.t1, names)
                     for s in steps) / len(steps)


def _innermost(spans: List[Tuple[float, float, str]]
               ) -> List[Tuple[float, float, str]]:
    """The timeline cut at every span's start and end: each piece that a
    span covers, with the covering span that began last (of two that began
    together, the one that ends first)."""
    points = sorted({p for s, e, _ in spans for p in (s, e)})
    out, begun, j = [], [], 0
    for a, b in zip(points, points[1:]):
        while j < len(spans) and spans[j][0] <= a:
            s, e, n = spans[j]
            heapq.heappush(begun, (-s, e, n))
            j += 1
        while begun and begun[0][1] <= a:
            heapq.heappop(begun)
        if begun:
            out.append((a, b, begun[0][2]))
    return out


def idle_by_innermost(device, spans: Iterable[Span]) -> Dict[str, float]:
    """Idle device seconds of the slice, each stretch put down to the
    innermost span that covers it ("other" where none does): the parts
    sum to the slice's idle time. With spans that do not overlap, the same
    as ``DeviceSlice.idle_by_host``. On several cards, the mean over the
    cards."""
    if device.chips > 1:
        spans = list(spans)
        return mean_by_card([idle_by_innermost(c, spans)
                             for c in device.cards()])
    idle = stats.gaps(((s, e) for _, s, e in device.ops), device.t0,
                      device.t1)
    pieces = _innermost(sorted((s, e, n) for n, s, e in spans
                               if e > device.t0 and s < device.t1))
    out: Dict[str, float] = {}
    k = 0
    for gs, ge in idle:
        while k < len(pieces) and pieces[k][1] <= gs:
            k += 1
        covered = 0.0
        for i in range(k, len(pieces)):
            a, b, n = pieces[i]
            if a >= ge:
                break
            part = min(b, ge) - max(a, gs)
            out[n] = out.get(n, 0.0) + part
            covered += part
        if ge - gs - covered > 0:
            out["other"] = out.get("other", 0.0) + (ge - gs - covered)
    return out


def idle_share(device, spans: Sequence[Span], names: Sequence[str]
               ) -> Optional[float]:
    """Idle time of the slice whose innermost span is one of ``names``,
    over the slice's window, in %; None without a slice or without
    program spans among ``spans``."""
    if device is None or device.window_s <= 0 or \
            not any(n in NAMES for n, _, _ in spans):
        return None
    idle = idle_by_innermost(device, spans)
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / device.window_s


def queue_waits(tracked) -> List[float]:
    """Seconds from each window request's submission to the start of the
    first engine step that carried it: the ``dur`` of its trace's first
    closed "queue" span (requests without a trace are left out)."""
    out = []
    for t in tracked:
        tr = t.req.trace
        if t.phase != "window" or tr is None:
            continue
        for ev in tr.events:
            if ev["name"] == "queue" and ev["kind"] == "end":
                out.append(ev["dur"])
                break
    return out


def pad_share(counters: Dict[str, Dict[str, float]]) -> Optional[float]:
    """Padded slots of the window's fused dispatches over all their slots,
    from the engine's counters at the window's open and close, in %."""
    a, b = counters.get("open"), counters.get("close")
    if not a or not b or "fused_slot_tokens" not in a:
        return None
    slots = b["fused_slot_tokens"] - a["fused_slot_tokens"]
    if slots <= 0:
        return None
    return 100.0 * (b["fused_padded_tokens"] - a["fused_padded_tokens"]) \
        / slots
