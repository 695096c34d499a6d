"""A bounded slice of steady steps under ``torch.profiler`` (device
activity only): every operation the device ran, on the loop's clock.

The profiler's timestamps are nanoseconds of the Unix clock; the loop's
spans are ``time.perf_counter`` seconds. The slice reads the offset
between the two clocks when it starts and maps device intervals onto the
loop's clock with it, so idle gaps can be labelled with what the host
was doing then.

A cell on several cards traces them all: each operation keeps its card,
and the busy and idle times are each card's own, averaged over the
cards.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from . import stats


@dataclass
class DeviceSlice:
    t0: float                                   # perf_counter seconds
    t1: float
    ops: List[Tuple[str, float, float]]         # (name, start, end)
    chips: int = 1                              # cards traced
    card: List[int] = field(default_factory=list)   # each op's card

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def cards(self) -> List["DeviceSlice"]:
        """The slice of each card (this one, on one card)."""
        if self.chips == 1:
            return [self]
        ops: List[List[Tuple[str, float, float]]] = [[] for _ in
                                                     range(self.chips)]
        for op, c in zip(self.ops, self.card):
            ops[c].append(op)
        return [DeviceSlice(self.t0, self.t1, o) for o in ops]

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on a card, the mean over the
        cards."""
        return sum(stats.union_length(((s, e) for _, s, e in c.ops),
                                      c.t0, c.t1)
                   for c in self.cards()) / self.chips

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [o for o in self.ops if not o[0].startswith(("Memcpy",
                                                              "Memset"))]

    def time_by_name(self) -> Dict[str, Tuple[float, int]]:
        out: Dict[str, Tuple[float, int]] = {}
        for name, s, e in self.ops:
            t, n = out.get(name, (0.0, 0))
            out[name] = (t + (e - s), n + 1)
        return out

    def idle_by_host(self, spans: List[Tuple[str, float, float]]
                     ) -> Dict[str, float]:
        """Idle device seconds of the slice, by the host span that covers
        each stretch of idleness ("other" where no span does); on several
        cards the mean over the cards."""
        if self.chips > 1:
            return mean_by_card([c.idle_by_host(spans)
                                 for c in self.cards()])
        idle = stats.gaps(((s, e) for _, s, e in self.ops), self.t0, self.t1)
        spans = sorted((s, e, n) for n, s, e in spans
                       if e > self.t0 and s < self.t1)
        out: Dict[str, float] = {}
        for gs, ge in idle:
            covered = 0.0
            for s, e, n in spans:
                if e <= gs:
                    continue
                if s >= ge:
                    break
                part = min(e, ge) - max(s, gs)
                out[n] = out.get(n, 0.0) + part
                covered += part
            if ge - gs - covered > 0:
                out["other"] = out.get("other", 0.0) + (ge - gs - covered)
        return out


def mean_by_card(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """Seconds by label, summed over the cards' dicts and averaged over
    them."""
    out: Dict[str, float] = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0.0) + v
    return {k: v / len(parts) for k, v in out.items()}


class DeviceProfiler:
    """start() / stop() around the slice; stop() returns a DeviceSlice."""

    def __init__(self, device_type: str = "cuda", chips: int = 1):
        """``device_type`` "cpu" traces the host's operators in place of
        the device's: a rehearsal of the reading on a machine without a
        card, never a device number. ``chips``: the cards traced, the
        first ``chips`` of the machine."""
        from torch.profiler import ProfilerActivity, profile
        self._cpu = device_type == "cpu"
        self._chips = 1 if self._cpu else chips
        self._prof = profile(activities=[
            ProfilerActivity.CPU if self._cpu else ProfilerActivity.CUDA])
        self._t0 = 0.0
        self._offset = 0

    def start(self) -> None:
        self._prof.start()
        self._offset = time.time_ns() - time.perf_counter_ns()
        self._t0 = time.perf_counter()

    def stop(self) -> DeviceSlice:
        import torch
        if not self._cpu:
            for c in range(self._chips):
                torch.cuda.synchronize(c)
        t1 = time.perf_counter()
        self._prof.stop()
        ops, card = self._ops()
        return DeviceSlice(self._t0, t1, ops, self._chips, card)

    def _ops(self) -> Tuple[List[Tuple[str, float, float]], List[int]]:
        from torch.autograd import DeviceType
        want = DeviceType.CPU if self._cpu else DeviceType.CUDA
        ops, card = [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != want:
                continue
            s = (e.start_ns() - self._offset) / 1e9
            ops.append((e.name(), s, s + e.duration_ns() / 1e9))
            card.append(e.device_index())
        return ops, card


def warm(device_type: str = "cuda") -> None:
    """Start and stop the profiler once, so the first slice of a run does
    not pay the profiler's own start-up."""
    import torch
    p = DeviceProfiler(device_type)
    p.start()
    torch.zeros(1, device=device_type).add_(1)
    p.stop()
