"""Unified telemetry plane (DESIGN.md §12): metrics registry,
per-request trace timelines, and TTFT/latency attribution.

Four layers, all dependency-free (stdlib only):

  * ``MetricsRegistry`` — typed counters / gauges / fixed-bucket
    histograms under ONE shared name vocabulary. Component ``stats``
    dicts (engine, local/global scheduler, host store, fault injector,
    cluster runtime, simulator) become thin views over the registry
    when a ``Telemetry`` is attached (``StatsDict.bind``): the dict
    API every existing test and bench reads is unchanged, but the
    values live in registry metrics and export through ``snapshot()``
    (JSON) and ``to_prometheus()`` (text exposition format).
  * ``RequestTrace`` — an ordered span-event timeline recorded on
    ``Request.trace`` (submit → schedule → queue → prefetch
    issue/land/claim → admit/restore/migrate → first_token →
    decode → retries/faults → finish|failed), with ``breakdown()``
    attributing TTFT and total latency into NON-OVERLAPPING components
    that sum exactly to the end-to-end measurement.
  * a structured event log (``Telemetry.events``) chaos benches can
    assert against (crash / retry / prefetch records / terminal
    failures), emitted with the same vocabulary by the real
    ``ClusterRuntime`` and the ``Simulator``.
  * host spans (``Telemetry.spans``): ``(name, t0, t1)`` on
    ``time.perf_counter()`` seconds, one per phase of the real engine's
    step (``sched.form_batch``, ``engine.admit``, ``engine.lower``,
    ``model.dispatch``, ``engine.fetch``, ``sched.complete``) and one per
    routed MoE host sync (``moe.sync``, inside ``model.dispatch``). The
    simulator records none; ``snapshot()`` and the Prometheus export do
    not carry them.

Gating mirrors the ``faults`` pattern (§11): built with
``telemetry=None`` (or ``Telemetry(enabled=False)``) every hook is
behind an ``is not None`` check and the runtimes are byte-identical to
the untelemetered loop. ``StatsDict`` itself is always-on where a
component needs DERIVED read-time keys (the ``*_overlap_frac`` ratios
that used to be recomputed inside hot drain loops) — derivation happens
at read, never in the step path.

Attribution semantics (the ``breakdown()`` contract):

  * ``sched_delay``  = last accepted schedule decision - arrival.
    For retried requests this absorbs every failed attempt and its
    backoff (the retry tax), because ``reset_for_retry`` scrubs the
    per-attempt timestamps.
  * ``queue``        = first engine iteration - schedule.  Prefetch
    DMA that landed before admission is CREDITED HERE: the transfer
    overlapped queue wait, so the wait itself is the honest cost. Its
    magnitude is reported separately (``prefetch_hidden`` /
    ``prefetch_hidden_tokens``) and deliberately NOT summed.
  * ``restore`` / ``migrate`` = modeled DMA/DCN seconds the runtime
    actually charged inside the prefill window (the simulator
    annotates its cost-model charges; the real engine overlaps these
    transfers with dispatches under virtual time, so they carry
    tokens but zero seconds and the time sits in ``compute``).
    Clamped into the measured prefill window.
  * ``compute``      = first_token - first_run - restore - migrate.
  * ``decode``       = finish - first_token.

Invariant: sched_delay + queue + restore + migrate + compute == TTFT
and + decode == latency, exactly (components are remainders of the
measured timestamps, not independent estimates).
"""

from __future__ import annotations

import json
import time
from collections.abc import MutableMapping
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "StatsDict", "RequestTrace", "Telemetry", "request_breakdown",
           "BREAKDOWN_COMPONENTS", "DEFAULT_TIME_BUCKETS"]

# Non-overlapping latency components, in timeline order. Their sum is
# exactly `latency()`; the first five sum to `ttft()`.
BREAKDOWN_COMPONENTS = ("sched_delay", "queue", "restore", "migrate",
                        "compute", "decode")

# Prometheus-style cumulative upper bounds for request-time histograms
# (seconds). The final +Inf bucket is implicit.
DEFAULT_TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                        120.0, 300.0)


# ---- metric types -----------------------------------------------------------


class Counter:
    """Monotonic counter (the stats views may also assign directly —
    e.g. the engine mirroring a scheduler counter — which keeps the
    dict semantics the existing code relies on)."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, v=1) -> None:
        self.value += v

    def get(self):
        return self.value


class Gauge:
    """Point-in-time value. Either stored (``set``) or callback-backed
    (``fn``) — callback gauges read live component state at export
    time, so the hot path pays nothing and the exported value can
    never drift from the component's own gauge."""

    __slots__ = ("name", "labels", "value", "fn")
    kind = "gauge"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 fn: Optional[Callable[[], Any]] = None):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.fn = fn

    def set(self, v) -> None:
        self.value = v

    def get(self):
        return self.fn() if self.fn is not None else self.value


class Histogram:
    """Fixed-bucket histogram that also keeps raw samples, so
    percentiles are EXACT and use the same sorted-index definition as
    ``SimResult.summary()`` (p50 = ``v[n // 2]``, p99 =
    ``v[min(int(n * .99), n - 1)]``) — summaries built on this type
    reproduce the historical numbers bit-for-bit. Bucket counts are
    maintained for the Prometheus exposition."""

    __slots__ = ("name", "labels", "buckets", "counts", "count", "sum",
                 "_samples", "_sorted")
    kind = "histogram"

    def __init__(self, name: str = "",
                 labels: Tuple[Tuple[str, str], ...] = (),
                 buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
                 track_values: bool = True):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +Inf last
        self.count = 0
        self.sum = 0.0
        self._samples: Optional[List[float]] = [] if track_values else None
        self._sorted = True

    @classmethod
    def from_values(cls, values: Iterable[float],
                    name: str = "") -> "Histogram":
        h = cls(name)
        for v in values:
            h.observe(v)
        return h

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                break
        else:
            self.counts[len(self.buckets)] += 1
        if self._samples is not None:
            if self._samples and v < self._samples[-1]:
                self._sorted = False
            self._samples.append(v)

    def get(self):
        return self.count

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def _ordered(self) -> List[float]:
        if self._samples is None:
            raise ValueError(f"histogram {self.name!r} does not track "
                             f"raw samples")
        if not self._sorted:
            self._samples.sort()
            self._sorted = True
        return self._samples

    def percentile(self, q: float) -> float:
        """Exact sorted-index percentile: ``v[min(int(n*q), n-1)]``."""
        v = self._ordered()
        if not v:
            return 0.0
        return v[min(int(len(v) * q), len(v) - 1)]

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, +Inf last."""
        out, acc = [], 0
        for ub, c in zip(self.buckets, self.counts):
            acc += c
            out.append((ub, acc))
        out.append((float("inf"), acc + self.counts[-1]))
        return out


# ---- registry ---------------------------------------------------------------


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series(name: str, labels: Tuple[Tuple[str, str], ...],
            extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = labels + extra
    if not pairs:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return f"{name}{{{body}}}"


class MetricsRegistry:
    """Name-vocabulary authority: every metric in a run — stats-dict
    views, callback gauges, request histograms — registers here, keyed
    by (name, labels)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    def _get_or_make(self, cls, name: str, labels: Dict[str, Any],
                     **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_make(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_make(Gauge, name, labels)

    def gauge_fn(self, name: str, fn: Callable[[], Any],
                 **labels) -> Gauge:
        g = self._get_or_make(Gauge, name, labels)
        g.fn = fn
        return g

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
                  **labels) -> Histogram:
        return self._get_or_make(Histogram, name, labels,
                                 buckets=buckets)

    # ---- introspection / export ----------------------------------------

    def names(self) -> set:
        """The metric-name vocabulary (label-blind)."""
        return {name for name, _ in self._metrics}

    def get(self, name: str, **labels):
        m = self._metrics.get((name, _label_key(labels)))
        return None if m is None else m.get()

    def series(self) -> Dict[str, Any]:
        """Flat ``{prometheus_series_name: value}`` for counters and
        gauges (histograms export count; see snapshot for buckets)."""
        return {_series(m.name, m.labels): m.get()
                for m in self._metrics.values()}

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for m in self._metrics.values():
            s = _series(m.name, m.labels)
            if m.kind == "counter":
                out["counters"][s] = m.value
            elif m.kind == "gauge":
                out["gauges"][s] = m.get()
            else:
                out["histograms"][s] = {
                    "count": m.count, "sum": m.sum,
                    "buckets": [[ub, c] for ub, c in m.cumulative()]}
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        by_name: Dict[str, List[Any]] = {}
        for m in self._metrics.values():
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            ms = by_name[name]
            lines.append(f"# TYPE {name} {ms[0].kind}")
            for m in sorted(ms, key=lambda m: m.labels):
                if m.kind == "histogram":
                    for ub, acc in m.cumulative():
                        le = "+Inf" if ub == float("inf") else repr(ub)
                        lines.append(
                            f"{_series(name + '_bucket', m.labels, (('le', le),))}"
                            f" {acc}")
                    lines.append(f"{_series(name + '_sum', m.labels)}"
                                 f" {m.sum}")
                    lines.append(f"{_series(name + '_count', m.labels)}"
                                 f" {m.count}")
                else:
                    lines.append(f"{_series(name, m.labels)} {m.get()}")
        return "\n".join(lines) + "\n"


# ---- stats views ------------------------------------------------------------


class StatsDict(MutableMapping):
    """Dict-compatible stats surface with two extra powers:

    * DERIVED keys — computed from base counters at READ time (e.g.
      ``prefetch_overlap_frac``), so hot drain loops never recompute
      ratios per batch and a read is never stale.
    * ``bind(registry, prefix)`` — migrates storage into registry
      metrics; afterwards the dict is a thin view over the registry
      (``<prefix>_<key>`` series) and every existing ``stats[...]``
      read/write keeps working.

    Deliberately a MutableMapping, NOT a dict subclass: CPython's
    ``dict(d)`` fast path bypasses overridden methods on dict
    subclasses and would silently drop the derived keys.

    Classification at bind time: int-seeded entries are counters,
    float-seeded entries are gauges (the one float stat,
    ``starved_max_wait``, is a running max, not monotonic).
    """

    __slots__ = ("_data", "_derived", "_metrics", "_registry", "_prefix",
                 "_labels")

    def __init__(self, seed: Optional[Dict[str, Any]] = None,
                 derived: Optional[Dict[str, Callable]] = None):
        self._data: Dict[str, Any] = dict(seed or {})
        self._derived: Dict[str, Callable] = dict(derived or {})
        self._metrics: Optional[Dict[str, Any]] = None
        self._registry: Optional[MetricsRegistry] = None
        self._prefix = ""
        self._labels: Dict[str, Any] = {}

    # ---- registry binding ----------------------------------------------

    def bind(self, registry: MetricsRegistry, prefix: str,
             **labels) -> "StatsDict":
        self._registry, self._prefix, self._labels = (registry, prefix,
                                                      labels)
        self._metrics = {}
        for k, v in self._data.items():
            self._metrics[k] = self._make_metric(k, v)
        self._data = {}
        return self

    def _make_metric(self, key: str, value):
        name = f"{self._prefix}_{key}" if self._prefix else key
        if isinstance(value, float):
            m = self._registry.gauge(name, **self._labels)
        else:
            m = self._registry.counter(name, **self._labels)
        m.value = value
        return m

    # ---- mapping protocol ----------------------------------------------

    def __getitem__(self, key):
        d = self._derived.get(key)
        if d is not None:
            return d(self)
        if self._metrics is not None:
            return self._metrics[key].value
        return self._data[key]

    def __setitem__(self, key, value):
        if key in self._derived:
            raise KeyError(f"{key!r} is derived (read-only)")
        if self._metrics is not None:
            m = self._metrics.get(key)
            if m is None:
                self._metrics[key] = self._make_metric(key, value)
            else:
                m.value = value
        else:
            self._data[key] = value

    def __delitem__(self, key):
        if self._metrics is not None:
            del self._metrics[key]
        else:
            del self._data[key]

    def __iter__(self):
        base = self._metrics if self._metrics is not None else self._data
        yield from base
        yield from self._derived

    def __len__(self):
        base = self._metrics if self._metrics is not None else self._data
        return len(base) + len(self._derived)

    def __repr__(self):
        return f"StatsDict({dict(self)!r})"


def frac_of(num: str, den: str) -> Callable[[StatsDict], float]:
    """Derived-key helper: ``num/den`` ratio, 0.0 on empty denominator."""
    def _f(s: StatsDict) -> float:
        d = s[den]
        return s[num] / d if d else 0.0
    return _f


# ---- per-request trace timelines --------------------------------------------


class RequestTrace:
    """Ordered span-event timeline for one request across every layer
    it touches (global scheduler, queue, prefetch pipeline, engine or
    sim iteration loop), surviving retries: a re-routed attempt closes
    the previous attempt's open spans with ``status="error"`` and the
    timeline continues.

    Events are plain dicts ``{"t", "name", "kind", ...attrs}`` with
    ``kind`` in {"point", "begin", "end"}; ``end`` events carry
    ``status`` ("ok" | "error"). JSON-ready via ``to_dict()``.
    """

    __slots__ = ("request", "events", "_open")

    def __init__(self, request):
        self.request = request
        self.events: List[Dict[str, Any]] = []
        self._open: Dict[str, Dict[str, Any]] = {}

    # ---- recording -----------------------------------------------------

    @property
    def last_t(self) -> float:
        return self.events[-1]["t"] if self.events else 0.0

    def point(self, name: str, t: float, **attrs) -> None:
        ev = {"t": t, "name": name, "kind": "point"}
        ev.update(attrs)
        self.events.append(ev)

    def begin(self, name: str, t: float, **attrs) -> None:
        """Open a span; re-opening an already-open span is a no-op (the
        earliest begin wins — re-admission paths may touch it twice)."""
        if name in self._open:
            return
        ev = {"t": t, "name": name, "kind": "begin"}
        ev.update(attrs)
        self.events.append(ev)
        self._open[name] = ev

    def end(self, name: str, t: float, status: str = "ok",
            **attrs) -> None:
        """Close a span; closing a span that is not open is a no-op."""
        begin = self._open.pop(name, None)
        if begin is None:
            return
        ev = {"t": t, "name": name, "kind": "end", "status": status,
              "dur": t - begin["t"]}
        ev.update(attrs)
        self.events.append(ev)

    def close_open(self, t: float, status: str = "error") -> List[str]:
        """Close EVERY open span (crash / abort / retry paths must
        leave no span leaked). Returns the closed names."""
        names = list(self._open)
        for name in names:
            self.end(name, t, status=status)
        return names

    def open_spans(self) -> List[str]:
        return list(self._open)

    def annotate_last(self, name: str, **attrs) -> None:
        """Attach attrs to the most recent event named ``name`` — the
        runtime that knows modeled seconds (the simulator's cost-model
        charge) annotates the event the shared scheduler code stamped
        with tokens."""
        for ev in reversed(self.events):
            if ev["name"] == name:
                ev.update(attrs)
                return

    # ---- attribution ---------------------------------------------------

    def _attempt_events(self) -> List[Dict[str, Any]]:
        """Events of the LAST attempt (after the final retry point) —
        a retried request must not mix pre-crash charges into the
        attempt that actually served it."""
        start = 0
        for i, ev in enumerate(self.events):
            if ev["name"] == "retry":
                start = i + 1
        return self.events[start:]

    def _charge(self, name: str, attr: str = "seconds") -> float:
        return sum(ev.get(attr, 0.0) for ev in self._attempt_events()
                   if ev["name"] == name and ev["kind"] == "point")

    def breakdown(self) -> Dict[str, Any]:
        bd = request_breakdown(
            self.request,
            restore_seconds=self._charge("restore"),
            migrate_seconds=self._charge("migrate"))
        bd["prefetch_hidden"] = self._charge("prefetch_claim")
        bd["prefetch_hidden_tokens"] = self._charge("prefetch_claim",
                                                    "tokens")
        # speculative decoding (§14): informational, NOT summed into the
        # timeline components — `decode` already contains the wall time;
        # these say how many draft tokens rode it and how many stuck
        bd["spec_proposed_tokens"] = self._charge("spec", "proposed")
        bd["spec_accepted_tokens"] = self._charge("spec", "accepted")
        return bd

    def to_dict(self) -> Dict[str, Any]:
        return {"request_id": self.request.request_id,
                "events": list(self.events),
                "open": self.open_spans()}


def request_breakdown(r, restore_seconds: float = 0.0,
                      migrate_seconds: float = 0.0) -> Dict[str, Any]:
    """Timestamp-exact latency attribution (module docstring has the
    semantics). Works from the Request's canonical timestamps alone;
    modeled DMA charges are clamped into the measured prefill window so
    the components ALWAYS sum exactly to ttft()/latency()."""
    state = getattr(r.state, "value", str(r.state))
    if state != "finished":
        out = {c: 0.0 for c in BREAKDOWN_COMPONENTS}
        out.update(status=state, ttft=0.0,
                   latency=(r.finish_time - r.arrival_time
                            if r.finish_time else 0.0))
        return out
    sched_delay = r.scheduled_time - r.arrival_time
    queue = r.first_run_time - r.scheduled_time
    prefill = r.first_token_time - r.first_run_time
    restore = min(max(restore_seconds, 0.0), prefill)
    migrate = min(max(migrate_seconds, 0.0), prefill - restore)
    compute = prefill - restore - migrate
    decode = r.finish_time - r.first_token_time
    return {"status": state, "sched_delay": sched_delay, "queue": queue,
            "restore": restore, "migrate": migrate, "compute": compute,
            "decode": decode, "ttft": r.ttft(), "latency": r.latency()}


# ---- facade -----------------------------------------------------------------


class Telemetry:
    """One per run. Holds the registry, the structured event log, and
    every trace it created. Runtimes treat a disabled Telemetry exactly
    like ``None`` (byte-identical runs), so callers can flip one flag.
    """

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.events: List[Dict[str, Any]] = []
        self.traces: List[RequestTrace] = []
        self.max_events = max_events
        self._observed: set = set()
        self._dropped_events = 0
        self.spans: List[Tuple[str, float, float]] = []
        self.max_spans = 200_000
        self.dropped_spans = 0

    # ---- wiring ---------------------------------------------------------

    def adopt(self, stats, prefix: str, **labels) -> StatsDict:
        """Turn a component's stats mapping into a registry-backed view
        (in place when it is already a StatsDict — the engine's derived
        keys survive)."""
        if not isinstance(stats, StatsDict):
            stats = StatsDict(stats)
        return stats.bind(self.registry, prefix, **labels)

    def gauge_fn(self, name: str, fn: Callable[[], Any],
                 **labels) -> None:
        self.registry.gauge_fn(name, fn, **labels)

    # ---- event log ------------------------------------------------------

    def event(self, name: str, t: float, **attrs) -> None:
        if len(self.events) >= self.max_events:
            self._dropped_events += 1      # bounded log, never silent:
            return                         # snapshot() reports the drop
        ev = {"t": t, "event": name}
        ev.update(attrs)
        self.events.append(ev)

    def events_named(self, name: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["event"] == name]

    # ---- host spans -----------------------------------------------------

    def span(self, name: str, t0: float) -> float:
        """Record the host span ``(name, t0, now)``, ``t0`` and now on
        ``time.perf_counter()``, and return now (the next span's start).
        Bounded like the event log: past ``max_spans`` the span is
        counted in ``dropped_spans`` instead."""
        t1 = time.perf_counter()
        if len(self.spans) < self.max_spans:
            self.spans.append((name, t0, t1))
        else:
            self.dropped_spans += 1
        return t1

    # ---- traces ---------------------------------------------------------

    def trace(self, request, now: float) -> RequestTrace:
        """Attach (or continue) a request's timeline and stamp the
        submit point for this attempt."""
        tr = request.trace
        if tr is None:
            tr = request.trace = RequestTrace(request)
            self.traces.append(tr)
        tr.point("submit", now, attempt=request.retries)
        return tr

    def open_spans(self) -> Dict[int, List[str]]:
        """{request_id: open span names} over every trace — empty after
        a clean run (terminal paths close everything)."""
        return {tr.request.request_id: tr.open_spans()
                for tr in self.traces if tr.open_spans()}

    def observe_request(self, r, now: float) -> None:
        """Terminal observation: fold the request's end-to-end numbers
        and breakdown into the per-class (workload-labeled) histograms.
        Idempotent per request id."""
        if r.request_id in self._observed:
            return
        self._observed.add(r.request_id)
        reg = self.registry
        wl = r.workload or "default"
        state = getattr(r.state, "value", str(r.state))
        if state == "finished":
            reg.counter("request_finished", workload=wl).inc()
            reg.histogram("request_latency_seconds",
                          workload=wl).observe(r.latency())
            reg.histogram("request_ttft_seconds",
                          workload=wl).observe(r.ttft())
            bd = (r.trace.breakdown() if r.trace is not None
                  else request_breakdown(r))
            for comp in BREAKDOWN_COMPONENTS:
                reg.histogram("request_breakdown_seconds", workload=wl,
                              component=comp).observe(bd[comp])
            self.event("request_finished", now, id=r.request_id,
                       latency=r.latency(), ttft=r.ttft())
        else:
            reg.counter("request_failed", workload=wl).inc()
            if r.trace is not None:
                r.trace.close_open(now, status="error")
            self.event("request_failed", now, id=r.request_id,
                       retries=r.retries)

    # ---- export ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        out = self.registry.snapshot()
        out["events"] = {"n": len(self.events),
                         "dropped": self._dropped_events}
        out["traces"] = {"n": len(self.traces),
                         "open_spans": self.open_spans()}
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **kw)

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()
