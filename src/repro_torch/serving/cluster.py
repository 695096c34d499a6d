"""ClusterRuntime: the real-engine distributed serving loop (counterpart
of the JAX package's ``serving/cluster.py``).

GlobalScheduler (E2) in front of N Engines, all on one ``device``.
Virtual time advances per engine iteration. Engines run the paged fused
data plane. ``check_invariants`` reconciles the layers after any amount
of rebalancing: pool refcounts, scheduler token accounting, and the
global scheduler's cached-token gauges.

Fault tolerance: built with a ``FaultConfig`` the runtime injects
crashes and notification loss through a shared ``FaultInjector`` and
survives them — heartbeat-driven ALIVE→SUSPECT→DEAD detection, retry
with budget + exponential backoff into a terminal FAILED state, delayed
notifications, periodic anti-entropy reconciliation. With no
FaultConfig every hook is inert.

Not ported yet: host KV tiers (so no tier-to-tier migration and no
host-tier drain) and multi-chip instances (``chips_per_instance``).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.cost_model import CostModel, cost_model_for
from ..core.global_scheduler import GlobalScheduler, GlobalSchedulerConfig
from ..core.request import Request, RequestState
from .engine import Engine, EngineConfig
from .faults import FaultConfig, FaultInjector, InstanceCrashed
from .telemetry import Telemetry


class ClusterRuntime:
    def __init__(self, model_cfg, params, num_instances: int,
                 engine_cfg: Optional[EngineConfig] = None,
                 scheduler_cfg: Optional[GlobalSchedulerConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 policy: str = "e2",
                 fault_config: Optional[FaultConfig] = None,
                 retry_budget: int = 3,
                 retry_backoff: float = 0.0,
                 telemetry: Optional[Telemetry] = None,
                 chips_per_instance: Optional[Sequence[int]] = None,
                 device="cuda"):
        """Every instance shares the one card ``device``;
        ``chips_per_instance`` must stay None (not ported yet)."""
        if chips_per_instance is not None:
            raise NotImplementedError("chips_per_instance (multi-chip "
                                      "instances) is not ported yet")
        self.policy = policy
        self.device = device
        # disabled telemetry is treated exactly like None
        self.telemetry = (telemetry if telemetry is not None
                          and telemetry.enabled else None)
        base = engine_cfg or EngineConfig()
        base_cm = cost_model or cost_model_for("smollm-360m")
        gs_cfg = scheduler_cfg or GlobalSchedulerConfig(
            capacity_tokens=base.capacity_tokens,
            host_capacity_tokens=base.host_capacity_tokens)
        self.faults = (FaultInjector(fault_config)
                       if fault_config is not None else None)
        self.engines: Dict[int, Engine] = {}
        self.gs = GlobalScheduler(num_instances=num_instances,
                                  cost_model=base_cm, config=gs_cfg)
        for i in range(num_instances):
            ec = dataclasses.replace(base, instance_id=i)
            self.engines[i] = Engine(model_cfg, params, ec,
                                     on_evict=self._notify_evictions,
                                     device=device)
            if self.faults is not None:
                self.engines[i].attach_faults(self.faults)
        self._rr_next = 0
        self.finished: List[Request] = []
        # terminal failures (retry budget exhausted / zero survivors)
        self.failed_requests: List[Request] = []
        self.retry_budget = retry_budget
        self.retry_backoff = retry_backoff
        self._retry_q: List[Tuple[float, int, Request]] = []
        self._retry_seq = itertools.count()
        # delayed eviction notifications: (due, inst, spans, demoted,
        # host_dropped)
        self._pending_notify: List[Tuple[float, int, list, list, list]] = []
        self._straggle_credit: Dict[int, float] = {}
        self._now = 0.0
        self._last_reconcile = 0.0
        self._detection = self.gs.config.heartbeat_interval > 0.0
        self.stats = {"retries": 0, "failed_terminal": 0,
                      "failed_no_survivors": 0, "recovered_requests": 0}
        if self.telemetry is not None:
            tel = self.telemetry
            self.stats = tel.adopt(self.stats, "runtime")
            self.gs.stats = tel.adopt(self.gs.stats, "gs")
            if self.faults is not None:
                self.faults.stats = tel.adopt(self.faults.stats, "faults")
            for i, eng in self.engines.items():
                eng.attach_telemetry(tel)
                self._gs_gauges(i)

    def _gs_gauges(self, inst: int) -> None:
        """Callback gauges over the global scheduler's per-instance
        cached-token estimates — the surfaces anti-entropy repairs."""
        st = self.gs.instances[inst]
        self.telemetry.gauge_fn("gs_cached_tokens",
                                lambda s=st: s.cached_tokens,
                                instance=inst)

    def _notify_evictions(self, inst: int, spans, *, demoted=(),
                          host_dropped=()) -> None:
        """Eviction notification (protocol v2). With faults attached the
        notification can be dropped (anti-entropy repairs the drift
        later) or delayed (queued for a later step)."""
        if self.faults is not None:
            if self.faults.drop_notify():
                return
            d = self.faults.notify_delay()
            if d > 0.0:
                self._pending_notify.append(
                    (self._now + d, inst, list(spans), list(demoted),
                     list(host_dropped)))
                return
        self.gs.on_evictions(inst, spans, demoted=demoted,
                             host_dropped=host_dropped)

    # ---- request intake -------------------------------------------------

    def submit(self, request: Request, now: float) -> int:
        tel = self.telemetry
        if tel is not None:
            tel.trace(request, now)
        alive = self.gs.alive_instances()
        if not alive:
            # zero survivors: park the request as terminally failed
            request.state = RequestState.FAILED
            request.finish_time = now
            self.stats["failed_no_survivors"] += 1
            self.failed_requests.append(request)
            if tel is not None:
                request.trace.close_open(now, status="error")
                request.trace.point("failed", now,
                                    reason="no_survivors")
                tel.observe_request(request, now)
            return -1
        if self.policy == "rr":
            inst = alive[self._rr_next % len(alive)]
            self._rr_next += 1
            request.instance = inst
            request.scheduled_time = now
            if request.trace is not None:
                request.trace.point("schedule", now, instance=inst,
                                    mode="rr")
        else:
            decision = self.gs.schedule(request, now)
            inst = decision.instance
            if decision.migration is not None \
                    or decision.prefetch is not None:
                # E2 plans these only for host-tier spans
                raise NotImplementedError("host-tier migration/prefetch "
                                          "is not ported yet")
            if request.trace is not None:
                request.trace.point(
                    "schedule", now, instance=inst, mode=decision.mode,
                    cost=decision.cost, cached=decision.cached_len,
                    missed=decision.missed_len)
        self.engines[inst].scheduler.enqueue(request, now)
        return inst

    # ---- the loop ----------------------------------------------------------

    def step(self, now: float) -> List[Request]:
        self._now = max(self._now, now)
        if self.faults is not None:
            self._deliver_notifications(now)
            for inst in self.faults.crashes_due(now):
                self._crash_instance(inst, now)
        if self._retry_q:
            self._drain_retries(now)
        done: List[Request] = []
        for inst, eng in self.engines.items():
            if eng.failed or not self.gs.instances[inst].alive:
                continue
            if self.faults is not None and not self._straggle_tick(inst):
                # straggling, not dead: skip the iteration but keep
                # heartbeating
                self._heartbeat(inst, now)
                continue
            try:
                out = eng.step(now)
            except InstanceCrashed:
                self._crashed_mid_step(inst, now)
                continue
            for r in out:
                self.gs.on_request_complete(r, now)
                if self.telemetry is not None:
                    self.telemetry.observe_request(r, now)
                done.append(r)
            self._heartbeat(inst, now)
        if self._detection:
            for inst in self.gs.check_health(now):
                self._recover_instance(inst, now)
        re = self.gs.config.reconcile_every
        if re > 0.0 and now - self._last_reconcile >= re:
            self.reconcile_all(now)
        self.finished.extend(done)
        return done

    def run(self, requests: Sequence[Request], *, dt: float = 0.05,
            max_iters: int = 100_000) -> List[Request]:
        """Drive arrivals (by request.arrival_time) + engine iterations in
        virtual time until every request FINISHED or terminally FAILED."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        now, i, n_total = 0.0, 0, len(pending)
        it = 0
        while len(self.finished) + len(self.failed_requests) < n_total:
            it += 1
            if it > max_iters:
                raise RuntimeError("cluster run did not converge")
            while i < len(pending) and pending[i].arrival_time <= now:
                self.submit(pending[i], now)
                i += 1
            self.step(now)
            now += dt
            # idle fast-forward to the next externally-scheduled event
            if all(e.depth == 0 for e in self.engines.values()
                   if not e.failed):
                nxt: List[float] = []
                if i < len(pending):
                    nxt.append(pending[i].arrival_time)
                if self._retry_q:
                    nxt.append(self._retry_q[0][0])
                if self._pending_notify:
                    nxt.append(min(p[0] for p in self._pending_notify))
                if self.faults is not None:
                    t = self.faults.next_crash_time()
                    if t is not None:
                        nxt.append(t)
                if nxt:
                    now = max(now, min(nxt))
        return self.finished

    # ---- fault machinery ------------------------------------------------

    def _heartbeat(self, inst: int, now: float) -> None:
        if not self._detection:
            return
        if self.faults is not None and self.faults.drop_heartbeat():
            return
        self.gs.heartbeat(inst, now)

    def _straggle_tick(self, inst: int) -> bool:
        """Straggler pacing: a factor-f instance runs one real step per f
        cluster steps."""
        f = self.faults.straggle_factor(inst)
        if f <= 1.0:
            return True
        c = self._straggle_credit.get(inst, 0.0) + 1.0 / f
        if c >= 1.0:
            self._straggle_credit[inst] = c - 1.0
            return True
        self._straggle_credit[inst] = c
        return False

    def _crash_instance(self, inst: int, now: float) -> None:
        """A scheduled crash came due: arm the in-step fault point
        (mid-step mode) or kill the data plane here between steps."""
        eng = self.engines.get(inst)
        if eng is None or eng.failed:
            return
        if self.faults.cfg.crash_mid_step:
            self.faults.arm_crash(inst)
            return
        self.faults.record_crash(inst)
        if self.telemetry is not None:
            self.telemetry.event("crash", now, instance=inst,
                                 mid_step=False)
        eng.crash()
        if not self._detection:
            self._recover_instance(inst, now)   # oracle fallback

    def _crashed_mid_step(self, inst: int, now: float) -> None:
        """``InstanceCrashed`` escaped ``eng.step``."""
        if self.telemetry is not None:
            self.telemetry.event("crash", now, instance=inst,
                                 mid_step=True)
        self.engines[inst].crash()
        if not self._detection:
            self._recover_instance(inst, now)   # oracle fallback

    def _recover_instance(self, inst: int, now: float) -> None:
        """The control plane knows ``inst`` is dead: repair the global
        forest, drain the stranded requests, re-route them."""
        if self.gs.instances[inst].alive:
            self.gs.on_instance_failure(inst)
        reqs = self.engines[inst].fail()
        self.stats["recovered_requests"] += len(reqs)
        if self.telemetry is not None:
            self.telemetry.event("recover", now, instance=inst,
                                 requests=len(reqs))
        for r in reqs:
            self._reroute(r, now)

    def _reroute(self, r: Request, now: float) -> None:
        """Retry with budget + exponential backoff; past the budget the
        request terminally FAILs."""
        if r.state == RequestState.FINISHED:
            return
        r.reset_for_retry(now)
        r.retries += 1
        tel = self.telemetry
        if r.retries > self.retry_budget:
            r.state = RequestState.FAILED
            r.finish_time = now
            self.stats["failed_terminal"] += 1
            self.failed_requests.append(r)
            if tel is not None:
                if r.trace is not None:
                    r.trace.point("failed", now, reason="retry_budget")
                tel.observe_request(r, now)
            return
        self.stats["retries"] += 1
        if self.retry_backoff > 0.0:
            delay = self.retry_backoff * (2.0 ** (r.retries - 1))
            if tel is not None:
                tel.event("retry", now, id=r.request_id,
                          attempt=r.retries, backoff=delay)
                if r.trace is not None:
                    r.trace.point("backoff", now, delay=delay)
            heapq.heappush(self._retry_q,
                           (now + delay, next(self._retry_seq), r))
        else:
            if tel is not None:
                tel.event("retry", now, id=r.request_id,
                          attempt=r.retries, backoff=0.0)
            self.submit(r, now)

    def _drain_retries(self, now: float) -> None:
        while self._retry_q and self._retry_q[0][0] <= now:
            _, _, r = heapq.heappop(self._retry_q)
            self.submit(r, now)

    def _deliver_notifications(self, now: float) -> None:
        due = [p for p in self._pending_notify if p[0] <= now]
        if not due:
            return
        self._pending_notify = [p for p in self._pending_notify
                                if p[0] > now]
        for _, inst, spans, demoted, hdrop in due:
            self.gs.on_evictions(inst, spans, demoted=demoted,
                                 host_dropped=hdrop)

    def reconcile_all(self, now: float) -> int:
        """Gauge anti-entropy: every alive instance ships its residency
        digest and the global scheduler repairs its markings."""
        self._last_reconcile = now
        repairs = 0
        for inst, eng in self.engines.items():
            if eng.failed or not self.gs.instances[inst].alive:
                continue
            repairs += self.gs.reconcile(
                inst, eng.scheduler.residency_digest(), now)
        return repairs

    # ---- reconciliation ---------------------------------------------------------

    def check_invariants(self) -> None:
        """Cross-layer reconciliation, valid at any point of a run: every
        alive engine's page pool passes its refcount/free-list checks,
        scheduler accounting never goes negative, ("req", id) tables
        exist only for live requests, and every global cached-token
        gauge stays non-negative."""
        for i, eng in self.engines.items():
            if eng.failed:
                continue
            eng.pool.check_invariants()
            live_reqs = {("req", rid) for rid in eng.live}
            req_tables = {k for k in eng.pool.tables
                          if isinstance(k, tuple) and k[0] == "req"}
            assert req_tables <= live_reqs, (
                f"instance {i}: leaked request tables "
                f"{req_tables - live_reqs}")
            assert eng.scheduler.used_tokens >= 0, (
                f"instance {i}: negative scheduler token accounting")
        for i, inst in self.gs.instances.items():
            assert inst.cached_tokens >= 0, (
                f"global gauge for instance {i} went negative")

    # ---- fault handling --------------------------------------------------------

    def fail_instance(self, inst: int, now: float) -> int:
        """Hard-kill an instance through the ORACLE path (the control
        plane knows instantly). Re-routed requests are scrubbed and
        retry-budgeted."""
        eng = self.engines[inst]
        if eng.failed and not self.gs.instances[inst].alive:
            return 0
        reqs = eng.fail()
        if self.gs.instances[inst].alive:
            self.gs.on_instance_failure(inst)
        self.stats["recovered_requests"] += len(reqs)
        for r in reqs:
            self._reroute(r, now)
        return len(reqs)

    def add_instance(self, model_cfg, params, now: float,
                     engine_cfg: Optional[EngineConfig] = None) -> int:
        """Elastic scale-up: register and start a fresh instance on the
        runtime's device."""
        inst = max(self.engines) + 1
        ec = dataclasses.replace(engine_cfg or EngineConfig(),
                                 instance_id=inst)
        self.engines[inst] = Engine(model_cfg, params, ec,
                                    on_evict=self._notify_evictions,
                                    device=self.device)
        if self.faults is not None:
            self.engines[inst].attach_faults(self.faults)
        self.gs.add_instance(inst,
                             capacity_tokens=ec.device_capacity_tokens,
                             host_capacity_tokens=ec.host_capacity_tokens,
                             now=now)
        if self.telemetry is not None:
            self.engines[inst].attach_telemetry(self.telemetry)
            self._gs_gauges(inst)
        return inst
