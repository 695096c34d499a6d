"""ClusterRuntime: the real-engine distributed serving loop (counterpart
of the JAX package's ``serving/cluster.py``).

GlobalScheduler (E2) in front of N Engines. Virtual time advances per
engine iteration. Engines run the paged fused
data plane, or the dense one with ``EngineConfig(paged=False)``.
``check_invariants`` reconciles the layers after any amount of
rebalancing: pool refcounts, scheduler token accounting, and the global
scheduler's cached-token gauges.

With host KV tiers (``EngineConfig.host_capacity_tokens``) E2 may plan
a host-to-host migration of a demoted span (``_execute_migration``) or a
schedule-time prefetch rider; ``drain_instance`` migrates a retiring
instance's host tier to a survivor.

Fault tolerance: built with a ``FaultConfig`` the runtime injects
crashes, copy failures and notification loss through a shared
``FaultInjector`` and survives them — heartbeat-driven
ALIVE→SUSPECT→DEAD detection, retry with budget + exponential backoff
into a terminal FAILED state, delayed notifications, periodic
anti-entropy reconciliation. With no FaultConfig every hook is inert.

Multi-chip instances (``chips_per_instance``): the mesh-of-meshes. The
devices are carved into disjoint groups (``launch/mesh.py::
partition_devices``), one per instance: a k-chip instance is a
tensor-parallel engine over its group, a 1-chip one a plain engine on
its device. Each registers with E2 at its aggregate capacity (per-chip
capacity x chips) and a cost model re-derived for its chip count
(``CostModel.with_chips``). ``add_instance`` carves a multi-chip
instance's group from the devices no instance owns yet.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.cost_model import CostModel, cost_model_for
from ..core.e2 import MigrationPlan
from ..core.global_scheduler import GlobalScheduler, GlobalSchedulerConfig
from ..core.request import Request, RequestState
from ..launch.mesh import partition_devices, visible_devices
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
                 device="cuda", devices: Optional[Sequence] = None):
        """``chips_per_instance`` None: every instance runs on the one
        card ``device``. A list gives instance i's TP degree: the
        ``devices`` (default: the visible cards; CPU shards when
        ``device`` is the CPU; a list may repeat a card, which emulates a
        submesh on it) are carved into disjoint groups, one per
        instance, each instance registered at its aggregate capacity
        with a cost model derived for its chip count."""
        self.policy = policy
        self.device = device
        # the devices a multi-chip instance may take, and how many the
        # instances hold (elastic add carves the next ones)
        self._devices = list(devices) if devices is not None else None
        self._device_ofs = 0
        # disabled telemetry is treated exactly like None
        self.telemetry = (telemetry if telemetry is not None
                          and telemetry.enabled else None)
        base = engine_cfg or EngineConfig()
        base_cm = cost_model or cost_model_for("smollm-360m")
        if base.speculative is not None and base_cm.spec_k == 0:
            # acceptance-aware decode pricing: E2's load_cost and
            # add_work must see the expected-tokens-per-step discount of
            # spec-on instances. A CostModel already priced for
            # speculation (spec_k != 0) is kept.
            sp = base.speculative
            base_cm = base_cm.with_speculative(sp.k, sp.acceptance,
                                               sp.draft_cost)
        gs_cfg = scheduler_cfg or GlobalSchedulerConfig(
            capacity_tokens=base.capacity_tokens,
            host_capacity_tokens=base.host_capacity_tokens)
        self.faults = (FaultInjector(fault_config)
                       if fault_config is not None else None)
        self.engines: Dict[int, Engine] = {}
        if chips_per_instance is None:
            self.gs = GlobalScheduler(num_instances=num_instances,
                                      cost_model=base_cm, config=gs_cfg)
            for i in range(num_instances):
                ec = dataclasses.replace(base, instance_id=i)
                self.engines[i] = Engine(model_cfg, params, ec,
                                         on_evict=self._notify_evictions,
                                         device=device)
                if self.faults is not None:
                    self.engines[i].attach_faults(self.faults)
        else:
            chips = [max(int(c), 1) for c in chips_per_instance]
            if len(chips) != num_instances:
                raise ValueError(
                    f"chips_per_instance has {len(chips)} entries for "
                    f"{num_instances} instances")
            groups = partition_devices(chips, self._devices,
                                       platform=self._platform)
            self._device_ofs = sum(chips)
            self.gs = GlobalScheduler(num_instances=0,
                                      cost_model=base_cm, config=gs_cfg)
            for i, (c, grp) in enumerate(zip(chips, groups)):
                ec = dataclasses.replace(base, instance_id=i,
                                         chips_per_instance=c)
                self.engines[i] = Engine(
                    model_cfg, params, ec, on_evict=self._notify_evictions,
                    device=grp[0], devices=grp if c > 1 else None)
                if self.faults is not None:
                    self.engines[i].attach_faults(self.faults)
                self.gs.add_instance(
                    i, capacity_tokens=ec.device_capacity_tokens,
                    host_capacity_tokens=ec.host_capacity_tokens,
                    cost_model=(base_cm.with_chips(c) if c > 1
                                else base_cm))
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
        self.stats = {"migrations": 0, "migrated_tokens": 0,
                      "drain_migrated_tokens": 0, "retries": 0,
                      "failed_terminal": 0, "failed_no_survivors": 0,
                      "recovered_requests": 0,
                      "crash_with_inflight_dma": 0}
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
        self.telemetry.gauge_fn("gs_host_cached_tokens",
                                lambda s=st: s.host_cached_tokens,
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
        prefetch = None
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
            if decision.migration is not None:
                self._execute_migration(request, inst, decision.migration,
                                        now)
            # the prefetch rider: a migrated span just landed in the
            # target's host tier, so its prefetch queue can start moving
            # it (and any other host chain) to the card while the
            # request waits
            prefetch = decision.prefetch
            if request.trace is not None:
                request.trace.point(
                    "schedule", now, instance=inst, mode=decision.mode,
                    cost=decision.cost, cached=decision.cached_len,
                    missed=decision.missed_len,
                    migrated=request.migrated_len,
                    prefetch=prefetch is not None)
        self.engines[inst].scheduler.enqueue(request, now,
                                             prefetch=prefetch)
        return inst

    # ---- tier-to-tier migration -------------------------------------------

    def _execute_migration(self, request: Request, dst: int,
                           plan: MigrationPlan, now: float) -> None:
        """HostKVStore -> HostKVStore transfer: export the planned span
        from the source's host tier (whole-node numpy pieces), ingest on
        the target (re-aligned to ITS tree, host-marked, LRU charged),
        and feed the executed ranges back to the global forest. The
        target's restore path then materializes the span on the card
        instead of recomputing the prefill. Whatever part of the plan no
        longer exists just recomputes — the same path an injected
        migration failure (whole or partial) degrades through."""
        src_e = self.engines.get(plan.src)
        dst_e = self.engines.get(dst)
        if (src_e is None or dst_e is None or src_e.failed
                or dst_e.host_store is None):
            return
        spans = src_e.scheduler.export_host_span(request.tokens,
                                                 plan.lo, plan.hi)
        if not spans:
            return
        if self.faults is not None and self.faults.dma_fails("migrate"):
            # the inter-host transfer failed; a partial failure keeps a
            # leading prefix of the whole-node pieces (still contiguous
            # from plan.lo, hence still ingestible)
            spans = spans[:self.faults.partial_keep(len(spans))]
            if not spans:
                return
        accepted = dst_e.scheduler.ingest_host_span(request.tokens, spans,
                                                    now)
        if accepted:
            request.migrated_len = sum(hi - lo for lo, hi in accepted)
            self.gs.on_migration(plan.src, dst, request.tokens, accepted,
                                 now)
            self.stats["migrations"] += 1
            self.stats["migrated_tokens"] += request.migrated_len

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
        """``InstanceCrashed`` escaped ``eng.step``: the engine died
        with (possibly) prefetch scatters and demote copies in flight."""
        eng = self.engines[inst]
        tier = eng.scheduler.host_tier
        if eng._prefetch_inflight or (tier is not None
                                      and getattr(tier, "_pending", None)):
            self.stats["crash_with_inflight_dma"] += 1
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

    def fault_stats(self) -> Dict[str, int]:
        """The injector's own counters (empty dict on fault-free runs)."""
        return dict(self.faults.stats) if self.faults is not None else {}

    def engine_stats(self) -> Dict[int, Dict[str, int]]:
        """Per-instance engine stats snapshot (includes the fused
        plane's dispatch accounting: model_dispatches, fused_iterations)."""
        return {i: dict(e.stats) for i, e in self.engines.items()}

    # ---- reconciliation ---------------------------------------------------------

    def check_invariants(self) -> None:
        """Cross-layer reconciliation, valid at any point of a run:

        * every alive paged engine's page pool (and draft pool) passes
          its refcount/free-list checks, and ("req", id) / ("dr", id)
          tables exist only for live requests;
        * scheduler token accounting and every global cached-token
          gauge (device and host) stay non-negative;
        * BOTH tiers reconcile: the host store's byte accounting equals
          the scheduler's host-LRU token accounting entry for entry, and
          the host tier respects its capacity;
        * the speculative-restore pipeline is quiescent between steps:
          no staged restore, no prefetch record or staging table
          survives its step, and every reserved-but-unclaimed prefetch
          page was refunded.
        """
        for i, eng in self.engines.items():
            if eng.failed:
                continue
            if eng.host_store is not None:
                eng._drain_demotes()   # land in-flight demote copies
            if eng.paged:
                eng.pool.check_invariants()
                live_reqs = {("req", rid) for rid in eng.live}
                req_tables = {k for k in eng.pool.tables
                              if isinstance(k, tuple) and k[0] == "req"}
                assert req_tables <= live_reqs, (
                    f"instance {i}: leaked request tables "
                    f"{req_tables - live_reqs}")
                if eng.draft is not None:
                    eng.draft.pool.check_invariants()
                    dr_tables = {k for k in eng.draft.pool.tables
                                 if isinstance(k, tuple) and k[0] == "dr"}
                    live_dr = {("dr", rid) for rid in eng.live}
                    assert dr_tables <= live_dr, (
                        f"instance {i}: leaked draft tables "
                        f"{dr_tables - live_dr}")
            assert eng.scheduler.used_tokens >= 0, (
                f"instance {i}: negative scheduler token accounting")
            if eng.host_store is not None:
                sch = eng.scheduler
                eng.host_store.check_invariants()
                assert sch.host_used_tokens == eng.host_store.used_tokens, (
                    f"instance {i}: host tier accounting diverged "
                    f"(scheduler {sch.host_used_tokens} vs store "
                    f"{eng.host_store.used_tokens})")
                assert set(sch._host_lru) == set(eng.host_store.entries), (
                    f"instance {i}: host tier entry sets diverged")
                assert (sch.host_used_tokens
                        <= sch.config.host_capacity_tokens), (
                    f"instance {i}: host tier over capacity")
                assert not eng._pending_restore, (
                    f"instance {i}: unflushed restore stage")
                assert not eng._prefetch_inflight, (
                    f"instance {i}: undrained prefetch records")
                assert not sch._prefetch_recs, (
                    f"instance {i}: prefetch records survived their "
                    f"step")
                assert sch.prefetch_reserved_tokens == 0, (
                    f"instance {i}: reserved-but-unclaimed prefetch "
                    f"pages not refunded at drain")
                pf_tables = [k for k in eng.pool.tables
                             if isinstance(k, tuple) and k[0] == "pf"]
                assert not pf_tables, (
                    f"instance {i}: leaked prefetch staging tables "
                    f"{pf_tables}")
        for i, inst in self.gs.instances.items():
            assert inst.cached_tokens >= 0, (
                f"global gauge for instance {i} went negative")
            assert inst.host_cached_tokens >= 0, (
                f"global host gauge for instance {i} went negative")

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

    def drain_instance(self, inst: int, now: float) -> int:
        """Graceful drain (planned failover / scale-down): MIGRATE the
        instance's host-tier entries — shallowest first — to the
        least-loaded surviving instance with a host tier (a move: the
        source markings transfer), then re-route its in-flight
        requests. Re-hits on the drained instance's demoted prefixes
        keep costing a restore, not a recompute. Returns tokens
        migrated out."""
        src_e = self.engines[inst]
        moved = 0
        targets = [j for j, e in self.engines.items()
                   if j != inst and not e.failed
                   and e.host_store is not None
                   and self.gs.instances[j].alive]
        if targets and src_e.host_store is not None and not src_e.failed:
            src_e._drain_demotes()
            loads = self.gs.loads(now)
            dst = min(targets, key=lambda j: loads.get(j, 0.0))
            dst_ls = self.engines[dst].scheduler
            src_ls = src_e.scheduler
            # SHALLOW-first: a child span can only land on the target
            # after its ancestor created the start boundary there
            for key in sorted(src_ls._host_lru,
                              key=lambda k: k.depth):
                nid = src_ls._host_nodes.get(key)
                node = src_ls.tree.get_node(nid) if nid is not None else None
                if node is None:
                    continue
                tokens = node.full_tokens()
                end = node.depth_tokens()
                start = end - len(node.tokens)
                toks = src_ls._host_lru.get(key, 0)
                if toks < end - start:
                    continue   # partial entry: its tail edge is not a
                               # node boundary anywhere — recompute it
                spans = src_ls.export_host_span(tokens, start, end)
                accepted = dst_ls.ingest_host_span(tokens, spans, now)
                if accepted:
                    moved += sum(hi - lo for lo, hi in accepted)
                    self.gs.on_migration(inst, dst, tokens, accepted, now,
                                         move=True)
            self.stats["drain_migrated_tokens"] += moved
        reqs = src_e.fail()
        self.gs.remove_instance(inst, now)
        for r in reqs:
            self._reroute(r, now)
        return moved

    @property
    def _platform(self) -> str:
        return torch.device(self.device).type

    def add_instance(self, model_cfg, params, now: float,
                     engine_cfg: Optional[EngineConfig] = None) -> int:
        """Elastic scale-up: register and start a fresh instance. A
        multi-chip ``engine_cfg`` carves its submesh from the devices no
        instance owns yet (the mesh-of-meshes stays disjoint) and
        registers at aggregate capacity with a chips-derived cost model;
        a 1-chip one runs on the runtime's device."""
        inst = max(self.engines) + 1
        ec = dataclasses.replace(engine_cfg or EngineConfig(),
                                 instance_id=inst)
        chips = max(ec.chips_per_instance, 1)
        devices = None
        if chips > 1:
            ofs = self._device_ofs
            pool = self._devices
            if pool is None and self._platform != "cpu":
                pool = visible_devices(self._platform)
            devices = partition_devices(
                [chips], pool[ofs:] if pool is not None else None,
                platform=self._platform)[0]
            self._device_ofs = ofs + chips
        self.engines[inst] = Engine(model_cfg, params, ec,
                                    on_evict=self._notify_evictions,
                                    device=self.device, devices=devices)
        if self.faults is not None:
            self.engines[inst].attach_faults(self.faults)
        self.gs.add_instance(inst,
                             capacity_tokens=ec.device_capacity_tokens,
                             host_capacity_tokens=ec.host_capacity_tokens,
                             now=now,
                             cost_model=(self.gs.cost_model.with_chips(chips)
                                         if chips > 1 else None))
        if self.telemetry is not None:
            self.engines[inst].attach_telemetry(self.telemetry)
            self._gs_gauges(inst)
        return inst
