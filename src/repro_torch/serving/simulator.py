"""Discrete-event cluster simulator — reproduces the paper's experiments
at 2–400-GPU scale on one CPU. The port's counterpart of the JAX
package's simulator: the same names, config fields, event loop and
arithmetic, so under the same cost-model numbers the two agree exactly.

The schedulers under test are the REAL ones (GlobalScheduler + one
LocalScheduler per instance, the exact code the engine runs); only the
model forward is replaced by its service-time estimate from the same
CostModel that E2's Algorithm 2 uses (paper App. B shows prefill/decode
time is linear in tokens — the regression the paper itself fits).

Service times come from ``cost_model_for(cfg.model,
cfg.chips_per_instance)``, which in the port carries the NVIDIA H100 SXM
data-sheet constants (``core/cost_model.py``). A run that needs other
numbers (coefficients fitted to the engine with ``CostModel.fit``, or
another card's constants) replaces this module's ``cost_model_for`` for
that run, e.g. with ``unittest.mock.patch.object``. As in the JAX
package, an iteration's time is ``CostModel.batch_time``, which does not
read the fitted ``decode_a`` / ``decode_b``: a pure-decode iteration
pays ``prefill_b``, one weight pass and its KV reads at the HBM rate.
The decode regression prices E2's placements (``decode_time``) only.

Baselines:
  policy="e2"  — Preble (this paper)
  policy="rr"  — round-robin data parallelism + per-instance prefix
                 caching (the paper's SGLang/vLLM baseline setup)

Fault parity (DESIGN.md §11): the same fault hooks the real cluster
runtime exposes — instance crashes, demote-DMA loss (through the
AccountingHostTier), dropped/delayed eviction notifications, heartbeat
detection, retry/backoff, gauge anti-entropy — so scheduler-level
benches can chaos-test placement quality without real engines.
"""

from __future__ import annotations

import heapq
import itertools
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.cost_model import CostModel, cost_model_for
from ..core.global_scheduler import GlobalScheduler, GlobalSchedulerConfig
from ..core.local_scheduler import (AccountingHostTier, LocalScheduler,
                                    LocalSchedulerConfig)
from ..core.request import Request, RequestState
from .faults import FaultConfig, FaultInjector
from .telemetry import Histogram, Telemetry


@dataclass
class SimConfig:
    num_instances: int = 4
    policy: str = "e2"                  # e2 | rr
    model: str = "mistral-7b"
    chips_per_instance: int = 1
    capacity_tokens: int = 400_000      # KV capacity per instance
    # host-offload tier per instance (0 = off): eviction demotes KV to
    # host, re-hits restore at CostModel.restore_time instead of
    # recomputing the prefill (hierarchical tiering, DESIGN.md §8)
    host_capacity_tokens: int = 0
    chunk_size: int = 512
    max_batch_tokens: int = 4096
    max_batch_requests: int = 256
    priority_groups: int = 10
    fcfs_local: bool = False            # ablation: disable priority queue
    window: float = 180.0
    th_bal: float = 2.0
    imbal_ratio: float = 0.85
    enable_rebalance: bool = True       # ablation switches
    enable_autoscale: bool = True
    enable_pd_balance: bool = True
    # tier-to-tier prefix migration (DESIGN.md §9): on rebalance /
    # explore, ship demoted host spans to the target's host tier
    # (accounting-only here; charged migrate_time + restore_time)
    enable_migration: bool = True
    # speculative restore (DESIGN.md §10): >0 enables the schedule-time
    # prefetch pipeline with this in-flight reservation budget (tokens)
    # per instance. Prefetched spans complete after
    # CostModel.prefetch_time seconds of modeled DMA — overlapping the
    # request's queue wait — and admission then restores only the
    # un-prefetched remainder, the same physics the engine's second
    # DMA stream realizes with real bytes.
    prefetch_budget_tokens: int = 0
    # Speculative decoding pricing (DESIGN.md §14; accounting-only —
    # the simulator still advances one committed token per decode slot
    # per iteration, but with spec_k > 0 every decode token is priced
    # at CostModel.spec_factor() x decode_a: the draft-propose overhead
    # divided by the expected (1 - a^(K+1)) / (1 - a) committed tokens
    # per target dispatch, matching the engine's fused draft/verify
    # plane and E2's placement pricing).
    spec_k: int = 0
    spec_acceptance: float = 0.8
    spec_draft_cost: float = 0.15
    speed_factors: Optional[Dict[int, float]] = None  # stragglers
    # ---- fault model (DESIGN.md §11; None = fault-free, zero-cost) ----
    faults: Optional[FaultConfig] = None
    heartbeat_interval: float = 0.0     # 0 = oracle failure knowledge
    suspect_misses: int = 3
    dead_misses: int = 10
    reconcile_every: float = 0.0        # gauge anti-entropy period
    retry_budget: int = 3
    retry_backoff: float = 0.25         # exponential backoff base (s)


@dataclass
class SimResult:
    finished: List[Request]
    makespan: float
    stats: Dict[str, float] = field(default_factory=dict)
    failed: List[Request] = field(default_factory=list)

    def latencies(self) -> List[float]:
        return [r.latency() for r in self.finished]

    def summary(self) -> Dict[str, float]:
        # Histogram uses the same sorted-index percentile definition
        # this method always had, so the numbers are bit-identical
        if not self.finished:
            return {}
        lat = Histogram.from_values(self.latencies())
        ttft = Histogram.from_values(r.ttft() for r in self.finished)
        n = lat.count
        return {
            "n": n,
            "avg_latency": lat.mean,
            "p50_latency": lat.percentile(0.50),
            "p99_latency": lat.percentile(0.99),
            "avg_ttft": ttft.mean,
            "p99_ttft": ttft.percentile(0.99),
            "makespan": self.makespan,
            "throughput_rps": n / self.makespan if self.makespan else 0.0,
            **self.stats,
        }


class Simulator:
    def __init__(self, cfg: SimConfig,
                 telemetry: Optional[Telemetry] = None):
        self.cfg = cfg
        # disabled telemetry == None: byte-identical event loop
        self.telemetry = (telemetry if telemetry is not None
                          and telemetry.enabled else None)
        self.cm = cost_model_for(cfg.model, cfg.chips_per_instance)
        if cfg.spec_k > 0:
            self.cm = self.cm.with_speculative(
                cfg.spec_k, cfg.spec_acceptance, cfg.spec_draft_cost)
        gs_cfg = GlobalSchedulerConfig(
            window=cfg.window, th_bal=cfg.th_bal,
            imbal_ratio=cfg.imbal_ratio,
            capacity_tokens=cfg.capacity_tokens,
            host_capacity_tokens=cfg.host_capacity_tokens,
            enable_migration=cfg.enable_migration,
            heartbeat_interval=cfg.heartbeat_interval,
            suspect_misses=cfg.suspect_misses,
            dead_misses=cfg.dead_misses,
            reconcile_every=cfg.reconcile_every)
        if not cfg.enable_rebalance:
            gs_cfg.th_bal = 1e18
        if not cfg.enable_autoscale:
            gs_cfg.autoscale_frac = 1e18
        if not cfg.enable_pd_balance:
            gs_cfg.imbal_ratio = 1.1        # ratio can never exceed 1
        self.gs = GlobalScheduler(num_instances=cfg.num_instances,
                                  cost_model=self.cm, config=gs_cfg)
        if cfg.speed_factors:
            for i, f in cfg.speed_factors.items():
                self.gs.set_speed_factor(i, f)
        self.faults = (FaultInjector(cfg.faults)
                       if cfg.faults is not None else None)
        self.locals: Dict[int, LocalScheduler] = {}
        for i in range(cfg.num_instances):
            self.locals[i] = LocalScheduler(
                LocalSchedulerConfig(
                    instance_id=i, capacity_tokens=cfg.capacity_tokens,
                    chunk_size=cfg.chunk_size,
                    max_batch_tokens=cfg.max_batch_tokens,
                    max_batch_requests=cfg.max_batch_requests,
                    priority_groups=cfg.priority_groups,
                    fcfs=cfg.fcfs_local,
                    window=cfg.window,
                    host_capacity_tokens=cfg.host_capacity_tokens,
                    prefetch_budget_tokens=cfg.prefetch_budget_tokens),
                on_evict=self._notify_evictions,
                host_tier=(AccountingHostTier(faults=self.faults)
                           if cfg.host_capacity_tokens > 0 else None))
        self._busy: Dict[int, bool] = {i: False for i in self.locals}
        self._rr = itertools.cycle(range(cfg.num_instances))
        self._ctx_sum: Dict[int, float] = {i: 0.0 for i in self.locals}
        self._ctx_n: Dict[int, int] = {i: 0 for i in self.locals}
        # instances whose data plane died (silent until detection)
        self._crashed: Set[int] = set()
        # delayed eviction notifications, delivered by the event loop
        self._pending_notify: List[Tuple[float, int, list, list, list]] = []
        self._now = 0.0
        self.finished: List[Request] = []
        self.failed: List[Request] = []
        self.fault_counters = {"retries": 0, "failed_terminal": 0,
                               "failed_no_survivors": 0,
                               "recovered_requests": 0}
        if self.telemetry is not None:
            tel = self.telemetry
            self.fault_counters = tel.adopt(self.fault_counters,
                                            "runtime")
            self.gs.stats = tel.adopt(self.gs.stats, "gs")
            if self.faults is not None:
                self.faults.stats = tel.adopt(self.faults.stats,
                                              "faults")
            for i, ls in self.locals.items():
                ls.telemetry = tel
                ls.stats = tel.adopt(ls.stats, "sched", instance=i)
                tel.gauge_fn("sched_used_tokens",
                             lambda s=ls: s.used_tokens, instance=i)
                tel.gauge_fn("sched_host_used_tokens",
                             lambda s=ls: s.host_used_tokens,
                             instance=i)
                tel.gauge_fn("sched_prefetch_reserved_tokens",
                             lambda s=ls: s.prefetch_reserved_tokens,
                             instance=i)
                st = self.gs.instances[i]
                tel.gauge_fn("gs_cached_tokens",
                             lambda s=st: s.cached_tokens, instance=i)
                tel.gauge_fn("gs_host_cached_tokens",
                             lambda s=st: s.host_cached_tokens,
                             instance=i)

    def _notify_evictions(self, inst: int, spans, *, demoted=(),
                          host_dropped=()) -> None:
        """Forward local evictions WITH the tier outcome (demoted vs
        truly dropped), so E2 keeps pricing demoted prefixes as
        restorable on that instance instead of writing them off.
        Protocol v2: content-addressed spans, keyword-only tiers. With
        faults: the notification can drop (anti-entropy repairs later)
        or queue for delayed delivery."""
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

    # ---- tier-to-tier migration (accounting path) ---------------------------

    def _execute_migration(self, r: Request, dst: int, plan, now: float
                           ) -> None:
        """Accounting-only HostKVStore-to-HostKVStore move: the source
        exports its demoted span coverage (no bytes under
        AccountingHostTier), the target host-marks/charges it, and the
        global forest learns the executed ranges. The request then pays
        migrate_time once plus the usual restore_time."""
        src_ls = self.locals.get(plan.src)
        if src_ls is None:
            return
        spans = src_ls.export_host_span(r.tokens, plan.lo, plan.hi)
        if not spans:
            return
        if self.faults is not None and self.faults.dma_fails("migrate"):
            # inter-host transfer lost (partial keeps a leading,
            # still-contiguous prefix of the whole-node pieces)
            spans = spans[:self.faults.partial_keep(len(spans))]
            if not spans:
                return
        accepted = self.locals[dst].ingest_host_span(r.tokens, spans, now)
        if accepted:
            r.migrated_len = sum(hi - lo for lo, hi in accepted)
            # sim-private: lets the prefetch pump verify a record
            # actually covers the migrated span before folding its
            # DCN leg into the pipeline latency
            r._migrated_ranges = list(accepted)
            self.gs.on_migration(plan.src, dst, r.tokens, accepted, now)

    # ---- service-time model ------------------------------------------------

    def _iter_time(self, inst: int, batch) -> float:
        # cache-aware prefill: only missed tokens burn compute — the first
        # chunk of a request skips its cached prefix (already accounted by
        # LocalScheduler chunking from cached_len). Host-tier restores
        # charge one bandwidth-bound DMA for the iteration's admissions
        # (the engine batches them into a single scatter the same way).
        n_dec = sum(1 for it in batch.items if it.phase == "decode")
        avg_ctx = None
        if self._ctx_n[inst]:
            avg_ctx = self._ctx_sum[inst] / self._ctx_n[inst]
        t = self.cm.batch_time(batch.prefill_tokens, n_dec, avg_ctx)
        restored = sum(it.restored_len for it in batch.items
                       if it.phase == "prefill")
        if restored:
            t += self.cm.restore_time(restored)
        # one-time DCN charge for spans that migrated in for this
        # request (the restore itself is in restored_len above)
        migrated = sum(it.migrated_len for it in batch.items
                       if it.phase == "prefill")
        if migrated:
            t += self.cm.migrate_time(migrated)
        sf = self.cfg.speed_factors or {}
        f = sf.get(inst, 1.0)
        if self.faults is not None:
            f *= self.faults.straggle_factor(inst)
        return t * f

    def _annotate_admission(self, inst: int, batch) -> None:
        """Attach the cost model's modeled DMA/DCN seconds to the
        restore / migrate / prefetch_claim events ``form_batch`` just
        stamped on each admitted request's trace, splitting the
        iteration's single batched charge pro-rata by tokens — the
        exact quantities ``_iter_time`` adds to the iteration,
        including the instance speed/straggle factor (deterministic,
        so recomputing it here perturbs nothing)."""
        sf = self.cfg.speed_factors or {}
        f = sf.get(inst, 1.0)
        if self.faults is not None:
            f *= self.faults.straggle_factor(inst)
        pre = [it for it in batch.items if it.phase == "prefill"]
        restored = sum(it.restored_len for it in pre)
        migrated = sum(it.migrated_len for it in pre)
        rt = self.cm.restore_time(restored) * f if restored else 0.0
        mt = self.cm.migrate_time(migrated) * f if migrated else 0.0
        for it in pre:
            tr = it.request.trace
            if tr is None:
                continue
            if it.restored_len:
                tr.annotate_last(
                    "restore", seconds=rt * it.restored_len / restored)
            if it.migrated_len:
                tr.annotate_last(
                    "migrate", seconds=mt * it.migrated_len / migrated)
            for ev in reversed(tr.events):
                # hidden cost the prefetch pipeline absorbed: what the
                # claimed tokens would have cost as a critical-path
                # restore at this admission (informational, not summed)
                if ev["name"] == "prefetch_claim":
                    ev["seconds"] = (self.cm.restore_time(
                        ev.get("tokens", 0)) * f
                        if ev.get("tokens") else 0.0)
                    break

    # ---- fault machinery -----------------------------------------------------

    def reconcile_all(self, now: float) -> int:
        """Gauge anti-entropy: ship every live instance's residency
        digest to the global scheduler; gauges/markings exact after."""
        repairs = 0
        for i, ls in self.locals.items():
            if i in self._crashed or not self.gs.instances[i].alive:
                continue
            repairs += self.gs.reconcile(i, ls.residency_digest(), now)
        return repairs

    def check_invariants(self) -> None:
        """Accounting reconciliation over the surviving instances —
        the sim-plane mirror of ClusterRuntime.check_invariants."""
        for i, ls in self.locals.items():
            if i in self._crashed or not self.gs.instances[i].alive:
                continue
            assert ls.used_tokens >= 0, (
                f"instance {i}: negative token accounting")
            if ls.config.host_capacity_tokens > 0:
                assert ls.host_used_tokens == sum(ls._host_lru.values()), (
                    f"instance {i}: host LRU / gauge diverged")
                assert (ls.host_used_tokens
                        <= ls.config.host_capacity_tokens), (
                    f"instance {i}: host tier over capacity")
                assert set(ls._host_nodes) == set(ls._host_lru), (
                    f"instance {i}: host node index / LRU diverged")
            assert ls.prefetch_reserved_tokens >= 0, (
                f"instance {i}: negative prefetch reservation")
        for i, inst in self.gs.instances.items():
            assert inst.cached_tokens >= 0, (
                f"global gauge for instance {i} went negative")
            assert inst.host_cached_tokens >= 0, (
                f"global host gauge for instance {i} went negative")

    def fault_stats(self) -> Dict[str, int]:
        out = dict(self.fault_counters)
        if self.faults is not None:
            out.update(self.faults.stats)
        return out

    # ---- main loop ------------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> SimResult:
        cfg = self.cfg
        events: List[Tuple[float, int, str, object]] = []
        seq = itertools.count()
        for r in requests:
            heapq.heappush(events,
                           (r.arrival_time, next(seq), "arrival", r))
        n_total = len(requests)
        finished = self.finished = []
        failed = self.failed = []
        now = 0.0
        detection = self.gs.config.heartbeat_interval > 0.0
        tick_itv = (self.gs.config.heartbeat_interval if detection
                    else self.gs.config.reconcile_every)
        if self.faults is not None:
            for inst, t in self.faults.cfg.crash_at.items():
                heapq.heappush(events, (t, next(seq), "crash", inst))
        if tick_itv > 0.0:
            heapq.heappush(events, (tick_itv, next(seq), "tick", None))
        last_reconcile = 0.0
        counters = self.fault_counters
        guard = max(1_000_000, 1_000 * max(n_total, 1))

        tel = self.telemetry

        def terminal_fail(r: Request, t: float, reason: str) -> None:
            r.state = RequestState.FAILED
            r.finish_time = t
            if tel is not None:
                if r.trace is None:
                    tel.trace(r, t)
                r.trace.close_open(t, status="error")
                r.trace.point("failed", t, reason=reason)
                tel.observe_request(r, t)
            failed.append(r)

        def reroute(r: Request, t: float) -> None:
            if r.state == RequestState.FINISHED:
                return
            r.reset_for_retry(t)
            r.retries += 1
            if r.retries > cfg.retry_budget:
                counters["failed_terminal"] += 1
                terminal_fail(r, t, "retry_budget")
                return
            counters["retries"] += 1
            delay = (cfg.retry_backoff * 2.0 ** (r.retries - 1)
                     if cfg.retry_backoff > 0.0 else 0.0)
            if tel is not None:
                tel.event("retry", t, id=r.request_id,
                          attempt=r.retries, backoff=delay)
                if r.trace is not None and delay > 0.0:
                    r.trace.point("backoff", t, delay=delay)
            heapq.heappush(events, (t + delay, next(seq), "arrival", r))

        def recover(inst: int, t: float) -> None:
            """The control plane learned ``inst`` is dead: repair the
            forest (unless the detector already did) and re-route its
            stranded requests."""
            if self.gs.instances[inst].alive:
                self.gs.on_instance_failure(inst, t)
            self._busy[inst] = False
            drained = self.locals[inst].drain()
            if tel is not None:
                tel.event("recover", t, instance=inst,
                          requests=len(drained))
            for r in drained:
                counters["recovered_requests"] += 1
                reroute(r, t)

        def kick(inst: int, t: float) -> None:
            if inst in self._crashed or not self.gs.instances[inst].alive:
                return
            if self._busy[inst]:
                return
            ls = self.locals[inst]
            if ls.depth == 0:
                return
            batch = ls.form_batch(t)
            if not batch.items:
                return
            self._busy[inst] = True
            dt = self._iter_time(inst, batch)
            if tel is not None:
                self._annotate_admission(inst, batch)
            heapq.heappush(events,
                           (t + dt, next(seq), "iter_done", (inst, batch)))

        def pump_prefetch(inst: int, t: float) -> None:
            """Schedule-time prefetch: reserve pages for waiting
            requests' host chains NOW and model each DMA landing after
            prefetch_time seconds — overlapping queue wait. Pumped at
            every arrival, iteration completion, and prefetch landing
            (the budget frees up), mirroring the engine's per-step
            issue loop. An inbound migrated span prefetches the same
            way: its DCN leg is folded into the pipeline's latency and
            no longer charged at admission."""
            if inst in self._crashed:
                return
            ls = self.locals[inst]
            for rec in ls.plan_prefetch(t):
                if (self.faults is not None
                        and self.faults.dma_fails("prefetch")):
                    # speculative DMA lost: refund the reservation;
                    # admission restores on the critical path instead
                    ls.cancel_prefetch(rec["id"], t)
                    continue
                mig, mig_rid = 0, None
                for q in ls.waiting:
                    if q.request_id not in rec["want"] or not q.migrated_len:
                        continue
                    # fold ONE wanting request's DCN leg into this
                    # record's latency — only for the part the record
                    # actually covers (the chain may have broken or
                    # hit budget before reaching the migrated span);
                    # only that request stops owing it at admission
                    cover = sum(
                        max(min(rec["hi"], b) - max(rec["lo"], a), 0)
                        for a, b in getattr(q, "_migrated_ranges", ()))
                    mig = min(q.migrated_len, cover)
                    if mig:
                        mig_rid = q.request_id
                        break
                dt = self.cm.prefetch_time(rec["reserved"] - mig, mig)
                heapq.heappush(events,
                               (t + dt, next(seq), "prefetch_done",
                                (inst, rec["id"], mig, mig_rid)))

        n_events = 0
        while events:
            n_events += 1
            if n_events > guard:
                raise RuntimeError("sim did not converge")
            now, _, kind, payload = heapq.heappop(events)
            self._now = now
            if self._pending_notify:
                due = [p for p in self._pending_notify if p[0] <= now]
                if due:
                    self._pending_notify = [p for p in self._pending_notify
                                            if p[0] > now]
                    for _, i, spans, dem, hdrop in due:
                        self.gs.on_evictions(i, spans, demoted=dem,
                                             host_dropped=hdrop)
            if kind == "arrival":
                r: Request = payload
                prefetch = None
                if tel is not None:
                    tel.trace(r, now)
                if cfg.policy == "rr":
                    alive = self.gs.alive_instances()
                    if not alive:
                        counters["failed_no_survivors"] += 1
                        terminal_fail(r, now, "no_survivors")
                        continue
                    inst = next(self._rr)
                    while inst not in alive:
                        inst = next(self._rr)
                    r.instance = inst
                    r.scheduled_time = now
                    if r.trace is not None:
                        r.trace.point("schedule", now, instance=inst,
                                      mode="rr")
                else:
                    if not self.gs.alive_instances():
                        counters["failed_no_survivors"] += 1
                        terminal_fail(r, now, "no_survivors")
                        continue
                    decision = self.gs.schedule(r, now)
                    inst = decision.instance
                    if decision.migration is not None:
                        self._execute_migration(r, inst,
                                                decision.migration, now)
                    prefetch = decision.prefetch
                    if r.trace is not None:
                        r.trace.point(
                            "schedule", now, instance=inst,
                            mode=decision.mode, cost=decision.cost,
                            cached=decision.cached_len,
                            missed=decision.missed_len,
                            migrated=r.migrated_len,
                            prefetch=prefetch is not None)
                # a SILENTLY crashed instance can still be chosen (the
                # detector hasn't fired): the request strands in its
                # queue until detection recovers it — exactly the
                # cluster runtime's behavior
                self.locals[inst].enqueue(r, now, prefetch=prefetch)
                # admission first, then plan prefetch for what still
                # waits — the engine's per-step order (issue after
                # _admit_new), so fresh records are never preempted by
                # the admissions of the same event
                kick(inst, now)
                pump_prefetch(inst, now)
            elif kind == "crash":
                inst = payload
                if inst in self._crashed:
                    continue
                self._crashed.add(inst)
                self.faults.record_crash(inst)
                if tel is not None:
                    tel.event("crash", now, instance=inst)
                self._busy[inst] = False
                if not detection:
                    recover(inst, now)      # oracle fallback
            elif kind == "tick":
                for i in self.locals:
                    if i in self._crashed \
                            or not self.gs.instances[i].alive:
                        continue
                    if self.faults is not None \
                            and self.faults.drop_heartbeat():
                        continue
                    self.gs.heartbeat(i, now)
                for i in self.gs.check_health(now):
                    recover(i, now)
                re_itv = self.gs.config.reconcile_every
                if re_itv > 0.0 and now - last_reconcile >= re_itv:
                    last_reconcile = now
                    self.reconcile_all(now)
                for i in self.locals:
                    kick(i, now)
                if len(finished) + len(failed) < n_total:
                    heapq.heappush(events,
                                   (now + tick_itv, next(seq), "tick",
                                    None))
            elif kind == "prefetch_done":
                inst, rec_id, mig, mig_rid = payload
                if inst in self._crashed:
                    continue            # the DMA died with the instance
                ls = self.locals[inst]
                done = ls.complete_prefetch(rec_id, now)
                if done["landed"] and mig:
                    # the DCN leg rode inside the prefetch pipeline:
                    # the one request it was charged to stops owing it
                    # at admission (approximation: whole-record landed;
                    # a request admitted mid-flight left `waiting` and
                    # keeps paying migrate_time at admission instead —
                    # the conservative side)
                    for q in ls.waiting:
                        if q.request_id == mig_rid:
                            q.migrated_len = max(q.migrated_len - mig, 0)
                kick(inst, now)
                pump_prefetch(inst, now)
            else:
                inst, batch = payload
                if inst in self._crashed:
                    continue            # the iteration died mid-wave
                self._busy[inst] = False
                for it in batch.items:
                    if it.phase == "decode":
                        self._ctx_sum[inst] += (it.request.prompt_len
                                                + len(it.request.output_tokens))
                        self._ctx_n[inst] += 1
                done = self.locals[inst].complete_iteration(batch, now)
                for r in done:
                    self.gs.on_request_complete(r, now)
                    if tel is not None:
                        tel.observe_request(r, now)
                    finished.append(r)
                kick(inst, now)
                if self.locals[inst].prefetch_enabled:
                    pump_prefetch(inst, now)

        stats = {f"gs_{k}": float(v) for k, v in self.gs.stats.items()}
        reused = sum(r.cached_len for r in finished)
        total_prompt = sum(r.prompt_len for r in finished)
        stats["cache_hit_frac"] = (reused / total_prompt
                                   if total_prompt else 0.0)
        # per-tier counters (hierarchical KV tiering): how much KV was
        # demoted instead of dropped, how much came back via restore,
        # and the fraction of all prompt tokens served from the host
        # tier — the ablation signal for offload-on vs -off runs.
        for key in ("demoted_tokens", "restored_tokens",
                    "host_dropped_tokens", "restore_hits",
                    "evicted_tokens", "migrated_in_tokens",
                    "migrated_out_tokens", "prefetch_issued",
                    "prefetch_landed", "prefetch_hit", "prefetch_wasted",
                    "prefetch_cancelled"):
            stats[key] = float(sum(ls.stats[key] for ls
                                   in self.locals.values()))
        stats["restore_hit_frac"] = (stats["restored_tokens"] / total_prompt
                                     if total_prompt else 0.0)
        # fraction of speculative DMA that actually came off a TTFT
        # path: issued tokens an admission later aliased. Cancelled
        # records deliberately stay in the denominator — speculation
        # that did not pay off is the signal. NOTE: the engine's stat
        # of the same name measures dispatch ordering (batches whose
        # drain saw a model dispatch after issue), not token payoff;
        # the two planes' fractions are not directly comparable.
        stats["prefetch_overlap_frac"] = (
            stats["prefetch_hit"] / stats["prefetch_issued"]
            if stats["prefetch_issued"] else 0.0)
        stats["prefetched_tokens"] = float(
            sum(r.prefetched_len for r in finished))
        stats["migrated_tokens"] = stats["migrated_in_tokens"]
        stats["migration_hit_frac"] = (
            stats["migrated_in_tokens"] / total_prompt
            if total_prompt else 0.0)
        stats["host_used_tokens"] = float(sum(
            ls.host_used_tokens for ls in self.locals.values()))
        if self.faults is not None:
            stats.update({k: float(v)
                          for k, v in self.fault_stats().items()})
            stats["failed"] = float(len(failed))
        return SimResult(finished, makespan=now, stats=stats,
                         failed=failed)


def simulate(requests: Sequence[Request], **kw) -> SimResult:
    return Simulator(SimConfig(**kw)).run(requests)
