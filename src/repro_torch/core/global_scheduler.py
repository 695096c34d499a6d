"""Preble global scheduler — request-level scheduling (paper §3.1/§3.2).

Maintains the global prefix forest, per-instance window loads, and applies
E2 plus the post-assignment mechanisms: load rebalancing (Th_bal) and
prefix autoscaling. Also implements the beyond-paper production concerns:
instance failure repair, elastic add/remove, straggler awareness, and a
PodRouter for >1-pod deployments (one global scheduler per pod, as the
paper itself prescribes for datacenter scale).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .cost_model import CostModel, cost_model_for
from .e2 import (InstanceState, MigrationPlan, PrefetchPlan,
                 ScheduleDecision, attach_migration, build_prefetch_plan,
                 e2_schedule, load_cost, plan_migration, subtree_load)
from .radix_tree import (MatchResult, PathKey, PrefixSpan, RadixNode,
                         RadixTree)
from .request import Request


@dataclass
class GlobalSchedulerConfig:
    window: float = 180.0            # history H (paper default: 3 minutes)
    th_bal: float = 2.0              # rebalance when max_load > th_bal * min_load
    imbal_ratio: float = 0.85        # ImbalR for PD balancing
    pd_min_load: float = 1.0         # PD balancing only above this load (s)
    autoscale_frac: float = 0.5      # subtree load > frac * H  => replicate
    capacity_tokens: int = 2_000_000 # per-instance KV capacity (tokens)
    host_capacity_tokens: int = 0    # per-instance host-offload tier (0=off)
    rebalance_every: float = 1.0     # seconds between rebalance scans
    autoscale_every: float = 5.0     # seconds between autoscale scans
    # Tier-to-tier prefix migration: price shipping a demoted host-tier
    # span to the chosen instance (migrate + restore) against
    # recomputing it, and attach the winning plan to the decision.
    enable_migration: bool = True
    # Failure detection (0 = oracle mode: failures only known when
    # reported explicitly). Engines heartbeat every step; an instance
    # silent for suspect_misses * heartbeat_interval turns SUSPECT
    # (soft-avoided by E2), for dead_misses * heartbeat_interval turns
    # DEAD (re-routed like an explicit failure).
    heartbeat_interval: float = 0.0
    suspect_misses: int = 3
    dead_misses: int = 10
    # Gauge anti-entropy period (0 = off): how often the runtime ships
    # per-instance residency digests through ``reconcile``.
    reconcile_every: float = 0.0


class GlobalScheduler:
    def __init__(self, num_instances: int = 0,
                 cost_model: Optional[CostModel] = None,
                 config: Optional[GlobalSchedulerConfig] = None):
        self.config = config or GlobalSchedulerConfig()
        self.cost_model = cost_model or cost_model_for()
        self.tree = RadixTree(window=self.config.window)
        self.instances: Dict[int, InstanceState] = {}
        self._redirects: Dict[int, int] = {}          # heavy -> light
        self._hot_nodes: Dict[int, int] = {}          # node_id -> replica target
        self._last_rebalance = 0.0
        self._last_autoscale = 0.0
        self.decisions: List[ScheduleDecision] = []
        self.stats = {"exploit": 0, "explore": 0, "pd_balance": 0,
                      "rebalance": 0, "autoscale": 0, "scheduled": 0,
                      "failures": 0, "migrations_planned": 0,
                      "migrated_tokens": 0, "suspected": 0,
                      "detected_dead": 0, "reconciles": 0,
                      "reconcile_repairs": 0}
        for i in range(num_instances):
            self.add_instance(i)

    # ---- elastic membership --------------------------------------------------

    def add_instance(self, instance_id: int,
                     capacity_tokens: Optional[int] = None,
                     speed_factor: float = 1.0,
                     host_capacity_tokens: Optional[int] = None,
                     now: float = 0.0,
                     cost_model: Optional[CostModel] = None) -> None:
        """``cost_model`` overrides the scheduler-wide default for this
        instance — heterogeneous clusters (mesh-of-meshes, DESIGN.md
        §13) register each submesh with a cost model derived for its
        own TP degree, so E2 prices a 4-chip instance's prefill/decode
        against its aggregate compute/HBM."""
        self.instances[instance_id] = InstanceState(
            instance_id=instance_id,
            capacity_tokens=capacity_tokens or self.config.capacity_tokens,
            cost_model=cost_model or self.cost_model,
            window=self.config.window,
            speed_factor=speed_factor,
            host_capacity_tokens=(
                self.config.host_capacity_tokens
                if host_capacity_tokens is None else host_capacity_tokens),
            registered_at=now,
        )

    def remove_instance(self, instance_id: int, now: float = 0.0) -> None:
        """Graceful drain: stop routing to it; its cache entries are
        dropped, and nodes left dead by the drop are pruned here (the
        scoped per-chain pruning in on_evictions never revisits them)."""
        inst = self.instances.get(instance_id)
        if inst is None:
            return
        inst.alive = False
        inst.health = "dead"
        self.tree.drop_instance_everywhere(instance_id)
        self.tree.prune_dead(now)
        self._redirects.pop(instance_id, None)
        self._redirects = {h: l for h, l in self._redirects.items()
                           if l != instance_id}

    def on_instance_failure(self, instance_id: int, now: float = 0.0) -> None:
        """Hard failure: identical tree repair, counted for observability.
        The cluster runtime re-enqueues that instance's in-flight requests
        through ``schedule`` again (their prefixes now resolve elsewhere)."""
        self.stats["failures"] += 1
        self.remove_instance(instance_id, now)

    def set_speed_factor(self, instance_id: int, factor: float) -> None:
        """Straggler mitigation hook: runtime reports observed slowdown
        (measured iteration time / expected); E2 then sees inflated costs
        for this instance and organically sheds load from it."""
        if instance_id in self.instances:
            self.instances[instance_id].speed_factor = max(factor, 1e-3)

    def alive_instances(self) -> List[int]:
        return [i for i, s in self.instances.items() if s.alive]

    # ---- failure detection (DESIGN.md §11) ------------------------------------

    def heartbeat(self, instance_id: int, now: float) -> None:
        """Per-step liveness beacon from an engine. A heartbeat from a
        SUSPECT instance revives it to ALIVE (slow or lossy, not dead)."""
        inst = self.instances.get(instance_id)
        if inst is None or not inst.alive:
            return
        inst.last_heartbeat = now
        if inst.health == "suspect":
            inst.health = "alive"

    def check_health(self, now: float) -> List[int]:
        """ALIVE -> SUSPECT -> DEAD state machine over heartbeat gaps.
        An instance that never heartbeated is judged from its
        registration time (so a crash before the first beat is still
        detected). Returns instances newly declared DEAD this call —
        the runtime recovers their in-flight requests. No-op unless
        heartbeat_interval > 0 (oracle mode stays byte-identical)."""
        itv = self.config.heartbeat_interval
        if itv <= 0.0:
            return []
        newly_dead: List[int] = []
        for i, inst in list(self.instances.items()):
            if not inst.alive:
                continue
            base = (inst.last_heartbeat if inst.last_heartbeat >= 0.0
                    else inst.registered_at)
            gap = now - base
            if gap >= self.config.dead_misses * itv:
                self.stats["detected_dead"] += 1
                self.on_instance_failure(i, now)   # sets health="dead"
                newly_dead.append(i)
            elif (gap >= self.config.suspect_misses * itv
                  and inst.health == "alive"):
                inst.health = "suspect"
                self.stats["suspected"] += 1
        return newly_dead

    # ---- gauge anti-entropy (DESIGN.md §11) -----------------------------------

    def reconcile(self, instance_id: int,
                  digest: Dict[str, Sequence[Tuple["PathKey", int]]],
                  now: float = 0.0) -> int:
        """Repair this instance's view of the forest from a path-keyed
        residency digest — the instance's TRUE device/host markings as
        ``(path_key, length)`` spans (LocalScheduler.residency_digest).
        Once eviction notifications can drop, the global markings and
        cached-token gauges drift; this is the anti-entropy half that
        re-converges them. Spans are content-addressed, so they resolve
        across tree-split granularity via ``resolve_span`` exactly like
        protocol-v2 notifications; the gauges are set to the digest
        totals verbatim (exact even for unresolvable spans). Returns
        the number of repaired markings/gauges."""
        inst = self.instances.get(instance_id)
        if inst is None or not inst.alive:
            return 0
        self.stats["reconciles"] += 1
        cover: Dict[str, Dict[int, RadixNode]] = {"device": {}, "host": {}}
        for tier in ("device", "host"):
            for key, toks in digest.get(tier, ()):
                for node in self.tree.resolve_span(PrefixSpan(key, toks)):
                    cover[tier][node.node_id] = node
        repairs = 0
        touched: List[RadixNode] = []
        for node in self.tree.iter_nodes():
            if (instance_id in node.instances
                    and node.node_id not in cover["device"]):
                self.tree.remove_instance(node, instance_id)
                repairs += 1
                touched.append(node)
            if (instance_id in node.host_instances
                    and node.node_id not in cover["host"]):
                node.host_instances.discard(instance_id)
                repairs += 1
                touched.append(node)
        for node in cover["device"].values():
            if instance_id not in node.instances:
                node.instances.add(instance_id)
                repairs += 1
        for node in cover["host"].values():
            if instance_id not in node.host_instances:
                node.host_instances.add(instance_id)
                repairs += 1
        # gauges + aged marks rebuilt from the digest verbatim
        dev_total = sum(t for _, t in digest.get("device", ()))
        host_total = sum(t for _, t in digest.get("host", ()))
        if inst.cached_tokens != dev_total:
            inst.cached_tokens = dev_total
            repairs += 1
        if inst.host_cached_tokens != host_total:
            inst.host_cached_tokens = host_total
            repairs += 1
        inst.device_marks = OrderedDict()
        inst.host_marks = OrderedDict()
        inst.device_marked_sum = 0
        inst.host_marked_sum = 0
        for key, toks in digest.get("device", ()):
            inst.mark_device(key, toks, now)
        for key, toks in digest.get("host", ()):
            inst.mark_host(key, toks, now)
        for node in touched:
            self.tree.prune_upward(node, now)
        self.stats["reconcile_repairs"] += repairs
        return repairs

    # ---- the scheduling entry point -------------------------------------------

    def schedule(self, request: Request, now: float) -> ScheduleDecision:
        cfg = self.config
        match = self.tree.match(request.tokens, now=now, update_stats=True)
        decision = e2_schedule(self.instances, self.tree, match,
                               request.prompt_len, now,
                               imbal_ratio=cfg.imbal_ratio,
                               pd_min_load=cfg.pd_min_load,
                               enable_migration=cfg.enable_migration)

        # Post-assignment adjustment 1 — load rebalancing: redirect exploit
        # traffic from a flagged-heavy instance to its light partner. The
        # redirect target gets its own migration plan: this is exactly
        # the rebalance-under-load case where pulling the demoted span
        # beats recomputing it on the light instance.
        if decision.mode == "exploit":
            tgt = self._redirects.get(decision.instance)
            if tgt is not None and self.instances[tgt].alive:
                mig = self._maybe_migration(match, tgt,
                                            request.prompt_len, now)
                decision = ScheduleDecision(
                    tgt, "rebalance", decision.cached_len,
                    decision.missed_len, migration=mig,
                    prefetch=build_prefetch_plan(
                        self.instances[tgt], match, request.prompt_len,
                        migration=mig))
        # Post-assignment adjustment 2 — autoscaling: a hot prefix seeds a
        # replica on its designated target; once cached both copies are
        # load-balanced by plain E2 exploit. Seeding too prefers pulling
        # the span over recomputing it when a host copy exists anywhere.
        # Autoscale seeding rides the §9 migrate + §10 prefetch path:
        # the replica's first redirected hit pulls the hot span from a
        # host tier (one DCN ship + one restore, prefetched while the
        # request queues) instead of recomputing the whole prefill.
        if decision.mode == "exploit" and match.path:
            for node in match.path:
                tgt = self._hot_nodes.pop(node.node_id, None)
                if tgt is not None and self.instances[tgt].alive \
                        and tgt != decision.instance:
                    mig = self._maybe_migration(match, tgt,
                                                request.prompt_len, now)
                    decision = ScheduleDecision(
                        tgt, "autoscale", decision.cached_len,
                        decision.missed_len, migration=mig,
                        prefetch=build_prefetch_plan(
                            self.instances[tgt], match,
                            request.prompt_len, migration=mig))
                    break

        self._commit(request, decision, match, now)

        # periodic background work (runs inline here; the real deployment
        # runs it on a separate thread — both are control-plane-cheap)
        if now - self._last_rebalance >= cfg.rebalance_every:
            self.rebalance(now)
        if now - self._last_autoscale >= cfg.autoscale_every:
            self.maybe_autoscale(now)
        return decision

    def _maybe_migration(self, match: MatchResult, inst_id: int,
                         prompt_len: int, now: float
                         ) -> Optional[MigrationPlan]:
        """Migration plan for a post-assignment target (rebalance /
        autoscale redirect), attached only when it beats recompute."""
        if not self.config.enable_migration:
            return None
        plan = plan_migration(self.tree, match, inst_id, self.instances,
                              prompt_len, now)
        return attach_migration(self.instances[inst_id], match, plan,
                                prompt_len)

    def _commit(self, request: Request, decision: ScheduleDecision,
                match: MatchResult, now: float) -> None:
        inst = self.instances[decision.instance]
        inst_cached = match.per_instance_len.get(decision.instance, 0)
        inst_host = match.per_instance_host_len.get(decision.instance, 0)
        missed = max(request.prompt_len - inst_cached - inst_host, 0)

        # Insert/extend prompt path; mark the chosen instance on every node.
        path = self.tree.insert(request.tokens, instance=decision.instance,
                                now=now)
        # Path-keyed mark confirmation (Alg. 2 aging): every serve
        # re-stamps the path's markings, so device_pressure_est only
        # counts spans confirmed within window H.
        for node in path:
            inst.mark_device(node.path_key, len(node.tokens), now)

        # window-H load accounting (Alg. 2's L term source). Host-tier
        # hits charge the restore DMA, not a recompute (folded into the
        # prefill-phase term: both occupy the instance's prefill lane).
        # A planned migration converts part of the missed prefill into
        # migrate + restore work — the same arbitration load_cost priced.
        cm = inst.cost_model
        est_out = inst.avg_output_len(now, default=float(request.max_new_tokens))
        mig = min(decision.migration.tokens, missed) \
            if decision.migration is not None else 0
        prefill_work = (cm.prefill_time(missed - mig)
                        + cm.restore_time(inst_host + mig)
                        + cm.migrate_time(mig))
        if mig:
            self.stats["migrations_planned"] += 1
        inst.add_work(now, prefill_work, cm.decode_time(est_out))
        # Gauge is UNCLAMPED on write: eviction notifications subtract
        # full node lengths, so clamping additions here would make the
        # gauge understate long-lived instances (drift); readers clamp
        # through InstanceState.device_cached_est(). Missed AND restored
        # tokens re-occupy device. The HOST gauge is untouched here: a
        # restore keeps the host entry resident (the copy stays valid);
        # it only falls when the entry is host-dropped (on_evictions),
        # mirroring the host_instances marking exactly.
        inst.cached_tokens += missed + inst_host
        inst.inflight += 1

        request.instance = decision.instance
        request.cached_len = inst_cached
        request.scheduled_time = now

        self.stats[decision.mode] += 1
        self.stats["scheduled"] += 1

    # ---- runtime feedback ------------------------------------------------------

    def on_request_complete(self, request: Request, now: float) -> None:
        inst = self.instances.get(request.instance)
        if inst is None:
            return
        inst.inflight = max(inst.inflight - 1, 0)
        inst.observe_output_len(now, len(request.output_tokens)
                                or request.max_new_tokens)

    def on_evictions(self, instance_id: int, evicted: Sequence[PrefixSpan],
                     now: float = 0.0, *,
                     demoted: Sequence[PrefixSpan] = (),
                     host_dropped: Sequence[PrefixSpan] = ()) -> None:
        """Async eviction notification from a local scheduler (§3.3) —
        protocol v2 (DESIGN.md §9): every span is CONTENT-ADDRESSED
        (path key of its end boundary + token length), so the sender's
        node ids never appear on the wire and the forest resolves each
        span to its OWN node chain via the path-key index, regardless of
        how either tree split its nodes. Resolution + dead-node cleanup
        stay scoped to the touched chains — this path runs once per
        local eviction batch and must not walk the whole forest.

        Tiered protocol: ``demoted`` (a subset of ``evicted``) left the
        device but live on in the instance's host tier — their chains
        are marked host-resident (keeping their hit history: the prefix
        is still exploitable at restore cost) instead of removed.
        ``host_dropped`` fell out of the host tier too and are truly
        gone. Unresolvable spans (pruned here, or ambiguous under a
        digest collision) degrade to a no-op."""
        dem_keys = {s.key for s in demoted}
        hdrop_keys = {s.key for s in host_dropped}
        inst = self.instances.get(instance_id)
        freed = 0
        demoted_toks = 0
        for span in evicted:
            for node in self.tree.resolve_span(span):
                if instance_id not in node.instances:
                    continue
                freed += len(node.tokens)
                if inst is not None:
                    inst.unmark_device(node.path_key)
                if span.key in dem_keys:
                    node.instances.discard(instance_id)
                    # the host gauge follows the host_instances marking
                    # exactly (guarded add here / discard below), so a
                    # restore->re-demote cycle — where the entry stayed
                    # resident throughout — cannot double-count
                    if instance_id not in node.host_instances:
                        node.host_instances.add(instance_id)
                        demoted_toks += len(node.tokens)
                    if inst is not None:
                        inst.mark_host(node.path_key, len(node.tokens),
                                       now)
                else:
                    self.tree.remove_instance(node, instance_id)
        host_freed = 0
        for span in host_dropped:
            for node in self.tree.resolve_span(span):
                if instance_id in node.host_instances:
                    node.host_instances.discard(instance_id)
                    host_freed += len(node.tokens)
                if inst is not None:
                    inst.unmark_host(node.path_key)
        if inst is not None:
            inst.cached_tokens = max(inst.cached_tokens - freed, 0)
            inst.host_cached_tokens = max(
                inst.host_cached_tokens + demoted_toks - host_freed, 0)
        for span in list(evicted) + list(host_dropped):
            if span.key in dem_keys and span.key not in hdrop_keys:
                continue             # demoted spans are live, never pruned
            node = self.tree.node_by_key(span.key)  # None if pruned/collided
            if node is not None:
                self.tree.prune_upward(node, now)

    def on_migration(self, src: int, dst: int, tokens: Sequence[int],
                     ranges: Sequence[Tuple[int, int]], now: float = 0.0,
                     *, move: bool = False) -> None:
        """Runtime feedback after a tier-to-tier migration executed:
        token ranges [lo, hi) of ``tokens`` now sit in ``dst``'s host
        tier. Marks the covered forest nodes host-resident on dst (and,
        for a move — drain — removes the src marking) and keeps both
        host gauges in line with the markings. Ranges are node-aligned
        (the exporter ships whole-node pieces), so every forest node
        inside a range is fully covered."""
        if not ranges:
            return
        dst_inst = self.instances.get(dst)
        src_inst = self.instances.get(src)
        m = self.tree.match(tokens, now=now)
        moved = 0
        boundary = 0
        for node in m.path:
            start, end = boundary, boundary + len(node.tokens)
            boundary = end
            if not any(lo <= start and end <= hi for lo, hi in ranges):
                continue
            if dst_inst is not None and dst not in node.host_instances:
                node.host_instances.add(dst)
                dst_inst.host_cached_tokens += len(node.tokens)
                dst_inst.mark_host(node.path_key, len(node.tokens), now)
                moved += len(node.tokens)
            if move and src in node.host_instances:
                node.host_instances.discard(src)
                if src_inst is not None:
                    src_inst.host_cached_tokens = max(
                        src_inst.host_cached_tokens - len(node.tokens), 0)
                    src_inst.unmark_host(node.path_key)
        self.stats["migrated_tokens"] += moved

    # ---- post-assignment load management ----------------------------------------

    def rebalance(self, now: float) -> Optional[Tuple[int, int]]:
        self._last_rebalance = now
        alive = {i: s for i, s in self.instances.items() if s.alive}
        if len(alive) < 2:
            self._redirects.clear()
            return None
        loads = {i: s.window_load(now) for i, s in alive.items()}
        heavy = max(loads, key=loads.get)
        light = min(loads, key=loads.get)
        if loads[light] <= 0 and loads[heavy] <= 0:
            self._redirects.clear()
            return None
        if loads[heavy] > self.config.th_bal * max(loads[light], 1e-9):
            self._redirects = {heavy: light}
            return (heavy, light)
        self._redirects.clear()
        return None

    def maybe_autoscale(self, now: float) -> List[int]:
        """Replicate prefixes whose subtree load exceeds what one instance
        should absorb (paper: queueing doubling over H; we use the subtree
        windowed-work fraction, same signal expressed in seconds)."""
        self._last_autoscale = now
        alive = {i: s for i, s in self.instances.items() if s.alive}
        if len(alive) < 2:
            return []
        threshold = self.config.autoscale_frac * self.config.window
        scaled: List[int] = []
        loads = {i: s.window_load(now) for i, s in alive.items()}
        for node in self.tree.iter_nodes():
            # host-resident-only subtrees qualify too: a hot prefix that
            # thrash-demoted everywhere still deserves a replica — and
            # its first redirected hit seeds through the §9 migrate +
            # §10 prefetch path (one DCN ship + restore, no recompute)
            holders = node.instances | node.host_instances
            if not holders or len(holders) >= len(alive):
                continue
            sload = subtree_load(self.tree, node, self.cost_model, now)
            if sload <= threshold:
                continue
            candidates = [i for i in alive if i not in holders]
            if not candidates:
                continue
            target = min(candidates, key=lambda i: loads[i])
            self._hot_nodes[node.node_id] = target
            scaled.append(node.node_id)
        return scaled

    # ---- introspection -----------------------------------------------------------

    def loads(self, now: float) -> Dict[int, float]:
        return {i: s.window_load(now) for i, s in self.instances.items()
                if s.alive}


class PodRouter:
    """Datacenter-scale front tier: one GlobalScheduler per pod (paper
    §3.1: 'one can deploy several Preble clusters, each having one global
    scheduler'). Routes each request to a pod by prefix-affinity digest
    (first-k-token hash, so requests sharing a prefix head land on the
    same pod's scheduler) with load-based fallback & failover."""

    def __init__(self, pods: Dict[int, GlobalScheduler],
                 head_tokens: int = 64, spill_ratio: float = 2.0,
                 spill_min_load: float = 1.0,
                 affinity_cap: int = 65536):
        self.pods = pods
        self.head_tokens = head_tokens
        self.spill_ratio = spill_ratio
        # absolute seconds of load before spilling can trigger: without
        # this, any nonzero load "exceeds 2x" an idle pod and affinity
        # degenerates to round-robin (caught by test_pod_router)
        self.spill_min_load = spill_min_load
        # BOUNDED prefix-affinity map: unique-prefix traffic would grow
        # an unbounded dict (one digest per distinct head); LRU-capped,
        # a dropped digest just re-resolves by load next time.
        self.affinity_cap = affinity_cap
        self._affinity: "OrderedDict[str, int]" = OrderedDict()

    def _remember(self, key: str, pid: int) -> None:
        self._affinity[key] = pid
        self._affinity.move_to_end(key)
        while len(self._affinity) > self.affinity_cap:
            self._affinity.popitem(last=False)

    def _digest(self, tokens: Sequence[int]) -> str:
        head = bytes(str(list(tokens[: self.head_tokens])), "utf-8")
        return hashlib.blake2b(head, digest_size=8).hexdigest()

    def _healthy(self) -> Dict[int, GlobalScheduler]:
        return {p: s for p, s in self.pods.items() if s.alive_instances()}

    def pod_loads(self, now: float) -> Dict[int, float]:
        out = {}
        for pid, sched in self._healthy().items():
            l = sched.loads(now)
            out[pid] = (sum(l.values()) / max(len(l), 1)) if l else 0.0
        return out

    def route(self, request: Request, now: float) -> Tuple[int, ScheduleDecision]:
        key = self._digest(request.tokens)
        loads = self.pod_loads(now)     # healthy pods only
        if not loads:
            raise RuntimeError("no healthy pods")
        pid = self._affinity.get(key)
        if pid is None or pid not in loads:
            pid = min(loads, key=loads.get)
        else:
            lightest = min(loads, key=loads.get)
            if (lightest != pid
                    and loads[pid] > self.spill_min_load
                    and loads[pid] > self.spill_ratio * loads[lightest]):
                pid = lightest
        self._remember(key, pid)
        return pid, self.pods[pid].schedule(request, now)
