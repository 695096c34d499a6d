"""E2 (Exploitation + Exploration) — Preble Algorithms 1 & 2.

Pure-algorithm module: stateless functions over the global scheduler's
view of the world.  ``GlobalScheduler`` wires these to live state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .cost_model import CostModel
from .radix_tree import (MatchResult, PathKey, PrefixSpan, RadixNode,
                         RadixTree)


@dataclass
class InstanceState:
    """Global scheduler's per-instance bookkeeping (one model instance =
    one data-parallel slice; possibly multiple chips under TP)."""

    instance_id: int
    capacity_tokens: int                  # KV/state cache capacity in tokens
    cost_model: CostModel
    window: float = 180.0                 # history H (seconds)
    speed_factor: float = 1.0             # >1 == straggler (runs slower)
    alive: bool = True
    # host-offload tier capacity (0 = tier disabled): evictions on this
    # instance demote KV to host memory instead of dropping it, so its
    # eviction cost M is a restore, not a recompute.
    host_capacity_tokens: int = 0
    # failure-detector state machine: "alive" -> "suspect" -> "dead".
    # SUSPECT is soft-avoided in load_cost; only DEAD re-routes.
    health: str = "alive"
    last_heartbeat: float = -1.0          # -1 = never heard from
    registered_at: float = 0.0            # detection baseline pre-heartbeat

    # window-H event log: (time, prefill_sec, decode_sec)
    events: deque = field(default_factory=deque)
    prefill_sec_sum: float = 0.0
    decode_sec_sum: float = 0.0
    request_times: deque = field(default_factory=deque)  # assignment times
    inflight: int = 0
    # Tracked estimate of device cache use. Kept UNCLAMPED: additions
    # accrue in full and eviction notifications subtract full node
    # lengths, so clamping on write would understate long-lived
    # instances (gauge drift). Readers clamp via device_cached_est().
    cached_tokens: int = 0
    host_cached_tokens: int = 0           # tracked estimate of host-tier use
    # running average of observed output lengths (paper: avg output len in H)
    out_len_events: deque = field(default_factory=deque)  # (time, out_len)
    out_len_sum: float = 0.0
    # Path-keyed aged markings (Alg. 2's M term): every span this
    # instance was marked as caching, keyed by content with the time of
    # its last confirmation (a _commit mark or a v2 notification move).
    # OrderedDicts stay time-sorted because re-marking moves to the
    # end, so aging trims from the front in O(1) amortized. A marking
    # not re-confirmed within window H is presumed gone (local LRU
    # would have cycled it under any pressure), so the eviction-
    # pressure estimate converges after storms instead of trusting the
    # clamped full-capacity gauge forever. Stale keys left behind by
    # global-tree splits simply age out — the estimate self-heals.
    device_marks: "OrderedDict[PathKey, Tuple[float, int]]" = field(
        default_factory=OrderedDict)
    host_marks: "OrderedDict[PathKey, Tuple[float, int]]" = field(
        default_factory=OrderedDict)
    device_marked_sum: int = 0
    host_marked_sum: int = 0
    _marks_seen: bool = False

    def device_cached_est(self) -> int:
        """Clamped read of the device-cache gauge: occupancy can never
        physically exceed capacity, but the raw gauge must keep the
        overshoot so later evictions subtract from the right base."""
        return min(self.cached_tokens, self.capacity_tokens)

    # ---- path-keyed mark aging ----------------------------------------------

    def mark_device(self, key: PathKey, length: int, now: float) -> None:
        prev = self.device_marks.pop(key, None)
        if prev is not None:
            self.device_marked_sum -= prev[1]
        self.device_marks[key] = (now, length)
        self.device_marked_sum += length
        self._marks_seen = True

    def unmark_device(self, key: PathKey) -> int:
        prev = self.device_marks.pop(key, None)
        if prev is None:
            return 0
        self.device_marked_sum -= prev[1]
        return prev[1]

    def mark_host(self, key: PathKey, length: int, now: float) -> None:
        prev = self.host_marks.pop(key, None)
        if prev is not None:
            self.host_marked_sum -= prev[1]
        self.host_marks[key] = (now, length)
        self.host_marked_sum += length
        self._marks_seen = True

    def unmark_host(self, key: PathKey) -> int:
        prev = self.host_marks.pop(key, None)
        if prev is None:
            return 0
        self.host_marked_sum -= prev[1]
        return prev[1]

    def _age_marks(self, now: float) -> None:
        cutoff = now - self.window
        for od in (self.device_marks, self.host_marks):
            dead: List[PathKey] = []
            for key, (t, _) in od.items():
                if t >= cutoff:
                    break
                dead.append(key)
            for key in dead:
                _, length = od.pop(key)
                if od is self.device_marks:
                    self.device_marked_sum -= length
                else:
                    self.host_marked_sum -= length

    def device_pressure_est(self, now: float) -> int:
        """Device occupancy for Alg. 2's M term: the clamped gauge,
        further bounded by the window-H aged sum of path-keyed
        markings. Instances that never reported marks (tests driving
        InstanceState directly) fall back to the raw gauge."""
        if not self._marks_seen:
            return self.device_cached_est()
        self._age_marks(now)
        return min(self.device_cached_est(), self.device_marked_sum)

    def host_pressure_est(self, now: float) -> int:
        """Host-tier occupancy estimate, aged the same way."""
        base = min(self.host_cached_tokens, self.host_capacity_tokens)
        if not self._marks_seen:
            return base
        self._age_marks(now)
        return min(base, self.host_marked_sum)

    # ---- window maintenance --------------------------------------------------

    def _trim(self, now: float) -> None:
        cutoff = now - self.window
        ev = self.events
        while ev and ev[0][0] < cutoff:
            _, p, d = ev.popleft()
            self.prefill_sec_sum -= p
            self.decode_sec_sum -= d
        rt = self.request_times
        while rt and rt[0] < cutoff:
            rt.popleft()
        ol = self.out_len_events
        while ol and ol[0][0] < cutoff:
            self.out_len_sum -= ol.popleft()[1]

    def add_work(self, now: float, prefill_sec: float, decode_sec: float) -> None:
        self.events.append((now, prefill_sec, decode_sec))
        self.prefill_sec_sum += prefill_sec
        self.decode_sec_sum += decode_sec
        self.request_times.append(now)
        self._trim(now)

    def observe_output_len(self, now: float, out_len: int) -> None:
        self.out_len_events.append((now, out_len))
        self.out_len_sum += out_len
        self._trim(now)

    def avg_output_len(self, now: float, default: float = 32.0) -> float:
        self._trim(now)
        n = len(self.out_len_events)
        return (self.out_len_sum / n) if n else default

    def requests_in_window(self, now: float) -> int:
        self._trim(now)
        return len(self.request_times)

    def window_load(self, now: float) -> float:
        """L_i in Algorithm 2: total windowed compute seconds, scaled by the
        straggler speed factor (a 2x-slow instance carries 2x the time)."""
        self._trim(now)
        return (self.prefill_sec_sum + self.decode_sec_sum) * self.speed_factor

    def decode_ratio(self, now: float) -> float:
        """Fraction of windowed compute that is decode-phase (PD balancing)."""
        self._trim(now)
        total = self.prefill_sec_sum + self.decode_sec_sum
        return (self.decode_sec_sum / total) if total > 0 else 0.0


@dataclass(frozen=True)
class MigrationPlan:
    """Tier-to-tier prefix migration rider on a schedule decision: ship
    the demoted host-tier span tokens[lo:hi] of the request's prompt
    from ``src``'s host tier to the chosen instance's host tier, where
    the normal §8 restore path materializes it on device — priced at
    migrate_time + restore_time against recomputing the prefill."""
    src: int
    lo: int                         # token range [lo, hi) of the prompt
    hi: int

    @property
    def tokens(self) -> int:
        return self.hi - self.lo


@dataclass(frozen=True)
class PrefetchPlan:
    """Speculative-restore rider on a schedule decision (DESIGN.md
    §10): E2 already knows at decision time that this request will
    restore host-tier spans (or receive a migrated span) on its target
    instance, so it names the prefetch set — path-keyed, hence portable
    and resolvable by the target's local tree — and prices the DMA the
    pipeline can hide behind queue wait. Advisory: the LocalScheduler
    re-derives the authoritative span set from its own tree when it
    actually reserves pages (the global view may be stale)."""
    spans: Tuple[PrefixSpan, ...]   # host spans in chain order from the
                                    # target's device boundary
    tokens: int                     # total prefetchable tokens
    restore_time: float             # priced host->device DMA (seconds)
    migrate_tokens: int = 0         # ... of tokens arriving via the
                                    # migration rider (inbound DCN leg)
    migrate_time: float = 0.0


@dataclass
class ScheduleDecision:
    instance: int
    mode: str                       # "exploit" | "explore" | "pd_balance" | "rebalance" | "autoscale"
    cached_len: int
    missed_len: int
    cost: float = 0.0
    candidates: Dict[int, float] = field(default_factory=dict)
    # set when the cheapest way to serve on ``instance`` includes
    # pulling a remote host-tier span (the runtime executes it)
    migration: Optional[MigrationPlan] = None
    # set when the target holds restorable host spans (or receives a
    # migrated one): the local scheduler's prefetch queue can start the
    # host->device DMA while the request waits (DESIGN.md §10)
    prefetch: Optional[PrefetchPlan] = None


# ---------------------------------------------------------------------------
# Algorithm 2: LOADCOST(i, R_k)
# ---------------------------------------------------------------------------

# SUSPECT soft-avoid (DESIGN.md §11): multiplicative penalty plus a
# constant bias applied to a suspect instance's load cost. Soft — a
# suspect with a much longer cached prefix can still win — but strong
# enough that near-tied candidates route around it.
SUSPECT_COST_FACTOR = 4.0
SUSPECT_COST_BIAS = 0.5

def _phase_cost(cm: CostModel, missed: int, inst_host: int,
                mig_tokens: int) -> Tuple[float, bool]:
    """Prefill-phase cost of serving (missed, host-restorable) tokens,
    optionally pulling ``mig_tokens`` of them from another instance's
    host tier instead of recomputing: P = prefill(missed - m) +
    restore(host + m) + migrate(m) when that beats plain
    prefill(missed) + restore(host). Returns (cost, used_migration)."""
    base = cm.prefill_time(missed) + cm.restore_time(inst_host)
    if mig_tokens <= 0 or missed <= 0:
        return base, False
    m = min(mig_tokens, missed)
    alt = (cm.prefill_time(missed - m) + cm.restore_time(inst_host + m)
           + cm.migrate_time(m))
    return (alt, True) if alt < base else (base, False)


def coverage_boundary(match: MatchResult, inst_id: int) -> int:
    """Contiguous node-aligned prefix ``inst_id`` can reuse without any
    cross-instance transfer: device-cached nodes, then host-demoted
    nodes extending them (the §8 restore-chain shape)."""
    b = 0
    phase = "device"
    for node in match.path:
        if phase == "device" and inst_id in node.instances:
            b += len(node.tokens)
            continue
        phase = "host"
        if inst_id in node.host_instances:
            b += len(node.tokens)
        else:
            break
    return b


def plan_migration(tree: RadixTree, match: MatchResult, inst_id: int,
                   instances: Dict[int, InstanceState], prompt_len: int,
                   now: float) -> Optional[MigrationPlan]:
    """Best tier-to-tier migration candidate for serving this request on
    ``inst_id``: the longest chain of matched nodes that contiguously
    extends inst_id's own reusable prefix AND is host-resident on one
    other alive instance. Whole nodes only — span boundaries stay
    node-aligned in every tree (split boundaries only refine), so the
    shipped entries land restorable on the target. Returns None when
    nothing is migratable or either side lacks a host tier."""
    inst = instances.get(inst_id)
    if inst is None or inst.host_capacity_tokens <= 0:
        return None
    lo = coverage_boundary(match, inst_id)
    limit = prompt_len - 1           # reuse cap: last token always runs
    if lo >= limit or not match.path:
        return None
    rest: List[Tuple[int, RadixNode]] = []
    b = 0
    for node in match.path:
        if b >= lo:
            rest.append((b, node))
        b += len(node.tokens)
    if not rest:
        return None
    best_src, best_hi = None, lo
    for j in sorted(rest[0][1].host_instances):
        s = instances.get(j)
        if (j == inst_id or s is None or not s.alive
                or s.host_capacity_tokens <= 0):
            continue
        hi = lo
        for start, node in rest:
            if start != hi or j not in node.host_instances:
                break
            if start + len(node.tokens) > limit:
                break
            if inst_id in node.host_instances:
                # the target already holds this span (non-contiguously)
                # in its own tier: its entry bridges the restore chain
                # for free — shipping it would double-price the restore
                # and move bytes ingest discards as already-resident
                break
            hi = start + len(node.tokens)
        if hi > best_hi:
            best_src, best_hi = j, hi
    if best_src is None:
        return None
    return MigrationPlan(best_src, lo, best_hi)


def attach_migration(inst: InstanceState, match: MatchResult,
                     plan: Optional[MigrationPlan], prompt_len: int
                     ) -> Optional[MigrationPlan]:
    """``plan``, but only when migration actually undercuts recomputing
    the span on ``inst`` — the single arbitration both the E2 candidate
    loop and the post-assignment redirect paths use (keeping the
    pricing from diverging between them)."""
    if plan is None:
        return None
    inst_cached = match.per_instance_len.get(inst.instance_id, 0)
    inst_host = match.per_instance_host_len.get(inst.instance_id, 0)
    missed = max(prompt_len - inst_cached - inst_host, 0)
    _, used = _phase_cost(inst.cost_model, missed, inst_host, plan.tokens)
    return plan if used else None


def build_prefetch_plan(inst: InstanceState, match: MatchResult,
                        prompt_len: int,
                        migration: Optional[MigrationPlan] = None
                        ) -> Optional[PrefetchPlan]:
    """Name the restore set E2 just priced for ``inst``: whole matched
    nodes the instance holds only in its host tier, contiguously
    extending its device coverage (the §8 restore-chain shape), plus —
    when a migration rider is attached — the inbound span, which will
    be host-resident on the target by the time the request queues.
    Whole nodes only (span boundaries stay node-aligned in every tree),
    capped at prompt_len - 1 like every reuse path. Returns None when
    there is nothing to prefetch."""
    inst_id = inst.instance_id
    limit = prompt_len - 1
    spans: List[PrefixSpan] = []
    host_tokens = 0
    mig_tokens = 0
    b = 0
    phase = "device"
    mig_lo = migration.lo if migration is not None else None
    mig_hi = migration.hi if migration is not None else None
    for node in match.path:
        start = b
        b += len(node.tokens)
        if phase == "device" and inst_id in node.instances:
            continue
        phase = "host"
        if b > limit:
            break
        if inst_id in node.host_instances:
            spans.append(node.span())
            host_tokens += len(node.tokens)
        elif (mig_lo is not None and mig_lo <= start
              and b <= mig_hi):
            spans.append(node.span())
            mig_tokens += len(node.tokens)
        else:
            break
    if not spans:
        return None
    cm = inst.cost_model
    return PrefetchPlan(
        spans=tuple(spans), tokens=host_tokens + mig_tokens,
        restore_time=cm.restore_time(host_tokens + mig_tokens),
        migrate_tokens=mig_tokens,
        migrate_time=cm.migrate_time(mig_tokens))


def load_cost(inst: InstanceState, tree: RadixTree, match: MatchResult,
              prompt_len: int, now: float,
              migration: Optional[MigrationPlan] = None) -> float:
    """L_i + M_i + P_i for assigning the matched request to ``inst``.

    Tier-aware: tokens the instance holds only in its host-offload tier
    cost restore_time (a bandwidth-bound DMA), not a full recompute and
    not zero — so E2 correctly arbitrates restore-here vs recompute-here
    vs exploit-elsewhere. Restored tokens also re-occupy device pages,
    so they count toward the eviction-pressure estimate M. With a
    ``migration`` candidate, P additionally prices pulling that remote
    host-tier span (migrate + restore) against recomputing it — device
    occupancy (hence M) is identical either way."""
    cm = inst.cost_model
    # L_i — windowed history load (maintained incrementally; the paper's
    # Σ PREFILLTIME(missed_j) + DECODETIME(avg_out) is what add_work stored).
    L = inst.window_load(now)

    # per-instance split: device-cached / host-demoted / truly missed
    inst_cached = match.per_instance_len.get(inst.instance_id, 0)
    inst_host = match.per_instance_host_len.get(inst.instance_id, 0)
    missed = max(prompt_len - inst_cached - inst_host, 0)

    # M_i — eviction cost of making room: hit-rate-weighted loss of the
    # evicted nodes. With a host tier, eviction demotes (loss = restore
    # on re-hit); without one it drops (loss = full recompute).
    M = 0.0
    # occupancy via the path-keyed AGED estimate (device_pressure_est):
    # markings not re-confirmed within window H no longer count toward
    # eviction pressure, so M converges after eviction storms instead
    # of pinning at the clamped full-capacity gauge
    tokens_needed = (inst.device_pressure_est(now) + missed + inst_host
                     - inst.capacity_tokens)
    if tokens_needed > 0:
        protected: Set[int] = {n.node_id for n in match.path}
        plan = tree.plan_eviction(inst.instance_id, tokens_needed, protected)
        total_req = max(inst.requests_in_window(now), 1)
        # eviction loses a restore only while the host tier has room;
        # a full (aged) host tier drops on demote-overflow -> recompute
        host_room = (inst.host_capacity_tokens > 0
                     and inst.host_pressure_est(now)
                     < inst.host_capacity_tokens)
        loss = cm.restore_time if host_room else cm.prefill_time
        for node in plan:
            n_j = tree.hits_in_window(node, now, inst.instance_id) / total_req
            M += loss(len(node.tokens)) * n_j

    # P_i — prefill of the truly-missed tokens + restore of the demoted
    # (+ the migrate-vs-recompute arbitration for the remote span).
    P, _ = _phase_cost(cm, missed, inst_host,
                       migration.tokens if migration is not None else 0)

    cost = L + (M + P) * inst.speed_factor
    if inst.health == "suspect":
        # Soft-avoid: a suspect may just be straggling or losing
        # heartbeats, so it stays schedulable (a strictly-longer cached
        # prefix can still win the exploit rank), but among otherwise
        # comparable candidates the penalty routes work elsewhere. The
        # bias breaks the idle-cluster tie (all costs ~0).
        cost = cost * SUSPECT_COST_FACTOR + SUSPECT_COST_BIAS
    return cost


# ---------------------------------------------------------------------------
# Algorithm 1: SCHEDULEREQUEST(R_k)
# ---------------------------------------------------------------------------

def e2_schedule(instances: Dict[int, InstanceState], tree: RadixTree,
                match: MatchResult, prompt_len: int, now: float,
                imbal_ratio: float = 0.85,
                pd_min_load: float = 1.0,
                enable_migration: bool = True) -> ScheduleDecision:
    """Pure E2 decision (no tree mutation): exploit vs explore.

    ``imbal_ratio``: ImbalR in Algorithm 1 — an instance whose windowed
    compute is more decode-heavy than this is handed explore requests
    (prefill-phase units) outright, as its MXU capacity is nearly idle.
    ``pd_min_load``: PD balancing only kicks in above this absolute load
    (an idle cluster is trivially "decode heavy" at ratio 0/0 edge cases).
    ``enable_migration``: price tier-to-tier prefix migration per
    candidate (migrate + restore vs recompute) and attach the winning
    plan to the decision for the runtime to execute.
    """
    alive = {i: s for i, s in instances.items() if s.alive}
    if not alive:
        raise RuntimeError("no alive instances")

    cached_len = match.matched_len
    missed_len = prompt_len - cached_len

    plans: Dict[int, Optional[MigrationPlan]] = {}

    def mig_plan(i: int) -> Optional[MigrationPlan]:
        if i not in plans:
            plans[i] = (plan_migration(tree, match, i, instances,
                                       prompt_len, now)
                        if enable_migration else None)
        return plans[i]

    def attach(pick: int) -> Optional[MigrationPlan]:
        return attach_migration(alive[pick], match, mig_plan(pick),
                                prompt_len)

    def decide(pick: int, mode: str, cost: float,
               cands: Dict[int, float]) -> ScheduleDecision:
        mig = attach(pick)
        return ScheduleDecision(
            pick, mode, cached_len, missed_len, cost, cands,
            migration=mig,
            prefetch=build_prefetch_plan(alive[pick], match, prompt_len,
                                         migration=mig))

    if missed_len < cached_len and (match.per_instance_len
                                    or match.per_instance_host_len):
        # ---- EXPLOIT: instances holding the longest part of the match ----
        # Tier-aware: a host-demoted prefix is still worth exploiting
        # (restore beats recompute), so instances rank by their combined
        # device+host coverage; load_cost prices the restore term, so
        # among equal-coverage candidates a device copy wins on cost.
        eff: Dict[int, int] = {}
        for i, l in match.per_instance_len.items():
            if i in alive:
                eff[i] = eff.get(i, 0) + l
        for i, l in match.per_instance_host_len.items():
            if i in alive:
                eff[i] = eff.get(i, 0) + l
        best_len = max(eff.values()) if eff else 0
        if best_len > 0:
            K = [i for i, l in eff.items() if l == best_len]
            costs = {i: load_cost(alive[i], tree, match, prompt_len, now,
                                  migration=mig_plan(i))
                     for i in K}
            pick = min(costs, key=costs.get)
            return decide(pick, "exploit", costs[pick], costs)
        # matched prefix exists in tree but no alive instance caches it —
        # fall through to explore.

    # ---- EXPLORE ----
    # Prefill/decode balancing first (paper: prioritized over cost compare).
    # Only meaningful when the whole cluster is busy (paper §3.2 assumes
    # GPUs run at full capacity): an idle instance is always the better
    # explore target than a decode-heavy one, so skip PD-balance if any
    # instance is (near-)idle and let the cost comparison find it.
    loads_now = {i: s.window_load(now) for i, s in alive.items()}
    if min(loads_now.values()) > pd_min_load:
        ratios = {i: s.decode_ratio(now) for i, s in alive.items()}
        max_i = max(ratios, key=ratios.get)
        if ratios[max_i] > imbal_ratio:
            return decide(max_i, "pd_balance", 0.0, ratios)

    costs = {i: load_cost(s, tree, match, prompt_len, now,
                          migration=mig_plan(i))
             for i, s in alive.items()}
    pick = min(costs, key=costs.get)
    return decide(pick, "explore", costs[pick], costs)


def subtree_load(tree: RadixTree, node: RadixNode, cm: CostModel,
                 now: float) -> float:
    """Windowed exploitation load concentrated on a prefix subtree —
    used by autoscaling (paper: 'calculate the subtree's load using
    Algorithm 2'). Saved-prefill seconds per window for requests hitting
    the subtree."""
    total = 0.0
    for n in tree.subtree_nodes(node):
        hits = tree.hits_in_window(n, now)
        total += hits * cm.prefill_time(len(n.tokens))
    return total
