"""Preble local scheduler — iteration-level scheduling (paper §3.3).

One per model instance.  Maintains:
  * a wait queue of requests assigned by the global scheduler,
  * a local radix tree mirroring what this instance caches,
  * per-node active-request pin counts (via RadixNode.ref_count).

Every iteration it forms the next batch with the priority-group policy
(fairness by cached-token percentage), applies Sarathi-style chunked
prefill for long missed prompts, and LRU-evicts tree nodes when the
token budget overflows — asynchronously notifying the global scheduler.

The scheduler is engine-agnostic: the serving engine and the simulator
both drive it. Token-budget accounting is in tokens (1 token of KV/state
= 1 unit), matching how the engines size their page pools.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .radix_tree import PathKey, PrefixSpan, RadixNode, RadixTree
from .request import Request, RequestState


@dataclass
class LocalSchedulerConfig:
    instance_id: int = 0
    capacity_tokens: int = 2_000_000     # KV/state pool size in tokens
    chunk_size: int = 512                # Sarathi chunked-prefill chunk
    max_batch_tokens: int = 2048         # per-iteration token budget
    max_batch_requests: int = 64
    priority_groups: int = 10            # P in §3.3
    fcfs: bool = False                   # ablation: plain FCFS ordering
    window: float = 180.0
    # Host-offload tier budget (tokens). 0 disables tiering: eviction
    # drops KV (seed behavior). >0: eviction DEMOTES node KV to the
    # host tier (via the attached host_tier data mover) and a later hit
    # restores it instead of recomputing.
    host_capacity_tokens: int = 0
    # Speculative-restore budget (tokens; DESIGN.md §10). 0 disables
    # prefetch. >0: while a request waits, the scheduler reserves
    # device pages for its restorable host spans (charged to the token
    # gauge, capped by this budget) and the engine/simulator moves the
    # bytes host->device OFF the TTFT critical path; admission then
    # aliases the prefetched pages and restores nothing.
    prefetch_budget_tokens: int = 0
    # Speculative decoding (DESIGN.md §14): extra per-decode-slot token
    # charge against max_batch_tokens. With a draft model proposing K
    # tokens per request per step, each decode slot occupies a K+1-token
    # verify chunk in the fused dispatch instead of a single-token lane,
    # so batch formation must budget 1 + K tokens for it or the step's
    # real token count could exceed max_batch_tokens by K x slots.
    # 0 (default) is the exact pre-spec accounting.
    spec_verify_tokens: int = 0


class AccountingHostTier:
    """Data-mover stub for runs with no real device memory (the
    discrete-event simulator): every demote 'succeeds' for the node's
    full span, migration ships no bytes, and drops are free. The
    LocalScheduler layered on top still does all the real tier
    accounting (LRU, capacity, gauges, content-addressed keys), so
    simulator runs exercise the same policy code the engine does."""

    carries_bytes = False    # migration payloads are accounting-only

    def __init__(self, faults=None):
        # duck-typed fault injector (serving.faults.FaultInjector) so
        # simulator runs can lose demote "DMA" like the engine tier does;
        # core stays import-free of serving.
        self.faults = faults

    def demote_many(self, nodes: Sequence[RadixNode]) -> Dict[PathKey, int]:
        out: Dict[PathKey, int] = {}
        for n in nodes:
            if self.faults is not None and self.faults.dma_fails("demote"):
                continue             # transfer lost: span drops, not demotes
            out[n.path_key] = len(n.tokens)
        return out

    def drop(self, key: PathKey) -> None:
        pass

    def ingest(self, node: RadixNode, start: int, length: int,
               payload, offset: int) -> None:
        pass

    def export(self, node: RadixNode, lo: int, hi: int):
        return None

    def pending_has(self, key: PathKey) -> bool:
        return False

    def drain(self) -> None:
        pass


@dataclass
class BatchItem:
    request: Request
    phase: str            # "prefill" | "decode"
    chunk_tokens: int     # tokens processed this iteration
    cached_len: int = 0   # cache hit for this request (first chunk only)
    restored_len: int = 0 # host-tier tokens restored at admission
                          # (first chunk only; simulator charges
                          # restore_time for them, the engine DMAs them)
    migrated_len: int = 0 # tokens that arrived via tier-to-tier
                          # migration for this request (first chunk
                          # only; simulator charges migrate_time — the
                          # restore itself shows up in restored_len)


@dataclass
class Batch:
    """One iteration's mixed plan: decode slots (1 token each, always
    admitted first so a prefill flood can never starve decode lanes)
    plus prefill chunks whose quota was split across priority groups by
    ``form_batch``. Engines either run the two phases separately (dense
    reference) or pack every item into one fused ragged dispatch (paged
    fused plane)."""
    items: List[BatchItem] = field(default_factory=list)

    @property
    def prefill_tokens(self) -> int:
        return sum(i.chunk_tokens for i in self.items if i.phase == "prefill")

    @property
    def decode_tokens(self) -> int:
        return sum(i.chunk_tokens for i in self.items if i.phase == "decode")

    def prefill_items(self) -> List[BatchItem]:
        return [i for i in self.items if i.phase == "prefill"]

    def decode_items(self) -> List[BatchItem]:
        return [i for i in self.items if i.phase == "decode"]

    def __len__(self) -> int:
        return len(self.items)


class LocalScheduler:
    def __init__(self, config: LocalSchedulerConfig,
                 on_evict: Optional[Callable] = None,
                 host_tier=None,
                 node_id_start: int = 0):
        self.config = config
        self._node_ids = lambda: itertools.count(node_id_start)
        self.tree = RadixTree(window=config.window,
                              id_source=self._node_ids())
        self.tree.split_hooks.append(self._on_split)
        self.waiting: List[Request] = []
        self.running: List[Request] = []    # requests in decode phase
        self.prefilling: List[Request] = [] # requests mid-chunked-prefill
        self.used_tokens = 0                # device cache pool usage
        # Async global notification — protocol v2 (keyword-only,
        # content-addressed): called as
        #   on_evict(instance_id, evicted_spans,
        #            demoted=[...], host_dropped=[...])
        # with PrefixSpans throughout; local node ids never leave this
        # scheduler.
        self.on_evict = on_evict
        # host tier: the scheduler owns the POLICY (which spans live in
        # the host tier, their ordering, capacity in tokens, the
        # demote-vs-drop admission weighting); host_tier is the DATA
        # MOVER that actually demotes/drops/ships bytes — the engine's
        # PagedHostTier (device gather -> pinned numpy) or
        # AccountingHostTier for the simulator.
        self.host_tier = host_tier
        # host residency, CONTENT-ADDRESSED: path key -> demoted token
        # count, in recency order; _host_nodes pins each key to the
        # owning local node id so a digest collision can never alias two
        # different prefixes onto one entry.
        self._host_lru: "OrderedDict[PathKey, int]" = OrderedDict()
        self._host_nodes: Dict[PathKey, int] = {}
        self.host_used_tokens = 0
        self._pinned: Dict[int, List[RadixNode]] = {}  # req id -> pinned path
        # ---- speculative restore (DESIGN.md §10) ----
        # The scheduler owns prefetch POLICY: which waiting requests'
        # host chains are worth moving early, the token budget, page
        # reservations charged to the token gauge, host-LRU pinning of
        # in-flight spans, and cancel/refund. The engine (real scatter
        # DMA) or simulator (restore_time timer) is the MECHANISM that
        # calls back complete_prefetch / cancel_prefetch.
        self._prefetch_ids = itertools.count()
        self._prefetch_recs: Dict[int, dict] = {}      # rec id -> record
        self._prefetch_keys: Dict[PathKey, int] = {}   # pinned key -> rec
        self._prefetch_hints: Dict[int, object] = {}   # req id -> E2 plan
        # landed-but-unclaimed prefetched spans: key -> tokens; claimed
        # by the first admission whose device prefix covers them (hit)
        # or written off when eviction takes them first (wasted)
        self._prefetch_landed: Dict[PathKey, int] = {}
        self.prefetch_reserved_tokens = 0              # in-flight gauge
        # negative-verdict memo: request ids whose last plan walk found
        # nothing host-restorable — skipped on later pumps until host
        # residency can have changed (a demotion or a migration ingest
        # clears the memo). Keeps the per-pump cost O(new work), not
        # O(waiting x prompt_len).
        self._prefetch_noop: Set[int] = set()
        # monotone clock of the latest observed event time: cancel
        # paths reached from no-``now`` contexts (split hooks, forced
        # drops) use it so host-victim heat is still scored against
        # the CURRENT window, not t=0 (which would never trim hit
        # deques and rank victims by lifetime hits)
        self._clock = 0.0
        # per-request token account: the part of a request's reservation
        # that dies WITH the request (outputs + private prompt copies
        # not published to the prefix store) and must be refunded at
        # release — without this the gauge leaks max_new (+ any
        # recomputed/restored duplicate prefix) per finished request
        # and admission eventually wedges under sustained traffic.
        # Engines overwrite via set_account/credit_stored; the default
        # (simulator semantics: every prompt node is published) refunds
        # just the outputs.
        self._acct: Dict[int, int] = {}
        # telemetry facade (serving.telemetry.Telemetry), attached by
        # the owning runtime. Duck-typed: core never imports serving.
        # Every hook below is behind an `is not None` / `r.trace is not
        # None` check, mirroring the faults-gating pattern (§11).
        self.telemetry = None
        self.evicted_log: List[int] = []
        self.stats = {"batches": 0, "evicted_tokens": 0, "admitted": 0,
                      "starved_max_wait": 0.0, "demoted_tokens": 0,
                      "restored_tokens": 0, "host_dropped_tokens": 0,
                      "restore_hits": 0, "migrated_in_tokens": 0,
                      "migrated_out_tokens": 0, "demote_skipped_tokens": 0,
                      "prefetch_issued": 0, "prefetch_landed": 0,
                      "prefetch_hit": 0, "prefetch_wasted": 0,
                      "prefetch_cancelled": 0}

    @property
    def host_enabled(self) -> bool:
        return (self.host_tier is not None
                and self.config.host_capacity_tokens > 0)

    # ---- request intake ---------------------------------------------------------

    def _tiered_cached(self, request: Request, now: float,
                       update_stats: bool = False):
        """(match, device_len, host_len) for this instance, and set the
        request's cached_len to the *reusable* total (device-forkable +
        host-restorable) — NOT the raw tree match: nodes whose KV this
        instance already evicted without demotion are recompute, not
        cache hits, and must neither boost priority nor shrink the
        reservation."""
        m, dev, host = self.tree.tiered_match(
            request.tokens, self.config.instance_id, now=now,
            update_stats=update_stats)
        if not self.host_enabled:
            host = 0
        request.cached_len = min(dev + host, request.prompt_len)
        request.device_cached_len = dev
        return m, dev, host

    def enqueue(self, request: Request, now: float,
                prefetch=None) -> None:
        """``prefetch``: the E2 ``PrefetchPlan`` rider (advisory — the
        authoritative span set is re-derived from THIS tree when
        ``plan_prefetch`` reserves pages; the hint only prioritizes)."""
        self._clock = max(self._clock, now)
        self._tiered_cached(request, now, update_stats=True)
        request.state = RequestState.QUEUED_LOCAL
        if request.trace is not None:
            request.trace.begin("queue", now,
                                instance=self.config.instance_id)
        self.waiting.append(request)
        if prefetch is not None:
            self._prefetch_hints[request.request_id] = prefetch
        self.stats["admitted"] += 1

    @property
    def prefetch_enabled(self) -> bool:
        return self.host_enabled and self.config.prefetch_budget_tokens > 0

    # ---- priority-group wait-queue policy (§3.3) ----------------------------------

    def _priority(self, request: Request) -> int:
        """Group by cached-token percentage: 63% cached & P=10 -> group 6."""
        p = self.config.priority_groups
        if request.prompt_len == 0:
            return 0
        ratio = request.cached_len / request.prompt_len
        return min(int(ratio * p), p - 1)

    def _ordered_waiting(self, now: float) -> List[Request]:
        if self.config.fcfs or not self.waiting:
            return sorted(self.waiting, key=lambda r: r.arrival_time)
        p = self.config.priority_groups
        groups: Dict[int, List[Request]] = {}
        for r in self.waiting:
            # re-match: cache contents may have changed since enqueue
            self._tiered_cached(r, now)
            groups.setdefault(self._priority(r), []).append(r)
        for g in groups.values():
            g.sort(key=lambda r: r.arrival_time)   # FCFS within a group
        # proportional selection: group k gets quota proportional to (k+1),
        # realized as a round-robin draw weighted by priority (paper's
        # example: 10 from group 10, 9 from group 9, ...).
        order: List[Request] = []
        keys = sorted(groups.keys(), reverse=True)
        quotas = {k: k + 1 for k in keys}
        while any(groups[k] for k in keys):
            for k in keys:
                take = min(quotas[k], len(groups[k]))
                order.extend(groups[k][:take])
                del groups[k][:take]
        return order

    # ---- batch formation -----------------------------------------------------------

    def form_batch(self, now: float) -> Batch:
        """Continuous batching: all running decodes + waiting/chunked
        prefills under the token budget (chunked prefill piggybacks
        decodes, Sarathi-style)."""
        cfg = self.config
        self._clock = max(self._clock, now)
        batch = Batch()
        budget = cfg.max_batch_tokens

        # 1. decode-phase requests: 1 token each
        for r in list(self.running):
            if len(batch) >= cfg.max_batch_requests or budget <= 0:
                break
            batch.items.append(BatchItem(r, "decode", 1))
            # a speculative decode slot really spends 1 + K tokens of
            # the fused dispatch (its verify chunk); plain decode: 1
            budget -= 1 + cfg.spec_verify_tokens

        # 2. in-flight chunked prefills continue first (no re-admission cost)
        for r in list(self.prefilling):
            if len(batch) >= cfg.max_batch_requests or budget <= 0:
                break
            remaining = r.prompt_len - r.prefill_done
            chunk = min(remaining, cfg.chunk_size, budget)
            if chunk <= 0:
                continue
            batch.items.append(BatchItem(r, "prefill", chunk))
            budget -= chunk

        # 3. admit new requests by priority order
        if budget > 0 and len(batch) < cfg.max_batch_requests:
            for r in self._ordered_waiting(now):
                if budget <= 0 or len(batch) >= cfg.max_batch_requests:
                    break
                needed = r.prompt_len - r.cached_len
                if not self._reserve(r, now):
                    continue      # could not free memory: stays queued
                chunk = min(max(needed, 1), cfg.chunk_size, budget)
                r.prefill_done = r.cached_len
                r.state = RequestState.PREFILLING
                if r.first_run_time == 0.0:
                    r.first_run_time = now
                self.waiting.remove(r)
                self.prefilling.append(r)
                batch.items.append(
                    BatchItem(r, "prefill", chunk, cached_len=r.cached_len,
                              restored_len=r.restored_len,
                              migrated_len=r.migrated_len))
                if r.trace is not None:
                    r.trace.end("queue", now)
                    r.trace.begin("prefill", now)
                    r.trace.point("admit", now,
                                  instance=cfg.instance_id,
                                  cached=r.cached_len,
                                  device_cached=r.device_cached_len,
                                  restored=r.restored_len,
                                  migrated=r.migrated_len,
                                  prefetched=r.prefetched_len)
                    if r.restored_len:
                        r.trace.point("restore", now,
                                      tokens=r.restored_len)
                    if r.migrated_len:
                        r.trace.point("migrate", now,
                                      tokens=r.migrated_len)
                # the DCN charge is one-time — a re-queued request must
                # not re-pay a migration that already happened
                r.migrated_len = 0
                budget -= chunk

        if self.waiting:
            oldest = min(r.arrival_time for r in self.waiting)
            self.stats["starved_max_wait"] = max(
                self.stats["starved_max_wait"], now - oldest)
        self.stats["batches"] += 1
        return batch

    def clamp_chunk(self, item: BatchItem, *,
                    snapshot_boundary: bool = False) -> int:
        """Single authority for post-admission prefill-chunk clamping.

        ``form_batch`` sizes chunks from the *planned* cache hit, but
        the engine may reuse a different prefix length at admission
        (snapshot granularity, node pages already evicted), so every
        chunk is re-clamped to the request's true remaining prompt.
        With ``snapshot_boundary`` (recurrent archs) the chunk also
        stops at prompt_len - 1 so the state snapshot lands on a
        reusable boundary (reuse cap = prompt_len - 1). Keeping both
        clamps here — instead of two inline sites in the engine's
        step() — means the recurrent boundary rule cannot drift from
        the paged path's accounting."""
        r = item.request
        chunk = max(min(item.chunk_tokens, r.prompt_len - r.prefill_done), 0)
        if snapshot_boundary and r.prefill_done < r.prompt_len - 1:
            chunk = min(chunk, r.prompt_len - 1 - r.prefill_done)
        item.chunk_tokens = chunk
        return chunk

    # ---- memory management (tree + pool accounting) -----------------------------------

    def _reserve(self, request: Request, now: float) -> bool:
        """Reserve cache space for a request's full prompt + expected output;
        evict LRU tree nodes if needed (§3.3). Pins the match path.

        Two-tier accounting: only the DEVICE-cached prefix shrinks the
        reservation — host-demoted tokens are restorable without
        recompute (they shape cached_len/priority) but they re-occupy
        device pages on restore, exactly like prefilled tokens do."""
        m, dev, host = self._tiered_cached(request, now, update_stats=True)
        new_tokens = (request.prompt_len - dev + request.max_new_tokens)
        if new_tokens + self.used_tokens > self.config.capacity_tokens:
            need = new_tokens + self.used_tokens - self.config.capacity_tokens
            protected = {n.node_id for n in m.path}
            plan = self.tree.plan_eviction(self.config.instance_id, need,
                                           protected)
            freed = sum(len(n.tokens) for n in plan)
            if freed < need and self._prefetch_recs:
                # demand preempts speculation: in-flight prefetch
                # reservations are the one thing an admission may
                # always reclaim. Cancel LIFO (the youngest record is
                # furthest from landing) and ONLY until the admission
                # fits — wholesale preemption would cascade through
                # the queue and kill the pipeline it rides on.
                for rid in sorted(self._prefetch_recs, reverse=True):
                    self.cancel_prefetch(rid, now)
                    need = (new_tokens + self.used_tokens
                            - self.config.capacity_tokens)
                    plan = (self.tree.plan_eviction(
                        self.config.instance_id, need, protected)
                        if need > 0 else [])
                    freed = sum(len(n.tokens) for n in plan)
                    if freed >= need:
                        break
            if freed < need:
                return False
            if plan:
                self.apply_eviction(plan, now)
            # the eviction's demote cascade can overflow the host
            # budget and drop the very entries this request matched:
            # re-walk so restored_len only books KV that still exists
            # (the device prefix is protected and cannot shrink; the
            # engine additionally revalidates at staging time)
            m, dev, host = self._tiered_cached(request, now)
        # prefetched spans the device prefix now covers were moved off
        # this request's TTFT: claim them. In-flight prefetches this
        # request wanted are superseded — its own reservation (below)
        # covers the restore, so cancel and refund before charging.
        self._claim_prefetched(request, m, dev)
        self._cancel_prefetch_for(request.request_id)
        request.restored_len = max(
            min(dev + host, request.prompt_len - 1) - dev, 0)
        if request.restored_len > 0:
            # LRU-touch the host entries this request is about to
            # restore; the entries stay resident (the host copy remains
            # valid — the engine re-promotes the nodes to device aliases
            # after prefill) until host LRU pressure drops them.
            boundary = 0
            for node in m.path:
                boundary += len(node.tokens)
                if (boundary > dev
                        and self._host_nodes.get(node.path_key)
                        == node.node_id):
                    self.touch_host(node.path_key)
            self.stats["restored_tokens"] += request.restored_len
            self.stats["restore_hits"] += 1
        # pin matched path so concurrent eviction can't pull our prefix
        path = self.tree.insert(request.tokens,
                                instance=self.config.instance_id, now=now)
        for n in path:
            n.ref_count += 1
        self._pinned[request.request_id] = path
        self.used_tokens += new_tokens
        self._acct[request.request_id] = request.max_new_tokens
        return True

    def set_account(self, request_id: int, tokens: int) -> None:
        """Engine hook: set the request's dies-with-it token account
        (prompt - aliased + max_new on the paged plane); later
        credit_stored calls subtract the spans the request publishes."""
        self._acct[request_id] = tokens

    def credit_stored(self, request_id: int, tokens: int) -> None:
        """Engine hook: ``tokens`` of the request's KV were published
        to the prefix store (node alias / slab) — they now outlive the
        request and are refunded by eviction, not by release."""
        a = self._acct.get(request_id)
        if a is not None:
            self._acct[request_id] = max(a - tokens, 0)

    def touch_host(self, key: PathKey) -> None:
        """Recency touch for a host-tier entry (restore hit)."""
        if key in self._host_lru:
            self._host_lru.move_to_end(key)

    def _host_hits(self, key: PathKey, now: float) -> int:
        """Window-H hit count of the node owning a host entry — the
        n_j signal E2 already tracks, reused as the host-tier
        admission/retention weight."""
        nid = self._host_nodes.get(key)
        node = self.tree.get_node(nid) if nid is not None else None
        if node is None:
            return 0
        return self.tree.hits_in_window(node, now, self.config.instance_id)

    def _host_victim(self, now: float,
                     protected: frozenset = frozenset()) -> PathKey:
        """Pick the host entry to drop on overflow: lowest window-H hit
        rate first (hot prefixes outlive one-shot prompts), recency
        (LRU position) breaking ties; ``protected`` (just-ingested /
        just-demoted under an incoming restore) lose only when nothing
        else is left. Entries pinned by an in-flight prefetch are HARD
        skipped — the DMA reads them — so overflow can transiently
        exceed the budget until the prefetch drains and re-enforces.
        O(entries) per drop — fine at host-LRU scale."""
        best_key, best_score = None, None
        for pos, key in enumerate(self._host_lru):
            if key in self._prefetch_keys:
                continue
            score = (key in protected, self._host_hits(key, now), pos)
            if best_score is None or score < best_score:
                best_key, best_score = key, score
        return best_key

    def _enforce_host_capacity(self, now: float,
                               protected: frozenset = frozenset()
                               ) -> List[PrefixSpan]:
        """Drop hit-rate-weighted victims until the host tier fits its
        budget; returns the dropped spans for the v2 notification."""
        dropped: List[PrefixSpan] = []
        inst = self.config.instance_id
        while (self.host_used_tokens > self.config.host_capacity_tokens
               and self._host_lru):
            key = self._host_victim(now, protected)
            if key is None:
                break               # everything left is prefetch-pinned
            toks = self._host_lru.pop(key)
            nid = self._host_nodes.pop(key, None)
            self.host_used_tokens -= toks
            self.host_tier.drop(key)
            node = self.tree.get_node(nid) if nid is not None else None
            if node is not None:
                node.host_instances.discard(inst)
                dropped.append(node.span())
            else:
                dropped.append(PrefixSpan(key, toks))
            self.stats["host_dropped_tokens"] += toks
        return dropped

    def apply_eviction(self, plan: Sequence[RadixNode],
                       now: float = 0.0) -> int:
        """Evict ``plan`` from the device tier and run ALL the
        bookkeeping (pool accounting, tier demotion, stats, eviction
        log, async notification) — the single place eviction side
        effects happen, shared by _reserve and the engine's
        page-fragmentation reclaim.

        With the host tier enabled, eviction DEMOTES: the data mover
        copies each node's KV device->host (and frees its pages); the
        node is marked host-resident and joins the host LRU keyed by
        its path. Admission is hit-rate weighted: under host-budget
        pressure a span with no window-H re-hits beyond its own insert
        (a one-shot prompt) is dropped outright instead of displacing a
        re-hit prefix; with budget to spare everything demotes. Nodes
        the mover cannot demote (KV never materialized) and spans whose
        path key is ambiguous (digest collision) are dropped as before.
        Host-capacity overflow then drops the lowest-hit-rate entries.
        The v2 notification ships (evicted, demoted, host_dropped)
        PrefixSpans in ONE keyword-only message."""
        inst = self.config.instance_id
        self._clock = max(self._clock, now)
        # demotions change host residency: cleared no-prefetch verdicts
        self._prefetch_noop.clear()
        # window-H hit counts BEFORE evict: tree.evict drops this
        # instance's hit history with its marking, and the demote
        # admission weighting below needs the pre-eviction heat
        plan_hits = {n.node_id: self.tree.hits_in_window(n, now, inst)
                     for n in plan}
        self.tree.evict(plan, inst)
        freed = sum(len(n.tokens) for n in plan)
        self.used_tokens = max(self.used_tokens - freed, 0)
        self.stats["evicted_tokens"] += freed
        for n in plan:
            # prefetched pages evicted before any admission aliased
            # them: the speculative DMA bought nothing
            toks = self._prefetch_landed.pop(n.path_key, None)
            if toks:
                self.stats["prefetch_wasted"] += toks
        spans = [n.span() for n in plan]
        demoted_spans: List[PrefixSpan] = []
        dropped_spans: List[PrefixSpan] = []
        if self.host_enabled and plan:
            cap = self.config.host_capacity_tokens
            candidates: List[RadixNode] = []
            projected = self.host_used_tokens
            for n in plan:
                key = n.path_key
                resident = self._host_nodes.get(key) == n.node_id
                if self.tree.key_ambiguous(key) and not resident:
                    # collided identity: its KV cannot be addressed
                    # safely by content — recompute on re-hit
                    self.stats["demote_skipped_tokens"] += len(n.tokens)
                    continue
                hot = plan_hits.get(n.node_id, 0) > 1
                if (not hot and not resident
                        and projected + len(n.tokens) > cap):
                    # one-shot span under host pressure: not worth
                    # displacing a re-hit prefix
                    self.stats["demote_skipped_tokens"] += len(n.tokens)
                    continue
                if not resident:
                    projected += len(n.tokens)
                candidates.append(n)
            got = (self.host_tier.demote_many(candidates)
                   if candidates else {})
            fresh = set()
            for n in candidates:
                g = got.get(n.path_key, 0)
                if g <= 0:
                    continue
                prev = self._host_lru.pop(n.path_key, None)
                if prev is not None:
                    self.host_used_tokens -= prev
                self._host_lru[n.path_key] = g
                self._host_nodes[n.path_key] = n.node_id
                self.host_used_tokens += g
                n.host_instances.add(inst)
                demoted_spans.append(n.span())
                fresh.add(n.path_key)
                self.stats["demoted_tokens"] += g
            dropped_spans = self._enforce_host_capacity(
                now, protected=frozenset(fresh))
        self.evicted_log.extend(n.node_id for n in plan)
        if self.on_evict is not None:
            self.on_evict(inst, spans, demoted=demoted_spans,
                          host_dropped=dropped_spans)  # async in prod
        return freed

    def drop_host(self, key: PathKey) -> int:
        """Forcibly drop one host-tier entry (both policy state and the
        mover's bytes) — the failure-injection path tests use to model
        a host entry dying mid-flight. Returns tokens dropped."""
        toks = self._host_lru.pop(key, None)
        if toks is None:
            return 0
        # a force-drop yanks the bytes an in-flight prefetch is
        # reading: cancel it (refund, unpin) before the entry dies
        rec_id = self._prefetch_keys.get(key)
        if rec_id is not None:
            self.cancel_prefetch(rec_id)
        nid = self._host_nodes.pop(key, None)
        self.host_used_tokens -= toks
        if self.host_tier is not None:
            self.host_tier.drop(key)
        node = self.tree.get_node(nid) if nid is not None else None
        span = node.span() if node is not None else PrefixSpan(key, toks)
        if node is not None:
            node.host_instances.discard(self.config.instance_id)
        self.stats["host_dropped_tokens"] += toks
        if self.on_evict is not None:
            self.on_evict(self.config.instance_id, [], demoted=[],
                          host_dropped=[span])
        return toks

    # ---- tier-to-tier migration (DESIGN.md §9) -------------------------------

    def export_host_span(self, tokens: Sequence[int], lo: int, hi: int
                         ) -> List[Tuple[int, int, object]]:
        """Migration SOURCE side: slice this instance's host-tier
        entries covering tokens[lo:hi] into portable (lo, hi, payload)
        pieces. Pieces are contiguous from ``lo`` and end on node
        boundaries of THIS tree (or on ``hi``) — boundaries only ever
        refine across trees, so the receiver can re-align them to its
        own nodes. Stops at the first gap or partial entry; the caller
        ships whatever contiguous prefix actually exists (the planner's
        view may be stale), and the receiver's restore path degrades
        the rest to recompute."""
        out: List[Tuple[int, int, object]] = []
        if not self.host_enabled or hi <= lo:
            return out
        m = self.tree.match(tokens[:hi])
        boundary = 0
        cursor = lo
        for node in m.path:
            start = boundary
            boundary += len(node.tokens)
            if boundary <= lo:
                continue
            if cursor >= hi or start > cursor:
                break
            key = node.path_key
            toks = self._host_lru.get(key)
            if toks is None or self._host_nodes.get(key) != node.node_id:
                break                       # not host-resident: chain ends
            piece_end = min(start + toks, hi)
            if piece_end <= cursor:
                break
            if piece_end < boundary and piece_end < hi:
                break                       # partial entry tail: not aligned
            payload = self.host_tier.export(node, cursor, piece_end)
            if payload is None and getattr(self.host_tier,
                                           "carries_bytes", False):
                break                       # bytes vanished mid-flight
            out.append((cursor, piece_end, payload))
            self.stats["migrated_out_tokens"] += piece_end - cursor
            cursor = piece_end
        return out

    def ingest_host_span(self, tokens: Sequence[int],
                         spans: Sequence[Tuple[int, int, object]],
                         now: float = 0.0) -> List[Tuple[int, int]]:
        """Migration TARGET side: align incoming host-tier pieces to
        THIS tree's node boundaries (inserting the path, host-marking
        only — the device tier is untouched), admit them into the host
        LRU + data mover, enforce the host budget (hit-rate weighted;
        the just-ingested spans are protected — they are about to be
        restored), and return the accepted (lo, hi) ranges."""
        accepted: List[Tuple[int, int]] = []
        if not self.host_enabled:
            return accepted
        inst = self.config.instance_id
        self._prefetch_noop.clear()     # inbound spans: re-plan everyone
        fresh: Set[PathKey] = set()
        for lo, hi, payload in spans:
            if hi <= lo:
                continue
            if payload is None and getattr(self.host_tier,
                                           "carries_bytes", False):
                continue                    # byteless piece on a byte mover
            path = self.tree.insert(tokens[:hi], now=now)
            boundary = 0
            cursor = lo
            for node in path:
                start = boundary
                boundary += len(node.tokens)
                if boundary <= lo:
                    continue
                if start >= hi or start != cursor:
                    break
                length = min(boundary, hi) - start
                key = node.path_key
                if self._host_nodes.get(key) == node.node_id:
                    # already resident here — but only as far as the
                    # existing entry actually reaches: a partial entry
                    # must not inflate the accepted range (the caller
                    # charges DCN time and host-marks the forest by it)
                    have = self._host_lru.get(key, 0)
                    cursor = start + min(have, length)
                    if have < length:
                        break
                    continue
                if key in self._host_lru or self.tree.key_ambiguous(key):
                    break                       # collided identity: stop
                self.host_tier.ingest(node, start, length, payload,
                                      start - lo)
                self._host_lru[key] = length
                self._host_nodes[key] = node.node_id
                self.host_used_tokens += length
                node.host_instances.add(inst)
                fresh.add(key)
                self.stats["migrated_in_tokens"] += length
                cursor = start + length
            if cursor > lo:
                accepted.append((lo, cursor))
        dropped = self._enforce_host_capacity(now,
                                              protected=frozenset(fresh))
        if dropped and self.on_evict is not None:
            self.on_evict(inst, [], demoted=[], host_dropped=dropped)
        return accepted

    # ---- speculative restore: prefetch policy (DESIGN.md §10) -----------------

    def plan_prefetch(self, now: float) -> List[dict]:
        """Budgeted prefetch queue over ``waiting``: walk requests in
        priority order (E2-hinted requests first) and reserve device
        pages for host-resident span chains that contiguously extend
        each request's device coverage. Whole nodes only — the landed
        pages publish as node aliases, so charge/refund stays aligned
        with eviction accounting. Reservations are charged to the
        token gauge immediately (admission gating sees them) and capped
        by ``prefetch_budget_tokens``; under pressure prefetch evicts
        exactly like ``_reserve`` would at admission (the queued
        request needs those pages then anyway — prefetch only moves
        the eviction earlier, protected by the request's match path).
        In-flight host entries are pinned against host-drop and
        demote-overflow — including drops cascading from prefetch's
        own evictions.

        Prefetch reads are NOT hits: the tree walk records no window-H
        hit and the host LRU is not touched — a speculative read must
        not inflate hit-rate-weighted retention heat.

        Returns the new records; the mechanism (engine scatter stream /
        simulator timer) later calls ``complete_prefetch`` or
        ``cancel_prefetch`` with each record's id."""
        if not self.prefetch_enabled or not self.waiting:
            return []
        cfg = self.config
        self._clock = max(self._clock, now)
        budget = cfg.prefetch_budget_tokens
        out: List[dict] = []
        hinted = [r for r in self.waiting
                  if r.request_id in self._prefetch_hints]
        rest = [r for r in self.waiting
                if r.request_id not in self._prefetch_hints]
        # requests already riding an in-flight record (their own plan,
        # or shared fate with another prompt's chain) are skipped
        # outright — no point re-walking their prompts every pump
        riding: Set[int] = set()
        for rec in self._prefetch_recs.values():
            riding |= rec["want"]
        for r in hinted + rest:
            if self.prefetch_reserved_tokens >= budget:
                break
            if r.request_id in riding or r.request_id in self._prefetch_noop:
                continue
            # no update_stats: a speculative read is not a hit
            m, dev, host = self.tree.tiered_match(
                r.tokens, cfg.instance_id, now=now, update_stats=False)
            if host <= 0:
                self._prefetch_noop.add(r.request_id)
                continue
            if (m.last_node is not None
                    and m.last_node_matched < len(m.last_node.tokens)
                    and m.last_node.path_key in self._prefetch_keys):
                # this prompt's boundary split would land inside a node
                # ANOTHER record is reading — cancel-on-split would
                # kill that in-flight DMA. Defer; re-plan next pump
                # once it lands (speculation never displaces
                # speculation).
                continue
            if (m.last_node is not None
                    and m.last_node_matched < len(m.last_node.tokens)):
                # split the tree at this prompt's boundary exactly like
                # admission's insert will (splits are the only boundary
                # edits) so the host chain ends on whole nodes; no
                # instance marking, no hit recording, and NO LRU touch
                # — pure structure until the request is served. Skipped
                # when the boundary is already node-aligned.
                self.tree.insert(r.tokens, now=now, touch=False)
                m, dev, host = self.tree.tiered_match(
                    r.tokens, cfg.instance_id, now=now,
                    update_stats=False)
            limit = r.prompt_len - 1
            spans: List[Tuple[PathKey, int, int, int]] = []
            b = 0
            lo = None
            hi = None
            for node in m.path:
                start = b
                b += len(node.tokens)
                if b <= dev:
                    continue
                if start < dev or b > limit:
                    break           # mid-node device tail / reuse cap
                key = node.path_key
                if key in self._prefetch_keys:
                    # already being prefetched (for someone else):
                    # share the record's fate instead of duplicating it
                    other = self._prefetch_recs.get(
                        self._prefetch_keys[key])
                    if other is not None and lo is None:
                        other["want"].add(r.request_id)
                    break
                if (self._host_nodes.get(key) != node.node_id
                        or self._host_lru.get(key, 0) < len(node.tokens)):
                    break           # not (fully) host-resident here
                if lo is None:
                    lo = start
                if self.prefetch_reserved_tokens + (b - lo) > budget:
                    break
                spans.append((key, node.node_id, start, b))
                hi = b
            if lo is None or hi is None or hi <= lo:
                continue
            rec = {"id": next(self._prefetch_ids), "tokens": r.tokens[:hi],
                   "lo": lo, "hi": hi, "spans": spans, "reserved": hi - lo,
                   "want": {r.request_id}, "cancelled": False,
                   "landed": False}
            # pin the chain BEFORE making room: the eviction below can
            # cascade into host-capacity drops, which must not pick the
            # very entries this prefetch reads
            self._prefetch_recs[rec["id"]] = rec
            for key, _, _, _ in spans:
                self._prefetch_keys[key] = rec["id"]
            need = (self.used_tokens + rec["reserved"]
                    - cfg.capacity_tokens)
            if need > 0:
                # never let speculative work displace OTHER speculative
                # work: landed-but-unclaimed prefetch pages and every
                # in-flight record's spans are protected — otherwise a
                # wave of prefetches thrashes itself (admission-time
                # eviction may still take them; that is real demand)
                protected = {n.node_id for n in m.path}
                for key in self._prefetch_landed:
                    node = self.tree.node_by_key(key)
                    if node is not None:
                        protected.add(node.node_id)
                for other in self._prefetch_recs.values():
                    protected.update(nid for _, nid, _, _
                                     in other["spans"])
                plan = self.tree.plan_eviction(cfg.instance_id, need,
                                               protected)
                if sum(len(n.tokens) for n in plan) < need:
                    for key, _, _, _ in spans:
                        self._prefetch_keys.pop(key, None)
                    self._prefetch_recs.pop(rec["id"])
                    continue        # cannot make room: stays un-prefetched
                self.apply_eviction(plan, now)
            self.used_tokens += rec["reserved"]
            self.prefetch_reserved_tokens += rec["reserved"]
            self.stats["prefetch_issued"] += rec["reserved"]
            if self.telemetry is not None:
                self.telemetry.event("prefetch_issue", now,
                                     instance=cfg.instance_id,
                                     rec=rec["id"],
                                     tokens=rec["reserved"],
                                     want=sorted(rec["want"]))
                for q in self.waiting:
                    if q.request_id in rec["want"] and q.trace is not None:
                        q.trace.point("prefetch_issue", now,
                                      rec=rec["id"],
                                      tokens=rec["reserved"])
            out.append(rec)
        return out

    def trim_prefetch(self, rec_id: int, hi_eff: int) -> None:
        """Mechanism revalidated the record against the byte store and
        can only move [lo, hi_eff): refund the unmovable tail now."""
        rec = self._prefetch_recs.get(rec_id)
        if rec is None or rec["cancelled"] or hi_eff >= rec["hi"]:
            return
        if hi_eff <= rec["lo"]:
            self.cancel_prefetch(rec_id)
            return
        diff = rec["hi"] - hi_eff
        keep = [s for s in rec["spans"] if s[3] <= hi_eff]
        for key, _, _, _ in rec["spans"]:
            if all(key != k for k, _, _, _ in keep):
                self._prefetch_keys.pop(key, None)
        rec["spans"] = keep
        rec["hi"] = hi_eff
        rec["tokens"] = rec["tokens"][:hi_eff]
        rec["reserved"] -= diff
        self.used_tokens = max(self.used_tokens - diff, 0)
        self.prefetch_reserved_tokens -= diff
        self.stats["prefetch_cancelled"] += diff
        self.stats["prefetch_issued"] -= diff

    def cancel_prefetch(self, rec_id: int,
                        now: Optional[float] = None) -> int:
        """Cancel an in-flight prefetch (split under it, host entry
        force-dropped, every wanting request gone, mechanism could not
        stage it): unpin its keys and refund the whole reservation.
        Landed records cannot be cancelled (their pages are cache now).
        Returns tokens refunded."""
        if now is None:
            now = self._clock
        rec = self._prefetch_recs.get(rec_id)
        if rec is None or rec["landed"] or rec["cancelled"]:
            return 0
        rec["cancelled"] = True
        for key, _, _, _ in rec["spans"]:
            if self._prefetch_keys.get(key) == rec_id:
                self._prefetch_keys.pop(key, None)
        self.used_tokens = max(self.used_tokens - rec["reserved"], 0)
        self.prefetch_reserved_tokens -= rec["reserved"]
        self.stats["prefetch_cancelled"] += rec["reserved"]
        if self.telemetry is not None:
            self.telemetry.event("prefetch_cancel", now,
                                 instance=self.config.instance_id,
                                 rec=rec_id, tokens=rec["reserved"])
            for q in self.waiting:
                if q.request_id in rec["want"] and q.trace is not None:
                    q.trace.point("prefetch_cancel", now, rec=rec_id,
                                  tokens=rec["reserved"])
        self._prefetch_recs.pop(rec_id, None)
        # unpinning may unblock an overdue host-capacity enforcement
        dropped = self._enforce_host_capacity(now)
        if dropped and self.on_evict is not None:
            self.on_evict(self.config.instance_id, [], demoted=[],
                          host_dropped=dropped)
        return rec["reserved"]

    def complete_prefetch(self, rec_id: int, now: float) -> dict:
        """The mechanism finished moving a record's bytes into device
        pages (and, engine-side, published the node aliases): mark the
        spans device-resident on this instance — WITHOUT recording a
        window-H hit (speculative, not a serve) — convert the
        reservation into ordinary cache occupancy (a later eviction
        refunds it through ``apply_eviction``), and unpin the host
        entries (their copies stay resident, like any restore).
        Returns ``{"landed": tokens, "want": request_ids}``; landed is
        0 for a record cancelled mid-flight."""
        self._clock = max(self._clock, now)
        rec = self._prefetch_recs.pop(rec_id, None)
        if rec is None or rec["cancelled"]:
            return {"landed": 0, "want": set()}
        inst = self.config.instance_id
        landed = 0
        for key, nid, a, b in rec["spans"]:
            if self._prefetch_keys.get(key) == rec_id:
                self._prefetch_keys.pop(key, None)
            node = self.tree.get_node(nid)
            toks = b - a
            if node is None or node.path_key != key \
                    or inst in node.instances:
                # node vanished/rekeyed under us, or someone else
                # (an admission's restore) already promoted it —
                # refund the duplicate reservation
                self.used_tokens = max(self.used_tokens - toks, 0)
                self.prefetch_reserved_tokens -= toks
                self.stats["prefetch_cancelled"] += toks
                continue
            node.instances.add(inst)        # no record_hit: not a serve
            node.last_access = now          # recency, not heat
            self.prefetch_reserved_tokens -= toks
            self._prefetch_landed[key] = (
                self._prefetch_landed.get(key, 0) + toks)
            landed += toks
            self.stats["prefetch_landed"] += toks
        rec["landed"] = True
        if self.telemetry is not None:
            self.telemetry.event("prefetch_land", now, instance=inst,
                                 rec=rec_id, tokens=landed)
            for q in self.waiting:
                if q.request_id in rec["want"] and q.trace is not None:
                    q.trace.point("prefetch_land", now, rec=rec_id,
                                  tokens=landed)
        dropped = self._enforce_host_capacity(now)
        if dropped and self.on_evict is not None:
            self.on_evict(inst, [], demoted=[], host_dropped=dropped)
        return {"landed": landed, "want": set(rec["want"])}

    def _cancel_prefetch_for(self, request_id: int) -> None:
        """A wanting request left the queue (admitted — its own
        reservation now covers the restore — or aborted): drop it from
        every record's want-set and cancel records nobody wants."""
        self._prefetch_hints.pop(request_id, None)
        self._prefetch_noop.discard(request_id)
        for rec_id, rec in list(self._prefetch_recs.items()):
            if request_id in rec["want"]:
                rec["want"].discard(request_id)
                if not rec["want"] and not rec["landed"]:
                    self.cancel_prefetch(rec_id)

    def _claim_prefetched(self, request: Request, m, dev: int) -> None:
        """Admission reached spans a prefetch landed: count the hit
        (the pages it aliases were moved off this request's TTFT) and
        retire the landed marker."""
        b, claimed = 0, 0
        for node in m.path:
            b += len(node.tokens)
            if b > dev:
                break
            toks = self._prefetch_landed.pop(node.path_key, None)
            if toks:
                self.stats["prefetch_hit"] += toks
                request.prefetched_len += toks
                claimed += toks
        if claimed and request.trace is not None:
            # the DMA these tokens needed already ran, hidden behind
            # queue wait — breakdown() reports it as prefetch_hidden
            request.trace.point("prefetch_claim", self._clock,
                                tokens=claimed)

    # ---- iteration completion -----------------------------------------------------------

    def complete_iteration(self, batch: Batch, now: float,
                           finished_fn: Optional[Callable[[Request], bool]] = None
                           ) -> List[Request]:
        """Advance request states after the engine ran ``batch``.
        ``finished_fn`` lets the engine signal EOS; default: request
        finishes after max_new_tokens decodes."""
        finished: List[Request] = []
        for item in batch.items:
            r = item.request
            if item.phase == "prefill":
                r.prefill_done += item.chunk_tokens
                if r.prefill_done >= r.prompt_len:
                    self.prefilling.remove(r)
                    self.running.append(r)
                    r.state = RequestState.DECODING
                    if r.first_token_time == 0.0:
                        r.first_token_time = now
                    if r.trace is not None:
                        r.trace.end("prefill", now)
                        r.trace.point("first_token", now)
                        r.trace.begin("decode", now)
            else:
                r.output_tokens.append(0)  # engine overwrites real ids
                done = (finished_fn(r) if finished_fn
                        else len(r.output_tokens) >= r.max_new_tokens)
                if done:
                    self.running.remove(r)
                    r.state = RequestState.FINISHED
                    r.finish_time = now
                    if r.trace is not None:
                        r.trace.end("decode", now)
                        r.trace.point("finish", now)
                    self._release(r)
                    finished.append(r)
        return finished

    def _release(self, request: Request) -> None:
        for n in self._pinned.pop(request.request_id, []):
            n.ref_count = max(n.ref_count - 1, 0)
        # prompt KV published to the prefix store stays cached until
        # LRU-evicted (eviction refunds those spans); the request's
        # PRIVATE tokens — outputs and any unpublished prompt copy —
        # die here and are refunded from the per-request account.
        self.used_tokens = max(
            self.used_tokens - self._acct.pop(request.request_id, 0), 0)

    def _on_split(self, head: RadixNode, tail: RadixNode) -> None:
        """Keep pin lists aligned with node splits: _split copies the
        pin count to the tail (every pre-split pinner's prompt spans the
        whole original node, hence the tail too), so each such pinner
        must also hold the tail in its list or _release would leave
        tail.ref_count > 0 forever — permanently unevictable."""
        for path in self._pinned.values():
            if head in path and tail not in path:
                path.append(tail)
        # keep host-LRU accounting aligned with the split. Path-keyed
        # identity: the TAIL keeps the pre-split key (its end boundary
        # is unchanged), so the existing entry's key now names the tail
        # — its tokens past the cut stay put, while the head's part is
        # rekeyed under the head's new (shallower) key. (The data mover
        # splits the actual KV arrays through its own split hook, under
        # the same key moves.)
        old_key = tail.path_key
        # cancel-on-split: an in-flight prefetch pinned to the pre-split
        # key would land under boundaries that no longer exist — refund
        # it rather than re-deriving spans mid-flight (conservative but
        # always correct; the next plan_prefetch re-plans post-split).
        # Landed markers re-home to the tail (which keeps the key and
        # the deeper boundary); the head's share is written off when
        # its own eviction lands.
        rec_id = self._prefetch_keys.get(old_key)
        if rec_id is not None:
            self.cancel_prefetch(rec_id)
        landed = self._prefetch_landed.get(old_key)
        if landed is not None:
            tail_part = min(landed, len(tail.tokens))
            if tail_part < landed:
                self._prefetch_landed[head.path_key] = (
                    self._prefetch_landed.get(head.path_key, 0)
                    + landed - tail_part)
            self._prefetch_landed[old_key] = tail_part
        toks = self._host_lru.get(old_key)
        if toks is None or self._host_nodes.get(old_key) != head.node_id:
            return          # no entry, or a collided key we don't own
        head_toks = min(toks, len(head.tokens))
        tail_toks = toks - head_toks
        if head.path_key in self._host_lru:
            # digest collision with an existing entry: the head part
            # cannot be addressed by content — drop its tokens (the
            # store's split hook mirrors this by the same condition)
            self.host_used_tokens -= head_toks
            self.stats["host_dropped_tokens"] += head_toks
            head_toks = 0
        if tail_toks > 0:
            self._host_lru[old_key] = tail_toks    # keeps LRU position
            self._host_nodes[old_key] = tail.node_id
        else:
            self._host_lru.pop(old_key)
            self._host_nodes.pop(old_key)
        if head_toks > 0:
            # head part lands at the MRU end — close enough to the
            # original recency for LRU purposes
            self._host_lru[head.path_key] = head_toks
            self._host_nodes[head.path_key] = head.node_id

    def abort(self, request: Request) -> None:
        """Drop an admitted request the engine cannot serve (oversized
        prompt, pool exhausted): remove it from every queue, unpin its
        path, mark it FAILED. The engine skips its batch item; the
        caller decides whether to resubmit.

        Only the request's private account (max_new_tokens at this
        point — the engine sets more only on successful admission) is
        refunded here, by _release: _reserve already inserted the
        prompt path and marked it cached on this instance, and those
        (KV-less) suffix nodes stay in the tree until LRU eviction —
        which refunds their token span through apply_eviction.
        Refunding the prompt part here too would double-count when
        that eviction lands."""
        for q in (self.prefilling, self.running, self.waiting):
            if request in q:
                q.remove(request)
        self._cancel_prefetch_for(request.request_id)
        self._release(request)
        request.state = RequestState.FAILED
        if request.trace is not None:
            request.trace.close_open(self._clock, status="error")
            request.trace.point("failed", self._clock, reason="abort")
        # a queued abort may leave a purely structural path behind
        # (plan_prefetch's boundary split, _reserve's insert): prune
        # the dead leaf chain so aborted prompts cannot grow the local
        # tree unboundedly. prune_upward only removes leaves with no
        # markings, pins, or window-H hits — shared prefixes survive.
        m = self.tree.match(request.tokens)
        if m.last_node is not None:
            self.tree.prune_upward(m.last_node, self._clock)

    # ---- failure handling -----------------------------------------------------------------

    def residency_digest(self) -> Dict[str, List[Tuple[PathKey, int]]]:
        """Compact path-keyed truth of what this instance actually
        holds, for the global scheduler's anti-entropy reconcile
        (DESIGN.md §11): per-node ``(path_key, length)`` spans for the
        device tier (this scheduler's own tree markings — the exact
        state eviction notifications are emitted from) and the host
        tier (the demote LRU). Content-addressed, so the global forest
        resolves them across split granularity like v2 notifications."""
        inst = self.config.instance_id
        dev = [(n.path_key, len(n.tokens))
               for n in self.tree.iter_nodes() if inst in n.instances]
        return {"device": dev, "host": list(self._host_lru.items())}

    def drain(self) -> List[Request]:
        """Pull every queued/in-flight request (instance dying/restarting).
        Requests come back scrubbed of every placement-scoped field
        (``reset_for_retry``): stale ``migrated_len``/``prefetched_len``/
        partial outputs from this placement would corrupt the next one."""
        out = self.waiting + self.prefilling + self.running
        for r in out:
            r.reset_for_retry()
        self.waiting, self.prefilling, self.running = [], [], []
        self._pinned.clear()
        self._acct.clear()
        self.used_tokens = 0
        self._host_lru.clear()
        self._host_nodes.clear()
        self.host_used_tokens = 0
        for rec in self._prefetch_recs.values():
            rec["cancelled"] = True     # mechanism drops them on drain
        self._prefetch_recs.clear()
        self._prefetch_keys.clear()
        self._prefetch_hints.clear()
        self._prefetch_landed.clear()
        self._prefetch_noop.clear()
        self.prefetch_reserved_tokens = 0
        self.tree = RadixTree(window=self.config.window,
                              id_source=self._node_ids())
        self.tree.split_hooks.append(self._on_split)
        return out

    @property
    def depth(self) -> int:
        return len(self.waiting) + len(self.prefilling) + len(self.running)
