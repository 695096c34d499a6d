"""Per-instance continuous-batching engine on the paged fused data plane
(counterpart of the JAX package's ``serving/engine.py``).

All KV lives in one device-resident page pool per layer
([n_pages, page_size, KH, D]); requests address it through page tables
held by ``serving/kv_cache.py::PagedKVPool``. Prefix reuse is ``fork()``
page aliasing with refcounts + copy-on-write: admission makes no device
KV copy, except one page copy when the reuse boundary falls mid-page.
Iterations with prefill work run FUSED: every ready prefill chunk and
every decode slot packed into one dispatch (``_run_mixed``).
Pure-decode iterations run the bucketed decode step
(``_decode_batch_paged``). Radix-tree nodes alias the pool through
per-node page tables; eviction maps to ``release``.

The model runs eagerly in PyTorch on ``device`` ("cuda" unless the
caller asks for "cpu"); pool tensors are updated in place. Batches keep
the reference's power-of-two buckets (``_bucket``), so padding lanes and
``fused_padded_tokens`` match the JAX engine exactly.

Not ported yet (construction raises ``NotImplementedError``): the dense
plane (``paged=False``), the host KV tier and its prefetch, speculative
decoding, and tensor-parallel instances.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import full_precision_matmuls
from ..bridge import tree_to
from ..core.local_scheduler import Batch, LocalScheduler, LocalSchedulerConfig
from ..core.radix_tree import PrefixSpan
from ..core.request import Request
from ..models import zoo
from .batch import ForwardBatch, ModelWorkerBatch
from .faults import InstanceCrashed
from .kv_cache import PagedKVPool
from .telemetry import StatsDict

Pytree = Any


class AdmissionError(RuntimeError):
    """A request the engine cannot serve (oversized for max_context)."""


@dataclass
class EngineConfig:
    instance_id: int = 0
    max_context: int = 256          # per-request context bound
    max_batch_requests: int = 8
    chunk_size: int = 32            # Sarathi chunk
    max_batch_tokens: int = 128
    capacity_tokens: int = 16384    # KV pool budget (tokens)
    page_size: int = 16
    priority_groups: int = 10
    fcfs: bool = False
    # None/True: the paged plane (the only one ported); False (the dense
    # reference plane) raises
    paged: Optional[bool] = None
    # None/True: fused ragged iterations; False: the per-request prefill
    # loop, kept as the fused plane's comparison baseline
    fused: Optional[bool] = None
    # not ported yet: must stay at their defaults
    host_capacity_tokens: int = 0
    prefetch_budget_tokens: int = 0
    chips_per_instance: int = 1
    speculative: Optional[Any] = None

    @property
    def device_capacity_tokens(self) -> int:
        return self.capacity_tokens * max(self.chips_per_instance, 1)


def _bucket(n: int) -> int:
    """Next power of two >= n: batches are padded to bucket sizes (the
    reference's retrace bound; kept so padding matches it)."""
    return 1 << max(n - 1, 0).bit_length()


def _check_ported(econf: EngineConfig) -> None:
    unported = {"paged=False": econf.paged is False,
                "host_capacity_tokens>0": econf.host_capacity_tokens > 0,
                "prefetch_budget_tokens>0": econf.prefetch_budget_tokens > 0,
                "speculative": econf.speculative is not None,
                "chips_per_instance>1": econf.chips_per_instance > 1}
    on = [k for k, v in unported.items() if v]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


class Engine:
    def __init__(self, cfg, params, econf: EngineConfig,
                 on_evict: Optional[Callable] = None,
                 device="cuda"):
        _check_ported(econf)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        full_precision_matmuls()
        # the engine serves full attention; SWA only changes semantics
        # beyond max_context
        self.model_cfg = dataclasses.replace(cfg, sliding_window=0)
        self.api = zoo.build(self.model_cfg)
        self.params = tree_to(params, self.device)
        self.econf = econf
        self.fused = econf.fused is None or econf.fused
        self.scheduler = LocalScheduler(
            LocalSchedulerConfig(
                instance_id=econf.instance_id,
                capacity_tokens=econf.device_capacity_tokens,
                chunk_size=econf.chunk_size,
                max_batch_tokens=econf.max_batch_tokens,
                max_batch_requests=econf.max_batch_requests,
                priority_groups=econf.priority_groups,
                fcfs=econf.fcfs),
            on_evict=self._on_evict)
        # external eviction notification (protocol v2): called as
        # cb(instance_id, spans, demoted=[...], host_dropped=[...])
        self._ext_evict = on_evict
        # per-request live state: next input token
        self.live: Dict[int, Dict[str, Any]] = {}
        self.stats = StatsDict(
            {"reused_tokens": 0, "prefilled_tokens": 0,
             "decode_steps": 0, "iterations": 0,
             "decode_batches": 0,
             "seed_aliased_pages": 0, "seed_copied_pages": 0,
             "aborted": 0, "model_dispatches": 0,
             "fused_iterations": 0, "fused_padded_tokens": 0})
        self.telemetry = None
        self.failed = False
        # fault injection: None on fault-free runs (every hook is behind
        # an `is not None` check)
        self.faults = None
        self._init_paged()

    # ================= paged data plane =====================================

    def _init_paged(self) -> None:
        ps = self.econf.page_size
        # slack: one partial tail page and one unaccounted CoW duplicate
        # per live request, + the reserved scratch page that padded
        # lanes write into
        n_pages = (self.econf.device_capacity_tokens // ps
                   + 2 * self.econf.max_batch_requests + 1)
        self.pool = PagedKVPool(n_pages, ps)
        self._scratch_page = self.pool.reserve_page()   # page 0, pinned
        assert self._scratch_page == 0
        self._pages_per_req = -(-self.econf.max_context // ps)
        self.pages = None            # drop the old pool before allocating
        self.pages = self.api.paged_cache_specs(n_pages, ps, self.device)
        # keep node->page aliases aligned with radix node splits
        self.scheduler.tree.split_hooks.append(self._on_split)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one page of every pool leaf (the CoW device copy)."""
        for groups in self.pages.values():
            for kv in groups.values():
                for a in kv.values():
                    a[dst].copy_(a[src])

    # ---- host-side page bookkeeping ----------------------------------------

    def _page_table_rows(self, seq_ids, n_rows: Optional[int] = None
                         ) -> np.ndarray:
        """[n_rows, P] int32 page ids; rows beyond a sequence's pages —
        and whole padding rows — point at the reserved scratch page 0
        (masked by lens on the read side; padded lanes write into it)."""
        n_rows = n_rows if n_rows is not None else len(seq_ids)
        pt = np.zeros((n_rows, self._pages_per_req), np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self.pool.tables[sid].pages
            pt[i, :len(pages)] = pages
        return pt

    def _append_with_cow(self, seq_id, tokens: int) -> None:
        """pool.append + the device half of copy-on-write: when append
        replaces a shared partial tail page with a private one, the old
        page's contents are copied on device — the only copy in the reuse
        path; never for page-aligned reuse boundaries."""
        t = self.pool.tables[seq_id]
        old_tail = t.pages[-1] if t.pages else None
        tail_idx = len(t.pages) - 1
        self.pool.append(seq_id, tokens)
        if old_tail is not None and t.pages[tail_idx] != old_tail:
            self._copy_page(old_tail, t.pages[tail_idx])
            self.stats["seed_copied_pages"] += 1

    def _ensure_free(self, tokens: int, now: float = 0.0) -> None:
        """Reclaim LRU cached nodes (through the scheduler's accounting)
        until the pool fits the reservation: page-granularity
        fragmentation can briefly exceed the token accounting."""
        sch, inst = self.scheduler, self.econf.instance_id
        while self.pool.free_tokens() < tokens:
            plan = sch.tree.plan_eviction(
                inst, tokens - self.pool.free_tokens())
            if not plan:
                raise MemoryError(
                    f"KV pool exhausted: need {tokens} tokens, "
                    f"free {self.pool.free_tokens()}, nothing evictable")
            sch.apply_eviction(plan, now)

    def _on_split(self, head, tail) -> None:
        """RadixTree split hook, path-keyed: the TAIL keeps the pre-split
        key, so the existing ("node", key) table already sits under it;
        the head gets a prefix fork at its new boundary. Pure refcount
        moves, no device traffic."""
        key_t = ("node", tail.path_key)        # the pre-split key
        t = self.pool.tables.get(key_t)
        if t is None:
            return
        d_head = head.depth_tokens()
        d_tail = d_head + len(tail.tokens)
        key_h = ("node", head.path_key)
        if key_h in self.pool.tables:          # digest collision guard
            return
        if t.num_tokens >= d_tail:
            self.pool.fork(key_t, key_h, d_head)
        else:
            # coverage ends inside the head's span: the alias belongs to
            # the head alone
            self.pool.fork(key_t, key_h, min(d_head, t.num_tokens))
            self.pool.release(key_t)

    # ---- eviction hook ------------------------------------------------------

    def _on_evict(self, instance_id: int, spans: List[PrefixSpan], *,
                  demoted: List[PrefixSpan] = (),
                  host_dropped: List[PrefixSpan] = ()) -> None:
        for s in spans:
            self.pool.release(("node", s.key))
        if self._ext_evict is not None:
            self._ext_evict(instance_id, spans, demoted=list(demoted),
                            host_dropped=list(host_dropped))

    # ---- admission ----------------------------------------------------------

    def _admit(self, r: Request, now: float) -> None:
        total = r.prompt_len + r.max_new_tokens
        if total > self.econf.max_context:
            raise AdmissionError(
                f"request {r.request_id}: prompt+max_new = {total} "
                f"exceeds max_context {self.econf.max_context}")
        self._admit_paged(r, now)

    def _admit_paged(self, r: Request, now: float) -> None:
        """Seed a request by ALIASING the matched prefix's pages: fork the
        deepest covering node sequence — refcount increments only, zero
        KV device copies."""
        # node-aligned match: _reserve already split any partially
        # matching node at this prompt's boundary
        m = self.scheduler.tree.match(r.tokens, now=now)
        best_key, best_len, off = None, 0, 0
        for node in m.path:
            off += len(node.tokens)
            t = self.pool.tables.get(("node", node.path_key))
            if t is not None and t.num_tokens >= off:
                best_key, best_len = ("node", node.path_key), off
        # a fully-cached prompt still runs its LAST token through the
        # model: that forward produces the first output token
        reuse = min(best_len, r.prompt_len - 1)
        rid = ("req", r.request_id)
        need = r.prompt_len - reuse + r.max_new_tokens
        # + one page of headroom for the CoW of a shared partial tail
        self._ensure_free(need + self.pool.page_size, now)
        if best_key is not None and reuse > 0:
            self.pool.fork(best_key, rid, reuse)
            self.stats["seed_aliased_pages"] += len(
                self.pool.tables[rid].pages)
        else:
            reuse = 0
            self.pool.create(rid)
        try:
            self._append_with_cow(rid, need)
        except MemoryError:
            self.pool.release(rid)    # don't leak the table
            raise
        # surface the difference between the scheduler's reservation and
        # the aliased length so admission gating sees the true occupancy
        delta = r.device_cached_len - reuse
        if delta:
            self.scheduler.used_tokens = max(
                self.scheduler.used_tokens + delta, 0)
        self.scheduler.set_account(r.request_id, need)
        self.live[r.request_id] = {"next": None}
        r.prefill_done = reuse
        self.stats["reused_tokens"] += reuse

    # ---- post-prefill: publish the prompt's KV to the prefix store ----------

    def _store_prefix(self, r: Request, now: float) -> None:
        """Alias the request's pages per radix node: each node's sequence
        covers the full root->node token path, so a later match can fork
        from the deepest covering node."""
        path = self.scheduler.tree.insert(
            r.tokens, instance=self.econf.instance_id, now=now,
            record=False)
        rid = ("req", r.request_id)
        if rid not in self.pool.tables:
            return
        off = 0
        for node in path:
            off += len(node.tokens)
            key = ("node", node.path_key)
            if key not in self.pool.tables:
                self.pool.fork(rid, key, off)
                self.scheduler.credit_stored(r.request_id, len(node.tokens))

    # ---- the iteration -------------------------------------------------------

    def step(self, now: float) -> List[Request]:
        """Run one continuous-batching iteration; returns finished (and
        aborted) requests. Iterations with prefill work make ONE fused
        dispatch (``_run_mixed``); pure-decode iterations one bucketed
        decode dispatch."""
        batch = self.scheduler.form_batch(now)
        if not batch.items:
            if self.faults is not None \
                    and self.faults.take_crash(self.econf.instance_id):
                raise InstanceCrashed(self.econf.instance_id)
            return []
        self.stats["iterations"] += 1
        aborted = self._admit_new(batch, now)
        if aborted:
            batch.items = [it for it in batch.items
                           if it.request not in aborted]
        # an armed mid-step crash fires after admissions took pool pages,
        # before the model runs
        if self.faults is not None \
                and self.faults.take_crash(self.econf.instance_id):
            raise InstanceCrashed(self.econf.instance_id)
        finished: List[Request] = []
        newly_prefilled: List[Request] = []
        if batch.items:
            has_prefill = any(it.chunk_tokens > 0
                              for it in batch.prefill_items())
            if self.fused and has_prefill:
                newly_prefilled = self._run_mixed(batch)
            else:
                newly_prefilled = self._run_prefills(batch)
                dec = [it.request for it in batch.decode_items()]
                if dec:
                    self._decode_batch_paged(dec)
            finished = self.scheduler.complete_iteration(batch, now)
            for r in newly_prefilled:
                self._store_prefix(r, now)
            for item in batch.items:
                r = item.request
                if item.phase == "decode" and r.output_tokens:
                    r.output_tokens[-1] = self.live[r.request_id]["next"]
            for r in finished:
                self.live.pop(r.request_id, None)
                self.pool.release(("req", r.request_id))
        return finished + aborted

    def _admit_new(self, batch: Batch, now: float) -> List[Request]:
        """Admit this iteration's not-yet-live prefill requests (host-side
        page bookkeeping) and re-clamp every chunk. Unservable requests
        abort without killing the instance."""
        aborted: List[Request] = []
        for item in batch.prefill_items():
            r = item.request
            if r.request_id not in self.live:
                try:
                    self._admit(r, now)
                except (AdmissionError, MemoryError):
                    self.scheduler.abort(r)
                    self.stats["aborted"] += 1
                    aborted.append(r)
                    continue
            self.scheduler.clamp_chunk(item, snapshot_boundary=False)
        return aborted

    def _run_prefills(self, batch: Batch) -> List[Request]:
        """Serial per-request prefill chunks (the unfused baseline): one
        dispatch per chunk."""
        newly_prefilled: List[Request] = []
        for item in batch.prefill_items():
            r = item.request
            start, chunk = r.prefill_done, item.chunk_tokens
            if chunk <= 0:
                continue
            pt = self._page_table_rows([("req", r.request_id)])
            dev = self.device
            toks = torch.tensor(r.tokens[start:start + chunk],
                                dtype=torch.int32, device=dev)
            nxt, self.pages = self.api.extend_paged(
                self.params, self.pages,
                {"tokens": toks[None],
                 "start": torch.tensor([start], dtype=torch.int32,
                                       device=dev),
                 "page_table": torch.from_numpy(pt).to(dev)})
            self.stats["prefilled_tokens"] += chunk
            self.stats["model_dispatches"] += 1
            if start + chunk >= r.prompt_len:
                # prefill emits the FIRST generated token
                tok = int(nxt[0])
                self.live[r.request_id]["next"] = tok
                r.output_tokens.append(tok)
                newly_prefilled.append(r)
        return newly_prefilled

    def _run_mixed(self, batch: Batch) -> List[Request]:
        """Fused ragged iteration: pack every prefill chunk and decode slot
        into ONE dispatch. Chunks fill a [Lc, C] half padded to a common
        bucketed chunk length; decode slots fill a [Ld] single-token half.
        Padding lanes carry all-zero table rows (the scratch page absorbs
        their KV writes)."""
        chunk_items = [it for it in batch.prefill_items()
                       if it.chunk_tokens > 0]
        dec_items = batch.decode_items()
        if not chunk_items and not dec_items:
            return []
        Lc = _bucket(len(chunk_items))
        Cb = _bucket(max([it.chunk_tokens for it in chunk_items] + [1]))
        Ld = _bucket(len(dec_items))
        ctoks = np.zeros((Lc, Cb), np.int32)
        cstart = np.zeros(Lc, np.int32)
        clen = np.zeros(Lc, np.int32)
        for i, it in enumerate(chunk_items):
            r, s, n = it.request, it.request.prefill_done, it.chunk_tokens
            ctoks[i, :n] = r.tokens[s:s + n]
            cstart[i], clen[i] = s, n
        cpt = self._page_table_rows(
            [("req", it.request.request_id) for it in chunk_items],
            n_rows=Lc)
        dtoks = np.zeros(Ld, np.int32)
        dpos = np.zeros(Ld, np.int32)
        for i, it in enumerate(dec_items):
            r = it.request
            dtoks[i] = self.live[r.request_id]["next"]
            dpos[i] = r.prompt_len + len(r.output_tokens) - 1
        dpt = self._page_table_rows(
            [("req", it.request.request_id) for it in dec_items], n_rows=Ld)
        # ONE host-to-device copy of the step's inputs, one dispatch
        fb = ForwardBatch.lower(
            ModelWorkerBatch(ctoks, cstart, clen, cpt, dtoks, dpos, dpt),
            self.device)
        nxt, self.pages = self.api.mixed_paged(
            self.params, self.pages,
            {"chunk_tokens": fb.chunk_tokens, "chunk_start": fb.chunk_start,
             "chunk_len": fb.chunk_len,
             "chunk_page_table": fb.chunk_page_table,
             "dec_tokens": fb.dec_tokens, "dec_pos": fb.dec_pos,
             "dec_page_table": fb.dec_page_table})
        nxt = nxt.cpu().numpy()         # waits for the device
        self.stats["model_dispatches"] += 1
        self.stats["fused_iterations"] += 1
        self.stats["fused_padded_tokens"] += (
            Lc * Cb + Ld - int(clen.sum()) - len(dec_items))
        newly_prefilled: List[Request] = []
        for i, it in enumerate(chunk_items):
            r = it.request
            self.stats["prefilled_tokens"] += it.chunk_tokens
            if r.prefill_done + it.chunk_tokens >= r.prompt_len:
                # prefill emits the FIRST generated token
                tok = int(nxt[i])
                self.live[r.request_id]["next"] = tok
                r.output_tokens.append(tok)
                newly_prefilled.append(r)
        for i, it in enumerate(dec_items):
            self.live[it.request.request_id]["next"] = int(nxt[Lc + i])
        if dec_items:
            self.stats["decode_steps"] += len(dec_items)
            self.stats["decode_batches"] += 1
        return newly_prefilled

    def _decode_batch_paged(self, dec: List[Request]) -> None:
        """Slot/bucket decode: live requests fill the first B lanes of a
        power-of-two bucket; padding lanes write into the scratch page."""
        B = len(dec)
        Bb = _bucket(B)
        tokens = np.zeros(Bb, np.int32)
        pos = np.zeros(Bb, np.int32)
        for i, r in enumerate(dec):
            tokens[i] = self.live[r.request_id]["next"]
            # the fed token sits at context position prompt_len + (#output
            # tokens already cached); the first output is not yet cached
            pos[i] = r.prompt_len + len(r.output_tokens) - 1
        pt = self._page_table_rows(
            [("req", r.request_id) for r in dec], n_rows=Bb)
        wb = ModelWorkerBatch(np.zeros((0, 1), np.int32),
                              np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.zeros((0, self._pages_per_req), np.int32),
                              tokens, pos, pt)
        fb = ForwardBatch.lower(wb, self.device)
        nxt, self.pages = self.api.decode_paged(
            self.params, self.pages,
            {"tokens": fb.dec_tokens, "pos": fb.dec_pos,
             "page_table": fb.dec_page_table})
        nxt = nxt.cpu().numpy()
        for i, r in enumerate(dec):
            self.live[r.request_id]["next"] = int(nxt[i])
        self.stats["decode_steps"] += B
        self.stats["decode_batches"] += 1
        self.stats["model_dispatches"] += 1

    # ---- failure ---------------------------------------------------------------

    def attach_faults(self, faults) -> None:
        """Wire the cluster's shared fault injector into this engine's
        fault points (the reference's circuit breaker guards the host
        tier's restore path, which is not ported)."""
        self.faults = faults

    def attach_telemetry(self, telemetry) -> None:
        """Bind this engine's stats surfaces into the shared telemetry
        registry (engine_* / sched_* series labeled with the instance id)
        and register a callback gauge over the live token accounting."""
        inst = self.econf.instance_id
        self.telemetry = telemetry
        self.stats = telemetry.adopt(self.stats, "engine", instance=inst)
        sch = self.scheduler
        sch.telemetry = telemetry
        sch.stats = telemetry.adopt(sch.stats, "sched", instance=inst)
        telemetry.gauge_fn("sched_used_tokens",
                           lambda s=sch: s.used_tokens, instance=inst)

    def crash(self) -> None:
        """SILENT death: the data plane stops, the scheduler's queues stay
        stranded until the runtime recovers the instance through
        ``fail``."""
        self.failed = True
        self.live.clear()

    def fail(self) -> List[Request]:
        """Instance death: drop all device state, return the in-flight
        requests for global re-scheduling."""
        self.failed = True
        self.live.clear()
        reqs = self.scheduler.drain()
        self._init_paged()      # fresh pool + re-hook the new tree
        return reqs

    @property
    def depth(self) -> int:
        return self.scheduler.depth
