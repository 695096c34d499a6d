"""Per-instance continuous-batching engine (counterpart of the JAX
package's ``serving/engine.py``). Two data planes share the scheduling:

  * PAGED (the default for stacks that are paged-servable) — all KV
    lives in one device-resident page pool per layer
    ([n_pages, page_size, KH, D]); requests address it through page
    tables held by ``serving/kv_cache.py::PagedKVPool``. Prefix reuse is
    ``fork()`` page aliasing with refcounts + copy-on-write: admission
    makes no device KV copy, except one page copy when the reuse
    boundary falls mid-page. Iterations with prefill work run FUSED:
    every ready prefill chunk and every decode slot packed into one
    dispatch (``_run_mixed``). Pure-decode iterations run the bucketed
    decode step (``_decode_batch_paged``), on a card replayed as one CUDA
    graph per bucket where the stack allows (``serving/decode_graph.py``:
    single-card, dense FFNs, no draft model). Radix-tree nodes alias the
    pool through per-node page tables; eviction maps to ``release``.
  * DENSE (``paged=False``, the reference plane) — per-request linear
    caches at ``max_context``. Cached KV slabs are copied into a new
    request's cache (``_seed_attn_kv``), prefill chunks run one
    ``extend`` dispatch each, and batched decode concatenates the live
    caches, runs one ``decode`` dispatch (whose attention is the split-K
    decode kernel on a card) and splits them again — the copies the
    paged plane exists to avoid. A split leaves each request a view of
    the batch cache; only a later concatenation (a copy) or the request's
    own chunks ever write, so no write reaches another request's cache.
    Recurrent and hybrid stacks (RWKV, jamba: ``has_recurrent``) reuse at
    SNAPSHOT granularity: a prefill chunk stops at prompt_len - 1, where
    the whole cache image (recurrent states, the first prompt_len - 1
    positions of every attention KV buffer, cross KV) is cloned into
    ``state_store`` (``_snapshot_full_cache``); a later prompt that
    starts with a stored key gets a copy of its image
    (``_seed_snapshot``) and prefills only the rest. Copies both ways:
    the live caches are written in place, and a stored image aliased
    into one would change under it. As in the reference, nothing evicts
    ``state_store``. The VLM's cross KV stays zero (the engine passes no
    vision tokens, as the reference's). An encoder-decoder stack has no
    chunk extension, so no engine serves it (ValueError).

With ``host_capacity_tokens > 0`` the pool grows a second tier:
eviction DEMOTES node KV to host RAM (``serving/kv_offload.py``) instead
of dropping it, and a later prefix hit RESTORES it into fresh pages
instead of recomputing the prefill. ``prefetch_budget_tokens > 0`` adds
speculative restore: waiting requests' host chains are scattered into
node pages ahead of their admission. ``speculative`` attaches a draft
model (``serving/speculative.py``) whose K proposals per decode slot are
verified inside the same single fused target dispatch.

The model runs eagerly in PyTorch on ``device`` ("cuda" unless the
caller asks for "cpu"); pool tensors are updated in place. Batches keep
the reference's power-of-two buckets (``batch.bucket``), so padding lanes
and ``fused_padded_tokens`` match the JAX engine exactly; host-tier
copies are not bucketed (they hold exactly the pages or tokens moved).

Streams (CUDA engines). The model, the CoW page copies, the demote
gathers and the admission-restore scatters run on the compute stream
(the current stream), in the order the reference dispatches them, so
every read sees the writes dispatched before it. Two kinds of copy run
on the engine's own ``copy_stream``, which first waits on the compute
stream: a demote's device-to-host copy (``PagedHostTier``), and a
prefetch's host-to-device copy and page scatter, which writes only pages
freshly appended to its ("pf", id) table; the compute stream waits on
that scatter's event in ``_drain_prefetches``, before any later step can
read the pages. Host data crosses in pinned buffers with
``non_blocking=True``; the host blocks only where the reference reads
bytes (a demote's drain, a step's predictions).

Tensor-parallel instances (``chips_per_instance > 1``, the paged fused
plane only): the engine drives one serve submesh (``launch/mesh.py``),
single-controller like the reference's. Its parameters are sharded by
``serve_policy`` and its pool by ``pool_pspec`` (``launch/sharding.py``:
one tree per shard, each on its shard's device); the radix tree, page
tables and scheduling stay on the host, once. Each step still makes ONE
model dispatch, which loops over the shards inside. Capacity is
``capacity_tokens`` per chip: the pool holds ``capacity_tokens * chips``
tokens, each shard a 1/chips slice of every page. Page copies, demote
gathers and restore scatters run on every shard, each shard moving its
own slice over its own copy; a TP engine runs them on each device's
compute stream. ``shard_dma_seconds`` accumulates the host wall of the
per-shard copies (the step's batch lowering, restore and prefetch
scatters, the demote landing), ``collective_seconds`` the wall blocked
on the sharded dispatch's result; both stay 0.0 on a single-chip
engine. With ``device="cpu"`` the shards are emulated on the CPU; on
CUDA the first visible cards are taken, and too few raise unless an
explicit ``devices`` list (which may repeat a card) is passed.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import full_precision_matmuls
from ..bridge import tree_to
from ..core.local_scheduler import Batch, LocalScheduler, LocalSchedulerConfig
from ..core.radix_tree import PathKey, PrefixSpan
from ..core.request import Request
from ..launch import sharding as shard_lib
from ..launch.mesh import make_serve_mesh
from ..models import layers, zoo
from ..models.transformer import layer_plan
from . import decode_graph
from .batch import ForwardBatch, ModelWorkerBatch, bucket, lower_arrays
from .faults import CircuitBreaker, InstanceCrashed
from .kv_cache import PagedKVPool
from .kv_offload import (CopyLog, HostKVStore, PagedHostTier, host_numpy,
                         tree_concat, tree_leaves)
from .speculative import DraftWorker, SpeculativeConfig
from .telemetry import StatsDict, frac_of

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
    # None: paged when the stack is paged-servable, dense otherwise;
    # True forces paged (raises if the stack cannot be paged-served);
    # False forces the dense reference plane
    paged: Optional[bool] = None
    # None/True: fused ragged iterations on the paged plane; False: the
    # per-request prefill loop, kept as the fused plane's comparison
    # baseline
    fused: Optional[bool] = None
    # host-offload tier budget in tokens. 0 disables the tier (eviction
    # drops KV); >0: eviction demotes node KV to host RAM and a later
    # prefix hit restores it into fresh pages instead of recomputing
    host_capacity_tokens: int = 0
    # speculative-restore budget (requires the host tier). >0: waiting
    # requests' host chains are scattered into node pages ahead of their
    # admission, so admission aliases them and restores nothing
    prefetch_budget_tokens: int = 0
    # >1 makes the engine a tensor-parallel submesh (paged plane only):
    # params sharded by serve_policy, the pool by pool_pspec.
    # ``capacity_tokens`` stays PER CHIP: the pooled device KV capacity
    # is capacity_tokens * chips
    chips_per_instance: int = 1
    # draft-model speculative decoding (requires the fused plane). None
    # disables it; a SpeculativeConfig turns every decode slot with >= 2
    # tokens of headroom into a K+1-token verify chunk inside the same
    # single fused dispatch, with greedy-exact outputs
    speculative: Optional[SpeculativeConfig] = None

    @property
    def device_capacity_tokens(self) -> int:
        return self.capacity_tokens * max(self.chips_per_instance, 1)


def _check_planes(econf: EngineConfig, paged: bool) -> None:
    """The reference's plane checks (ValueError); ``paged``: the plane
    chosen."""
    fused = paged and (econf.fused is None or econf.fused)
    if econf.fused and not paged:
        raise ValueError("fused ragged iterations require the paged data "
                         "plane")
    if econf.host_capacity_tokens > 0 and not paged:
        raise ValueError("the host-offload KV tier requires the paged data "
                         "plane (dense state is not pageable)")
    if econf.prefetch_budget_tokens > 0 and econf.host_capacity_tokens <= 0:
        raise ValueError("speculative restore prefetches HOST-tier spans: "
                         "set host_capacity_tokens > 0")
    if econf.speculative is not None and not fused:
        raise ValueError("speculative decoding rides the fused mixed "
                         "dispatch: it requires the paged fused plane")
    if econf.chips_per_instance > 1 and not paged:
        raise ValueError("tensor-parallel serving (chips_per_instance "
                         "> 1) requires the paged data plane")


def _cache_zeros(specs: Pytree, device) -> Pytree:
    return {pj: {n: torch.zeros(s.shape, dtype=s.dtype, device=device)
                 for n, s in c.items()} for pj, c in specs.items()}


def _cache_concat(caches: List[Pytree]) -> Pytree:
    """The batch cache: the requests' [G, 1, ...] leaves (k / v, ck / cv,
    recurrent states) joined on the batch axis (a copy)."""
    return {pj: {n: torch.cat([c[pj][n] for c in caches], dim=1)
                 for n in leaves} for pj, leaves in caches[0].items()}


def _cache_index(cache: Pytree, i: int) -> Pytree:
    """Request i's views [G, 1, ...] of every leaf of a batch cache."""
    return {pj: {n: a[:, i:i + 1] for n, a in c.items()}
            for pj, c in cache.items()}


def _write_slab(dst: torch.Tensor, slab: torch.Tensor, off: int) -> None:
    """dst[:, :, off:off + len] = slab along the sequence axis, the
    offset moved back into range as the reference's dynamic_update_slice
    moves it (a node's slab stored before a split of that node is longer
    than the node)."""
    n = slab.shape[2]
    off = max(0, min(off, dst.shape[2] - n))
    dst[:, :, off:off + n] = slab


class Engine:
    def __init__(self, cfg, params, econf: EngineConfig,
                 on_evict: Optional[Callable] = None,
                 device="cuda", devices: Optional[Sequence] = None):
        """``device``: where the engine runs ("cuda" unless the caller
        asks for "cpu"). ``devices``: the submesh's devices of a
        tensor-parallel engine (the cluster hands each instance its
        group; a list may repeat a device); by default the first
        ``chips_per_instance`` visible cards, or CPU shards when
        ``device`` is the CPU."""
        # the engine serves full attention; SWA only changes semantics
        # beyond max_context
        self.model_cfg = dataclasses.replace(cfg, sliding_window=0)
        self.api = zoo.build(self.model_cfg)
        if self.api.extend is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder stack has no "
                             "chunk extension; no engine serves it")
        self.has_recurrent = any(
            p.mixer in ("mamba", "rwkv")
            for p in layer_plan(self.model_cfg))
        self.paged = (econf.paged if econf.paged is not None
                      else self.api.decode_paged is not None)
        if self.paged and self.api.decode_paged is None:
            raise ValueError(f"{cfg.name} is not paged-servable "
                             "(recurrent/cross/encdec positions)")
        _check_planes(econf, self.paged)
        self.device = torch.device(devices[0] if devices else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        # the serve submesh: None on a single-chip engine, which takes
        # the unsharded path throughout
        self.chips = max(econf.chips_per_instance, 1)
        self.mesh = None
        self.plan: Optional[shard_lib.ShardPlan] = None
        if self.chips > 1:
            self.mesh = make_serve_mesh(self.chips, devices,
                                        platform=self.device.type)
            self.device = self.mesh.devices[0]
        # host<->device copies beside the compute stream (module doc); a
        # tensor-parallel engine copies on each device's compute stream
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda"
                            and self.mesh is None else None)
        # host<->device copy timing: None until attach_copy_log()
        self.copy_log: Optional[CopyLog] = None
        full_precision_matmuls()
        if self.mesh is None:
            self.params = tree_to(params, self.device)
        else:
            # one tree per shard; the whole tensors are not kept
            self.params = shard_lib.shard_params(
                params, self.api.specs, self.mesh,
                shard_lib.serve_policy(self.mesh, self.api.n_bytes))
        self.econf = econf
        self.fused = self.paged and (econf.fused is None or econf.fused)
        self.scheduler = LocalScheduler(
            LocalSchedulerConfig(
                instance_id=econf.instance_id,
                capacity_tokens=econf.device_capacity_tokens,
                chunk_size=econf.chunk_size,
                max_batch_tokens=econf.max_batch_tokens,
                max_batch_requests=econf.max_batch_requests,
                priority_groups=econf.priority_groups,
                fcfs=econf.fcfs,
                host_capacity_tokens=econf.host_capacity_tokens,
                prefetch_budget_tokens=econf.prefetch_budget_tokens,
                spec_verify_tokens=(econf.speculative.k
                                    if econf.speculative is not None
                                    else 0)),
            on_evict=self._on_evict)
        # external eviction notification (protocol v2): called as
        # cb(instance_id, spans, demoted=[...], host_dropped=[...])
        self._ext_evict = on_evict
        # per-request live state: next input token (+ cache when dense)
        self.live: Dict[int, Dict[str, Any]] = {}
        # the *_overlap_frac and acceptance ratios are DERIVED at read
        # time; spec_draft_dispatches counts the draft's propose
        # dispatches and never touches model_dispatches, which stays one
        # target dispatch per iteration
        self.stats = StatsDict(
            {"reused_tokens": 0, "prefilled_tokens": 0,
             "decode_steps": 0, "iterations": 0,
             "decode_batches": 0, "cache_concat_calls": 0,
             "seed_aliased_pages": 0, "seed_copied_pages": 0,
             "aborted": 0, "model_dispatches": 0,
             "fused_iterations": 0, "fused_padded_tokens": 0,
             "fused_slot_tokens": 0,
             "demoted_tokens": 0, "restored_tokens": 0,
             "restore_failures": 0, "demote_dispatches": 0,
             "restore_dispatches": 0, "demote_batches": 0,
             "demote_batches_overlapped": 0,
             "prefetch_issued": 0, "prefetch_hit": 0,
             "prefetch_wasted": 0, "prefetch_dispatches": 0,
             "prefetch_batches": 0,
             "prefetch_batches_overlapped": 0,
             "spec_proposed_tokens": 0, "spec_accepted_tokens": 0,
             "spec_rejected_tokens": 0, "spec_verify_lanes": 0,
             "spec_draft_dispatches": 0, "spec_degraded": 0,
             # pure-decode dispatches replayed as a CUDA graph, and the
             # graphs captured (serving/decode_graph.py)
             "decode_graph_replays": 0, "decode_graph_captures": 0,
             # tensor-parallel engines only (module doc)
             "shard_dma_seconds": 0.0, "collective_seconds": 0.0},
            derived={"demote_overlap_frac":
                     frac_of("demote_batches_overlapped",
                             "demote_batches"),
                     "prefetch_overlap_frac":
                     frac_of("prefetch_batches_overlapped",
                             "prefetch_batches"),
                     "spec_acceptance_frac":
                     frac_of("spec_accepted_tokens",
                             "spec_proposed_tokens")})
        self.telemetry = None
        self.failed = False
        # fault injection: None on fault-free runs (every hook is behind
        # an `is not None` check)
        self.faults = None
        self._cb: Optional[CircuitBreaker] = None
        self.host_store: Optional[HostKVStore] = None
        # the draft plane: None on non-speculative engines
        self.draft: Optional[DraftWorker] = None
        # restores staged by admissions, flushed once per step
        self._pending_restore: List[Tuple[np.ndarray, np.ndarray, Any]] = []
        # speculative restores in flight this step: (record,
        # model_dispatches at issue); their scatter was issued, the
        # bookkeeping lands at _drain_prefetches after the model runs
        self._prefetch_inflight: List[Tuple[dict, int]] = []
        # the copy stream's event of this step's prefetch scatter
        self._prefetch_event = None
        # the pure-decode CUDA graphs: None where steps stay eager
        self._graphs: Optional[decode_graph.DecodeGraphs] = None
        if self.paged:
            self._init_paged()
            if decode_graph.eligible(self):
                self._graphs = decode_graph.DecodeGraphs(self)
                self._graphs.capture()
        else:
            self._init_dense()

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
        if self.copy_stream is not None:
            # a prefetch scatter may still be writing the old pool
            self.copy_stream.synchronize()
        self.pages = None            # drop the old pool before allocating
        if self._graphs is not None:
            self._graphs.drop()      # they hold the old pool's addresses
        self.draft = None
        if self.mesh is not None:
            self.plan = self.api.shard_plan(self.mesh, n_pages, ps)
        self.pages = self.api.paged_cache_specs(n_pages, ps, self.device,
                                                self.plan)
        shards = self.pages if self.plan is not None else [self.pages]
        self._shard_leaves = [[a for _, a in tree_leaves(p)]
                              for p in shards]
        self.leaf_paths = [p for p, _ in tree_leaves(shards[0])]
        self._leaves = self._shard_leaves[0]
        # the draft model's own paged plane, rebuilt with the pool
        if self.econf.speculative is not None:
            self.draft = DraftWorker(self.econf.speculative, self.econf,
                                     self.device, mesh=self.mesh)
        # keep node->page aliases aligned with radix node splits
        self.scheduler.tree.split_hooks.append(self._on_split)
        # the host tier: the scheduler owns demote/drop policy,
        # PagedHostTier moves the bytes, the store holds them
        self._pending_restore = []
        self._prefetch_inflight = []
        self._prefetch_event = None
        if self.econf.host_capacity_tokens > 0:
            self.host_store = HostKVStore()
            self.scheduler.host_tier = PagedHostTier(self, self.host_store)
            self.scheduler.tree.split_hooks.append(self._on_split_host)
        else:
            self.host_store = None

    # ================= dense data plane =====================================

    def _init_dense(self) -> None:
        """The pool only accounts tokens (no KV lives in it); cached
        prefixes are KV slabs in ``kv_store``, and each request gets a
        linear cache at max_context."""
        self.pool = PagedKVPool(
            self.econf.capacity_tokens // self.econf.page_size,
            self.econf.page_size)
        # node path key -> {p_j: {"k","v": [G, 1, span, KH, D]}}
        self.kv_store: Dict[PathKey, Pytree] = {}
        # exact prompt prefix -> whole cache image at its length
        # (recurrent stacks; never evicted, as in the reference)
        self.state_store: Dict[Tuple[int, ...], Pytree] = {}
        self._cache_spec = self.api.cache_specs(1, self.econf.max_context)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one page of every pool leaf (the CoW device copy): on
        every shard its slice of the page; a page-wise pool copies from
        the page's owner to the copy's owner."""
        if self.plan is not None and self.plan.pool == "page":
            n = self.plan.pages_per_shard
            for a, b in zip(self._shard_leaves[src // n],
                            self._shard_leaves[dst // n]):
                b[dst % n].copy_(a[src % n])
            return
        for leaves in self._shard_leaves:
            for a in leaves:
                a[dst].copy_(a[src])

    # ---- tensor-parallel instances: host/device boundary -------------------

    def _lower(self, arrays, out: Optional[torch.Tensor] = None):
        """int32 host arrays -> tensors on shard 0's device in one copy
        (into ``out`` when given); on a submesh timed into
        ``shard_dma_seconds`` (each shard reads the batch there or gets
        its copy inside the dispatch)."""
        if self.mesh is None:
            return lower_arrays(arrays, self.device, out)
        t0 = time.perf_counter()
        out = lower_arrays(arrays, self.device)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.stats["shard_dma_seconds"] += time.perf_counter() - t0
        return out

    def _fetch(self, *ts: torch.Tensor) -> np.ndarray:
        """The dispatch's predictions on the host, in one copy (it waits
        for the device); on a submesh timed into ``collective_seconds``
        (blocked on the sharded dispatch and its cross-shard result)."""
        t0 = time.perf_counter()
        out = (torch.cat([t.reshape(-1) for t in ts]) if len(ts) > 1
               else ts[0]).cpu().numpy()
        if self.mesh is not None:
            self.stats["collective_seconds"] += time.perf_counter() - t0
        if self.telemetry is not None:
            self.telemetry.span("engine.fetch", t0)
        return out

    def _route(self, s: int, pidx: np.ndarray, sidx: np.ndarray):
        """Shard s's share of tokens at (page pidx, slot sidx): (host
        selection, local pages, local slots). Head-wise and replicated
        pools take every token (the head-wise one only its kv heads of
        each), slot-wise the slots it owns, page-wise the pages."""
        plan = self.plan
        if plan.pool == "slot":
            sel = sidx // plan.slot_size == s
            return sel, pidx[sel], sidx[sel] % plan.slot_size
        if plan.pool == "page":
            n = plan.pages_per_shard
            sel = pidx // n == s
            return sel, pidx[sel] % n, sidx[sel]
        return np.ones(len(pidx), bool), pidx, sidx

    def _kv_heads(self, s: int) -> slice:
        """Shard s's kv heads of a host span [..., KH, D], as
        ``span_pspec`` splits it."""
        cfg = self.api.cfg
        if "model" not in shard_lib.span_pspec(
                (1, cfg.n_kv_heads, cfg.head_dim), self.mesh):
            return slice(None)
        n = cfg.n_kv_heads // self.plan.tp
        return slice(s * n, (s + 1) * n)

    @property
    def shard_axis(self) -> int:
        """The axis of a gathered demote [n_leaves, n, PS, KH, D] that the
        shards' pieces concatenate along (head- or slot-wise pools)."""
        return {"head": 3, "slot": 2}.get(self.plan.pool, 0)

    # ---- host tier: device-side gathers and scatters ---------------------

    def gather_pages_device(self, page_ids: List[int]):
        """Demote-side snapshot: ONE gather over an entire eviction
        plan's pages, of every pool leaf, into a FRESH device tensor
        [n_leaves, n, PS, KH, D] on the compute stream. The host tier
        copies it to the host at once, on the copy stream. Unlike the
        reference, which pads to a power-of-two bucket so jit sees few
        shapes, the gather holds exactly the plan's pages: eager PyTorch
        compiles nothing, and padding would only cross the host link.

        A tensor-parallel engine returns a list: each shard's own slice
        of the pages (head- or slot-wise pools; the host tier copies each
        and joins them along ``shard_axis``), or one tensor on shard 0's
        device gathered from the pages' owners (page-wise) or from shard
        0 (replicated)."""
        self.stats["demote_dispatches"] += 1
        ids = np.asarray(page_ids, np.int32)
        if self.plan is None:
            return self._gather(self._leaves, ids, self.device)
        if self.plan.pool in ("head", "slot"):
            return [self._gather(leaves, ids, d) for leaves, d in
                    zip(self._shard_leaves, self.mesh.devices)]
        if self.plan.pool == "rep":
            return [self._gather(self._leaves, ids, self.device)]
        a0 = self._leaves[0]
        out = torch.empty((len(self._leaves), len(ids))
                          + a0.shape[1:], dtype=a0.dtype,
                          device=self.device)
        for s, leaves in enumerate(self._shard_leaves):
            sel, local, _ = self._route(s, ids, np.zeros_like(ids))
            if sel.any():
                part = self._gather(leaves, local, self.mesh.devices[s])
                out[:, torch.from_numpy(np.flatnonzero(sel)).to(
                    self.device)] = part.to(self.device)
        return [out]

    def _gather(self, leaves, ids: np.ndarray, device) -> torch.Tensor:
        """index_select of pages ``ids`` from every leaf into one fresh
        tensor [n_leaves, n, ...] on ``device``."""
        idx = lower_arrays((ids,), device)[0]
        a0 = leaves[0]
        out = torch.empty((len(leaves), len(ids)) + a0.shape[1:],
                          dtype=a0.dtype, device=device)
        for i, a in enumerate(leaves):
            torch.index_select(a, 0, idx, out=out[i])
        return out

    def _drain_demotes(self) -> None:
        """Land pending demote bytes host-side (end of step, or forced
        by a read that needs the store complete)."""
        ht = self.scheduler.host_tier
        if ht is not None:
            ht.drain()
        if self.copy_log is not None:
            self.copy_log.fold()

    def _host_entry(self, key):
        """Store lookup that only forces the pending demote copy to land
        when THIS entry is still in flight — ordinary misses (never-
        demoted nodes) must not break the demote/compute overlap."""
        e = self.host_store.get(key)
        if e is None:
            ht = self.scheduler.host_tier
            if ht is not None and ht.pending_has(key):
                ht.drain()
                e = self.host_store.get(key)
        return e

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

    def _on_split_host(self, head, tail) -> None:
        """Split hook for the host tier: a demoted span crossing the
        new node boundary is split between head and tail entries. If
        that span's demote copy is still in flight, land it first —
        otherwise the store would miss the split the scheduler's LRU
        already applied and the two tiers diverge permanently."""
        if self.host_store is not None:
            ht = self.scheduler.host_tier
            # at hook time tail.path_key IS the pre-split key
            if ht is not None and ht.pending_has(tail.path_key):
                ht.drain()
            self.host_store.on_split(head, tail)

    # ---- eviction hook ------------------------------------------------------

    def _on_evict(self, instance_id: int, spans: List[PrefixSpan], *,
                  demoted: List[PrefixSpan] = (),
                  host_dropped: List[PrefixSpan] = ()) -> None:
        if self.paged:
            # demote_many already released the tables of spans it saw,
            # but the scheduler may skip spans entirely (one-shot under
            # host pressure): release unconditionally — a second release
            # is a no-op, a leaked table would pin its pages forever
            for s in spans:
                self.pool.release(("node", s.key))
        else:
            for s in spans:
                self.kv_store.pop(s.key, None)
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
        if self.paged:
            self._admit_paged(r, now)
        else:
            self._admit_dense(r, now)

    def _admit_paged(self, r: Request, now: float) -> None:
        """Seed a request by ALIASING the matched prefix's pages: fork the
        deepest covering node sequence — refcount increments only, zero
        KV device copies. With the host tier, the reusable prefix may
        extend past the aliased part through demoted spans: those are
        RESTORED — fresh pages are allocated and the host KV is staged
        for one batched scatter this step — instead of recomputed."""
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
        # host-tier restore plan: demoted spans contiguously extending
        # the aliased prefix (planned BEFORE _ensure_free, revalidated
        # after — freeing room can cascade into host-capacity drops).
        # An OPEN circuit breaker disables restore planning for its
        # cooldown: the request recomputes the demoted span
        restore_plan: List[Tuple[PathKey, int, int, int]] = []
        if self.host_store is not None and best_len == reuse \
                and (self._cb is None or self._cb.allow(now)):
            restore_plan, _ = self._host_restore_chain(
                m, reuse, r.prompt_len - 1)
        rid = ("req", r.request_id)
        need = r.prompt_len - reuse + r.max_new_tokens
        # + one page of headroom for the CoW of a shared partial tail
        self._ensure_free(need + self.pool.page_size, now)
        restore_end = reuse
        for key, nid, lo, hi in restore_plan:
            if self.faults is not None and self.faults.dma_fails("restore"):
                # injected host->device copy failure: recompute the rest
                # of the chain; the breaker opens after repeated hits
                self.stats["restore_failures"] += 1
                if self._cb is not None:
                    self._cb.record_failure(now)
                break
            e = self._host_entry(key)
            if (e is None or e.node_id != nid
                    or e.start > lo or e.start + e.length < hi):
                # host entry evicted mid-flight (demote cascade of
                # _ensure_free overflowed the host budget) or rekeyed
                # under a collided digest: recompute the rest
                self.stats["restore_failures"] += 1
                break
            restore_end = hi
        if self._cb is not None and restore_end > reuse:
            self._cb.record_success()
        restore_plan = [(key, nid, lo, min(hi, restore_end))
                        for key, nid, lo, hi in restore_plan
                        if lo < restore_end]
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
        if restore_end > reuse:
            self._stage_restore(r, rid, reuse, restore_end, restore_plan)
        # surface the difference between the scheduler's reservation and
        # the aliased length so admission gating sees the true occupancy
        # (restored tokens occupy fresh pages: only the ALIASED length
        # offsets the reservation)
        delta = r.device_cached_len - reuse
        if delta:
            self.scheduler.used_tokens = max(
                self.scheduler.used_tokens + delta, 0)
        self.scheduler.set_account(r.request_id, need)
        self.live[r.request_id] = {"next": None}
        r.prefill_done = restore_end
        self.stats["reused_tokens"] += restore_end

    def _admit_dense(self, r: Request, now: float) -> None:
        """DENSE reference: a fresh linear cache seeded with copies of
        the matched path's cached KV slabs, or (recurrent stacks) of the
        longest stored snapshot the prompt starts with."""
        cache = _cache_zeros(self._cache_spec, self.device)
        m = self.scheduler.tree.match(r.tokens, now=now)
        reuse = 0
        if m.matched_len:
            reuse = (self._seed_snapshot(cache, r.tokens, m.matched_len)
                     if self.has_recurrent else self._seed_attn_kv(cache, m))
        reuse = min(reuse, r.prompt_len - 1)
        if self.pool.free_tokens() >= (r.prompt_len - reuse
                                       + r.max_new_tokens):
            self.pool.create(r.request_id)
            self.pool.append(r.request_id,
                             r.prompt_len - reuse + r.max_new_tokens)
        # the prompt's part moves to the prefix store when
        # _store_prefix publishes its slabs (credit_stored); a recurrent
        # stack publishes no slab, its tree nodes stay marked and
        # eviction refunds them, so only the outputs are its own
        self.scheduler.set_account(
            r.request_id,
            r.max_new_tokens if self.has_recurrent
            else max(r.prompt_len - r.device_cached_len, 0)
            + r.max_new_tokens)
        self.live[r.request_id] = {"cache": cache, "next": None}
        r.prefill_done = reuse
        self.stats["reused_tokens"] += reuse

    def _seed_attn_kv(self, cache: Pytree, m) -> int:
        """DENSE reference: copy the cached KV slabs of the matched path
        into cache[:reuse] (the copies the paged plane exists to avoid),
        the partial tail inside the next node included."""
        off = 0
        for node in m.path:
            slab = self.kv_store.get(node.path_key)
            if slab is None:
                break
            for pj, c in slab.items():
                for name in ("k", "v"):
                    _write_slab(cache[pj][name], c[name], off)
            off += len(node.tokens)
        if off < m.matched_len and m.last_node is not None \
                and m.last_node_matched < len(m.last_node.tokens):
            slab = self.kv_store.get(m.last_node.path_key)
            if slab is not None:
                take = m.last_node_matched
                for pj, c in slab.items():
                    for name in ("k", "v"):
                        _write_slab(cache[pj][name], c[name][:, :, :take],
                                    off)
                off += take
        return off

    def _seed_snapshot(self, cache: Pytree, tokens, matched_len: int) -> int:
        """Recurrent stacks: copy into ``cache`` the image of the longest
        stored key (of length L <= matched_len) this prompt starts with:
        whole leaves, and k / v slabs [G, 1, L, KH, D] at [0:L]. Returns
        L (0 when none)."""
        best_len, best = 0, None
        for key, snap in self.state_store.items():
            L = len(key)
            if best_len < L <= matched_len and tuple(tokens[:L]) == key:
                best_len, best = L, snap
        if best is None:
            return 0
        for pj, c in cache.items():
            for name, arr in best[pj].items():
                c[name][tuple(slice(0, n) for n in arr.shape)].copy_(arr)
        return best_len

    def _snapshot_full_cache(self, r: Request, boundary: int) -> None:
        """Clone the request's cache after ``boundary`` consumed tokens
        (mid-prefill at prompt_len - 1, so an identical prompt later
        reuses all but its last token): k / v cut to [0:boundary], every
        other leaf whole."""
        key = tuple(r.tokens[:boundary])
        if key in self.state_store:
            return
        self.state_store[key] = {
            pj: {n: (a[:, :, :boundary] if n in ("k", "v") else a).clone()
                 for n, a in c.items()}
            for pj, c in self.live[r.request_id]["cache"].items()}

    def _host_restore_chain(self, m, boundary: int, limit: int
                            ) -> Tuple[List[Tuple[PathKey, int, int, int]],
                                       int]:
        """Walk the match path past the device-aliased ``boundary`` and
        chain host entries that contiguously extend it, stopping at the
        first hole or ``limit`` (= prompt_len - 1, the reuse cap).
        Entries resolve by path key with node-ownership verification;
        an entry whose demote copy is still in flight forces a targeted
        drain. Returns ([(key, node_id, lo, hi)], new_boundary) in
        absolute token depths."""
        plan: List[Tuple[PathKey, int, int, int]] = []
        cum = 0
        for node in m.path:
            node_start = cum
            cum += len(node.tokens)
            if cum <= boundary:
                continue
            if node_start != boundary or boundary >= limit:
                break
            e = self._host_entry(node.path_key)
            if e is None or e.node_id != node.node_id \
                    or e.start != node_start:
                break
            take = min(e.length, limit - boundary)
            if take <= 0:
                break
            plan.append((node.path_key, node.node_id, node_start,
                         node_start + take))
            boundary = node_start + take
            if boundary < cum:        # partial span ends the chain
                break
        return plan, boundary

    def _stage_restore(self, r: Request, rid, lo: int, hi: int,
                       plan: List[Tuple[PathKey, int, int, int]]) -> None:
        """Stage the host->device scatter for tokens [lo, hi) of the
        request's sequence: map each restored token onto its (page,
        slot) in the request's freshly appended table and queue the
        host KV; ``_flush_restores`` runs ONE scatter per step for all
        admissions."""
        pidx, sidx = self._token_page_slots(self.pool.tables[rid],
                                            self.pool.page_size, lo, hi)
        data = tree_concat([self.host_store.read_span(key, nid, a, b)
                            for key, nid, a, b in plan])
        self._pending_restore.append((pidx, sidx, data))
        for key, _, _, _ in plan:
            self.scheduler.touch_host(key)
        self.stats["restored_tokens"] += hi - lo

    def _scatter_staged(self, staged: List[Tuple], side: bool = False):
        """ONE (page, slot) scatter of every pool leaf for a list of
        staged (pidx, sidx, data) triples — shared by the admission-
        restore flush and the prefetch path. The host data is packed
        into one pinned buffer [n_leaves, n, KH, D] (exactly the staged
        tokens: no bucket padding, see ``gather_pages_device``) and
        copied in one ``non_blocking`` copy. ``side=False``: copy and
        scatter on the compute stream, so this step's model dispatch
        sees the KV in stream order. ``side=True``: on the copy stream,
        after the compute stream's work so far; returns the scatter's
        event (None on a CPU engine)."""
        pidx = np.concatenate([s[0] for s in staged])
        sidx = np.concatenate([s[1] for s in staged])
        a0 = self._leaves[0]
        cuda = self.device.type == "cuda"
        # a tensor-parallel engine pins each shard's share instead
        host = torch.empty((len(self._leaves), len(pidx)) + a0.shape[2:],
                           dtype=a0.dtype,
                           pin_memory=cuda and self.plan is None)
        hnp = host_numpy(host)
        cols = zip(*[[x for _, x in tree_leaves(s[2])] for s in staged])
        for i, col in enumerate(cols):
            np.concatenate(col, axis=0, out=hnp[i])
        if self.plan is not None:
            self._scatter_shards(host, pidx, sidx)
            return None
        if not cuda:
            self._scatter_pages(host, torch.from_numpy(pidx).long(),
                                torch.from_numpy(sidx).long())
            return None
        compute = torch.cuda.current_stream(self.device)
        stream = self.copy_stream if side else compute
        if side:
            stream.wait_stream(compute)
        log = self.copy_log
        with torch.cuda.stream(stream):
            ev0 = log.start(stream) if log is not None else None
            dev = host.to(self.device, non_blocking=True)
            if log is not None:
                log.stop("h2d", host.nbytes, ev0, stream)
            pi, si = lower_arrays((pidx, sidx), self.device)
            self._scatter_pages(dev, pi.long(), si.long())
            if not side:
                return None
            ev = torch.cuda.Event()
            ev.record(stream)
            return ev

    def _scatter_pages(self, data: torch.Tensor, pi: torch.Tensor,
                       si: torch.Tensor, leaves=None) -> None:
        """Write data[l, t] into leaf l at (page pi[t], slot si[t])."""
        for a, d in zip(self._leaves if leaves is None else leaves, data):
            a.index_put_((pi, si), d)

    def _scatter_shards(self, host: torch.Tensor, pidx: np.ndarray,
                        sidx: np.ndarray) -> None:
        """A tensor-parallel engine's (page, slot) scatter of a host span
        [n_leaves, n, KH, D]: each shard receives its own share
        (``_route``: its kv heads, or the tokens of its slots or pages)
        in one copy on its device's compute stream, and scatters it into
        its leaves at their local coordinates. The copies' wall (the
        host waits for them) goes to ``shard_dma_seconds``."""
        t0 = time.perf_counter()
        used = []
        for s, dev in enumerate(self.mesh.devices):
            sel, lp, ls = self._route(s, pidx, sidx)
            if not len(lp):
                continue
            part = host[:, torch.from_numpy(sel)][..., self._kv_heads(s),
                                                  :].contiguous()
            if dev.type == "cuda":
                part = part.pin_memory()
                used.append(dev)
            data = part.to(dev, non_blocking=True)
            pi, si = lower_arrays((lp, ls), dev)
            self._scatter_pages(data, pi.long(), si.long(),
                                self._shard_leaves[s])
        for dev in used:
            torch.cuda.current_stream(dev).synchronize()
        self.stats["shard_dma_seconds"] += time.perf_counter() - t0

    @staticmethod
    def _token_page_slots(table, page_size: int, lo: int, hi: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(page, slot) coordinates of tokens [lo, hi) in a table."""
        toks = np.arange(lo, hi)
        pages_arr = np.asarray(table.pages, np.int32)
        return pages_arr[toks // page_size], (toks % page_size).astype(
            np.int32)

    def _flush_restores(self) -> None:
        """Apply every restore staged by this step's admissions as ONE
        scatter on the compute stream, ahead of the model."""
        staged, self._pending_restore = self._pending_restore, []
        if not staged:
            return
        self._scatter_staged(staged)
        self.stats["restore_dispatches"] += 1

    # ---- speculative restore: the prefetch stream --------------------------

    def _issue_prefetches(self, now: float) -> None:
        """Ask the scheduler's prefetch queue for work, stage each
        record's host bytes onto fresh pages, and issue ONE batched
        (page, slot) scatter for all of them on the copy stream — issued
        BEFORE the step's model dispatch, so the copy runs beside it; the
        bookkeeping drains after the model. Runs after this step's
        admissions, so no record is ever in flight while
        ``_admit_paged`` walks the tables."""
        if self.host_store is None or not self.scheduler.prefetch_enabled:
            return
        if self._cb is not None and not self._cb.allow(now):
            return              # breaker open: no speculative copy either
        staged: List[Tuple[dict, Tuple]] = []
        for rec in self.scheduler.plan_prefetch(now):
            if self.faults is not None and self.faults.dma_fails("prefetch"):
                # injected speculative-restore copy failure: cancel the
                # record (its reservation refunds; admission restores or
                # recomputes on the critical path instead)
                if self._cb is not None:
                    self._cb.record_failure(now)
                self.scheduler.cancel_prefetch(rec["id"], now)
                continue
            got = self._stage_prefetch(rec)
            if got is None:
                self.scheduler.cancel_prefetch(rec["id"], now)
            else:
                if self._cb is not None:
                    self._cb.record_success()
                staged.append((rec, got))
        if not staged:
            return
        self._prefetch_event = self._scatter_staged(
            [s for _, s in staged], side=True)
        self.stats["prefetch_dispatches"] += 1
        self._prefetch_inflight = [
            (rec, self.stats["model_dispatches"]) for rec, _ in staged]

    def _stage_prefetch(self, rec: dict) -> Optional[Tuple]:
        """Build one record's device-side staging: fork the deepest
        node table covering the record's device boundary into a
        ``("pf", id)`` table, append fresh pages for [lo, hi), and map
        every prefetched token onto its (page, slot). Revalidates the
        host entries against the byte store (an entry mid-demote forces
        a targeted drain) and trims the record to what actually exists.
        Returns (pidx, sidx, data) or None when the chain cannot be
        staged."""
        sch = self.scheduler
        tokens, lo = rec["tokens"], rec["lo"]
        m = sch.tree.match(tokens)
        best_key, best_len, off = None, 0, 0
        for node in m.path:
            off += len(node.tokens)
            if off > lo:
                break
            t = self.pool.tables.get(("node", node.path_key))
            if t is not None and t.num_tokens >= off:
                best_key, best_len = ("node", node.path_key), off
        if lo > 0 and best_len < lo:
            return None     # device base never materialized: the
                            # landed span could not be reached anyway
        hi_eff = lo
        chunks = []
        for key, nid, a, b in rec["spans"]:
            self._host_entry(key)   # land an in-flight demote first
            piece = self.host_store.read_span(key, nid, a, b,
                                              speculative=True)
            if piece is None:
                break
            chunks.append(piece)
            hi_eff = b
        if hi_eff <= lo:
            return None
        if hi_eff < rec["hi"]:
            sch.trim_prefetch(rec["id"], hi_eff)
            if rec["cancelled"]:
                return None
        pfid = ("pf", rec["id"])
        if best_key is not None and lo > 0:
            self.pool.fork(best_key, pfid, lo)
        else:
            self.pool.create(pfid)
        try:
            self._append_with_cow(pfid, hi_eff - lo)
        except MemoryError:
            self.pool.release(pfid)
            return None     # fragmentation squeeze: never evict for
                            # speculative work at staging time
        pidx, sidx = self._token_page_slots(self.pool.tables[pfid],
                                            self.pool.page_size, lo, hi_eff)
        rec["pfid"] = pfid
        self.stats["prefetch_issued"] += hi_eff - lo
        return pidx, sidx, tree_concat(chunks)

    def _drain_prefetches(self, now: float) -> None:
        """Land this step's speculative restores: order the compute
        stream after their scatter (the host does not wait), publish
        each record's pages as node aliases (zero-copy forks at the
        issue-time boundaries), hand the policy bookkeeping back to the
        scheduler, and record whether the copy overlapped a model
        dispatch."""
        if self._prefetch_event is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._prefetch_event)
            self._prefetch_event = None
        inflight, self._prefetch_inflight = self._prefetch_inflight, []
        for rec, disp_at in inflight:
            pfid = rec.get("pfid")
            if rec["cancelled"]:
                # cancelled mid-flight (split under it, abort): the
                # scatter already ran — release the staging pages
                if pfid is not None and pfid in self.pool.tables:
                    self.pool.release(pfid)
                continue
            for key, _, _, b in rec["spans"]:
                nkey = ("node", key)
                if nkey not in self.pool.tables:
                    self.pool.fork(pfid, nkey, b)
            self.pool.release(pfid)
            self.scheduler.complete_prefetch(rec["id"], now)
            self.stats["prefetch_batches"] += 1
            if self.stats["model_dispatches"] > disp_at:
                self.stats["prefetch_batches_overlapped"] += 1

    # ---- post-prefill: publish the prompt's KV to the prefix store ----------

    def _store_prefix(self, r: Request, now: float) -> None:
        """Publish the prompt's KV per radix node: on the paged plane
        alias the request's pages (each node's sequence covers the full
        root->node token path, so a later match can fork from the
        deepest covering node); on the dense plane copy each new node's
        span out of the request's cache into ``kv_store`` (a recurrent
        stack only inserts the path: its snapshot was taken
        mid-prefill)."""
        path = self.scheduler.tree.insert(
            r.tokens, instance=self.econf.instance_id, now=now,
            record=False)
        if not self.paged and self.has_recurrent:
            return      # its snapshot was taken mid-prefill
        if not self.paged:
            cache = self.live[r.request_id]["cache"]
            off = 0
            for node in path:
                span = len(node.tokens)
                if node.path_key not in self.kv_store:
                    self.kv_store[node.path_key] = {
                        pj: {n: c[n][:, :, off:off + span].clone()
                             for n in ("k", "v")}
                        for pj, c in cache.items()}
                    self.scheduler.credit_stored(r.request_id, span)
                off += span
            return
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
        aborted) requests. Iterations with prefill work — and, on a
        speculative engine, every iteration — make ONE fused target
        dispatch (``_run_mixed``); other pure-decode iterations one
        bucketed decode dispatch.

        Order on the card: admissions (CoW page copies, demote gathers
        and their copies), the restore scatter, the prefetch scatter
        (copy stream), the model; then, after the model, the prefetch
        publish and the demote drains.

        With telemetry attached, each phase is a host span (module
        ``telemetry``): ``sched.form_batch``, ``engine.admit``, then
        ``engine.lower``, ``model.dispatch`` and ``engine.fetch`` in the
        paged dispatches, and ``sched.complete``."""
        tel = self.telemetry
        if tel is not None:
            t = time.perf_counter()
        batch = self.scheduler.form_batch(now)
        if tel is not None:
            t = tel.span("sched.form_batch", t)
        if not batch.items and not self.scheduler.prefetch_enabled:
            if self.faults is not None \
                    and self.faults.take_crash(self.econf.instance_id):
                raise InstanceCrashed(self.econf.instance_id)
            return []
        finished: List[Request] = []
        aborted: List[Request] = []
        newly_prefilled: List[Request] = []
        if batch.items:
            self.stats["iterations"] += 1
            aborted = self._admit_new(batch, now)
            if aborted:
                batch.items = [it for it in batch.items
                               if it.request not in aborted]
            # restores staged by this step's admissions land as one
            # scatter BEFORE the model reads any lane's KV
            if self._pending_restore:
                self._flush_restores()
            if tel is not None:
                tel.span("engine.admit", t)

        # speculative restores issue AFTER admission (no record is in
        # flight while _admit_paged walks tables) and BEFORE the model
        # dispatch, so their copy runs beside it
        self._issue_prefetches(now)

        # an armed mid-step crash fires HERE — after admissions took
        # pool pages and prefetch scatters went in flight, before the
        # model runs
        if self.faults is not None \
                and self.faults.take_crash(self.econf.instance_id):
            raise InstanceCrashed(self.econf.instance_id)

        if batch.items:
            has_prefill = any(it.chunk_tokens > 0
                              for it in batch.prefill_items())
            # speculative engines route decode-only iterations through
            # _run_mixed too: their decode slots become verify chunks,
            # still ONE target dispatch per iteration either way
            if self.fused and (has_prefill or self.draft is not None):
                newly_prefilled = self._run_mixed(batch)
            else:
                newly_prefilled = self._run_prefills(batch)
                dec = [it.request for it in batch.decode_items()]
                if dec and self.paged:
                    self._decode_batch_paged(dec)
                elif dec:
                    self._decode_batch_dense(dec)
            if tel is not None:
                t = time.perf_counter()
            finished = self.scheduler.complete_iteration(batch, now)
            for r in newly_prefilled:
                self._store_prefix(r, now)
            for item in batch.items:
                r = item.request
                if item.phase == "decode" and r.output_tokens:
                    r.output_tokens[-1] = self.live[r.request_id]["next"]
            for r in finished:
                lv = self.live.pop(r.request_id, None)
                self.pool.release(("req", r.request_id) if self.paged
                                  else r.request_id)
                if self.draft is not None:
                    self.draft.release(r.request_id)
                    self._observe_spec(r, lv, now)
            if tel is not None:
                tel.span("sched.complete", t)
        # land this step's speculative restores (the publish runs after
        # _store_prefix so a same-step split cancels cleanly first),
        # then the demote copies
        self._drain_prefetches(now)
        if self.host_store is not None:
            self._drain_demotes()
            self.stats["prefetch_hit"] = self.scheduler.stats[
                "prefetch_hit"]
            self.stats["prefetch_wasted"] = self.scheduler.stats[
                "prefetch_wasted"]
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
            self.scheduler.clamp_chunk(
                item, snapshot_boundary=self.has_recurrent)
        return aborted

    def _run_prefills(self, batch: Batch) -> List[Request]:
        """Serial per-request prefill chunks (the dense plane and the
        unfused paged baseline): one dispatch per chunk."""
        newly_prefilled: List[Request] = []
        for item in batch.prefill_items():
            r = item.request
            start, chunk = r.prefill_done, item.chunk_tokens
            if chunk <= 0:
                continue
            dev = self.device
            toks = torch.tensor(r.tokens[start:start + chunk],
                                dtype=torch.int32, device=dev)
            if self.paged:
                pt = self._page_table_rows([("req", r.request_id)])
                nxt, self.pages = self.api.extend_paged(
                    self.params, self.pages,
                    {"tokens": toks[None],
                     "start": torch.tensor([start], dtype=torch.int32,
                                           device=dev),
                     "page_table": torch.from_numpy(pt).to(dev)},
                    plan=self.plan)
            else:
                # the cache is updated in place; an int start costs no
                # device read for extend's bounds check
                nxt, _ = self.api.extend(
                    self.params, self.live[r.request_id]["cache"],
                    {"tokens": toks[None], "start": start})
            self.stats["prefilled_tokens"] += chunk
            self.stats["model_dispatches"] += 1
            if self.has_recurrent and start + chunk == r.prompt_len - 1:
                self._snapshot_full_cache(r, r.prompt_len - 1)
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
        their KV writes). On a speculative engine, decode slots with
        output headroom become K+1-token verify chunks of the same
        dispatch."""
        chunk_items = [it for it in batch.prefill_items()
                       if it.chunk_tokens > 0]
        dec_items = batch.decode_items()
        if not chunk_items and not dec_items:
            return []
        # --- speculative split: decode slots with >= 2 tokens of output
        # headroom become verify chunks; the rest (and any lane the
        # draft pool couldn't stage) stay plain decode ---
        spec_lanes: List[Tuple[Request, int, List[int], int]] = []
        plain_dec = dec_items
        if self.draft is not None and dec_items:
            want: List[Tuple[Request, int]] = []
            plain_dec = []
            for it in dec_items:
                r = it.request
                # committing a + 1 <= k_eff + 1 tokens this step must
                # never overshoot max_new_tokens (output_tokens already
                # holds the pending token)
                k_eff = min(self.draft.k,
                            r.max_new_tokens - len(r.output_tokens) - 1)
                if k_eff > 0:
                    want.append((r, k_eff))
                else:
                    plain_dec.append(it)
            props = self.draft.propose(want) if want else {}
            for r, k_eff in want:
                d = props.get(r.request_id)
                if d is None:       # draft pool squeeze: degrade
                    plain_dec.append(next(
                        it for it in dec_items if it.request is r))
                else:
                    pos = r.prompt_len + len(r.output_tokens) - 1
                    spec_lanes.append((r, k_eff, d, pos))
            self.stats["spec_draft_dispatches"] = self.draft.dispatches
            self.stats["spec_degraded"] = self.draft.degraded
            if not chunk_items and not spec_lanes:
                # everything degraded / out of headroom: the plain
                # bucketed pure-decode dispatch (still one per step)
                if plain_dec:
                    self._decode_batch_paged(
                        [it.request for it in plain_dec])
                return []
        tel = self.telemetry
        if tel is not None:
            t = time.perf_counter()
        n_pref = len(chunk_items)
        Lc = bucket(n_pref + len(spec_lanes))
        Cb = bucket(max([it.chunk_tokens for it in chunk_items]
                         + [k + 1 for _, k, _, _ in spec_lanes] + [1]))
        Ld = bucket(len(plain_dec))
        ctoks = np.zeros((Lc, Cb), np.int32)
        cstart = np.zeros(Lc, np.int32)
        clen = np.zeros(Lc, np.int32)
        for i, it in enumerate(chunk_items):
            r, s, n = it.request, it.request.prefill_done, it.chunk_tokens
            ctoks[i, :n] = r.tokens[s:s + n]
            cstart[i], clen[i] = s, n
        # verify lanes ride the SAME chunk half: [pending, d1..dK] at
        # the request's current context position against its own pages
        # (reserved at admission; rejected target KV is overwritten
        # positionally by the next step's chunk)
        for v, (r, k_eff, d, pos) in enumerate(spec_lanes):
            i = n_pref + v
            ctoks[i, 0] = self.live[r.request_id]["next"]
            ctoks[i, 1:k_eff + 1] = d
            cstart[i], clen[i] = pos, k_eff + 1
        cpt = self._page_table_rows(
            [("req", it.request.request_id) for it in chunk_items]
            + [("req", r.request_id) for r, _, _, _ in spec_lanes],
            n_rows=Lc)
        dtoks = np.zeros(Ld, np.int32)
        dpos = np.zeros(Ld, np.int32)
        for i, it in enumerate(plain_dec):
            r = it.request
            dtoks[i] = self.live[r.request_id]["next"]
            dpos[i] = r.prompt_len + len(r.output_tokens) - 1
        dpt = self._page_table_rows(
            [("req", it.request.request_id) for it in plain_dec],
            n_rows=Ld)
        # ONE host-to-device copy of the step's inputs, one dispatch
        fb = ForwardBatch(*self._lower(ModelWorkerBatch(
            ctoks, cstart, clen, cpt, dtoks, dpos, dpt).arrays()))
        inputs = {"chunk_tokens": fb.chunk_tokens,
                  "chunk_start": fb.chunk_start,
                  "chunk_len": fb.chunk_len,
                  "chunk_page_table": fb.chunk_page_table,
                  "dec_tokens": fb.dec_tokens, "dec_pos": fb.dec_pos,
                  "dec_page_table": fb.dec_page_table}
        if tel is not None:
            t = self._begin_dispatch(tel, t)
        try:
            if spec_lanes:
                nxt, cpred, self.pages = self.api.mixed_paged_spec(
                    self.params, self.pages, inputs, plan=self.plan)
            else:
                nxt, self.pages = self.api.mixed_paged(
                    self.params, self.pages, inputs, plan=self.plan)
        finally:
            if tel is not None:
                self._end_dispatch(tel, t)
        if spec_lanes:
            # one device-to-host copy of both results (waits for the card)
            both = self._fetch(nxt, cpred)
            nxt, cpred = both[:nxt.numel()], both[nxt.numel():].reshape(
                cpred.shape)
        else:
            nxt = self._fetch(nxt)          # waits for the device
        self.stats["model_dispatches"] += 1
        self.stats["fused_iterations"] += 1
        self.stats["fused_padded_tokens"] += (
            Lc * Cb + Ld - int(clen.sum()) - len(plain_dec))
        self.stats["fused_slot_tokens"] += Lc * Cb + Ld
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
        # --- verification: cpred[lane, j] is the target's greedy
        # prediction AFTER chunk token j, i.e. p_j. Accept d_j iff
        # d_j == p_{j-1}; with `a` leading accepts the step commits
        # d1..da + the target's correction p_a (= the plain path's next
        # token when a = 0 — greedy speculation is token-exact) ---
        for v, (r, k_eff, d, pos) in enumerate(spec_lanes):
            preds = cpred[n_pref + v]
            a = 0
            while a < k_eff and d[a] == int(preds[a]):
                a += 1
            # accepted drafts land now; complete_iteration then appends
            # its usual placeholder (the a+1-th committed token) which
            # step()'s overwrite loop sets to the correction p_a
            r.output_tokens.extend(d[:a])
            lv = self.live[r.request_id]
            lv["next"] = int(preds[a])
            lv["spec_prop"] = lv.get("spec_prop", 0) + k_eff
            lv["spec_acc"] = lv.get("spec_acc", 0) + a
            self.draft.commit(r.request_id, pos, a)
            self.stats["spec_proposed_tokens"] += k_eff
            self.stats["spec_accepted_tokens"] += a
            self.stats["spec_rejected_tokens"] += k_eff - a
        for i, it in enumerate(plain_dec):
            self.live[it.request.request_id]["next"] = int(nxt[Lc + i])
        if dec_items:
            self.stats["decode_steps"] += len(dec_items)
            self.stats["decode_batches"] += 1
            self.stats["spec_verify_lanes"] += len(spec_lanes)
        return newly_prefilled

    @staticmethod
    def _begin_dispatch(tel, t: float) -> float:
        """Close the ``engine.lower`` span begun at ``t`` and open the
        model dispatch: the routed MoE's host syncs record into ``tel``
        until ``_end_dispatch``. Returns the dispatch's start."""
        t = tel.span("engine.lower", t)
        layers.MOE_SPAN_SINK = tel.span
        return t

    @staticmethod
    def _end_dispatch(tel, t: float) -> None:
        layers.MOE_SPAN_SINK = None
        tel.span("model.dispatch", t)

    def _observe_spec(self, r: Request, lv: Optional[Dict[str, Any]],
                      now: float) -> None:
        """Terminal speculative observation for one finished request:
        the per-request acceptance-rate histogram + a ``spec`` trace
        point."""
        if not lv or not lv.get("spec_prop"):
            return
        prop, acc = lv["spec_prop"], lv["spec_acc"]
        if self.telemetry is not None:
            self.telemetry.registry.histogram(
                "engine_spec_acceptance",
                buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
                instance=self.econf.instance_id).observe(acc / prop)
        if r.trace is not None:
            r.trace.point("spec", now, proposed=prop, accepted=acc)

    def _decode_batch_paged(self, dec: List[Request]) -> None:
        """Slot/bucket decode: live requests fill the first B lanes of a
        power-of-two bucket; padding lanes write into the scratch page.
        Where the engine holds decode graphs the step's inputs land in
        the bucket's static buffers and its graph replays; else the
        forward runs eagerly."""
        tel = self.telemetry
        if tel is not None:
            t = time.perf_counter()
        B = len(dec)
        Bb = bucket(B)
        tokens = np.zeros(Bb, np.int32)
        pos = np.zeros(Bb, np.int32)
        for i, r in enumerate(dec):
            tokens[i] = self.live[r.request_id]["next"]
            # the fed token sits at context position prompt_len + (#output
            # tokens already cached); the first output is not yet cached
            pos[i] = r.prompt_len + len(r.output_tokens) - 1
        pt = self._page_table_rows(
            [("req", r.request_id) for r in dec], n_rows=Bb)
        graph = self._graphs.get(Bb) if self._graphs is not None else None
        fb = ForwardBatch(*self._lower(
            decode_graph.decode_batch(tokens, pos, pt).arrays(),
            graph.inputs if graph is not None else None))
        if tel is not None:
            t = self._begin_dispatch(tel, t)
        try:
            if graph is not None:
                nxt = self._graphs.replay(graph)
            else:
                nxt, self.pages = self.api.decode_paged(
                    self.params, self.pages,
                    {"tokens": fb.dec_tokens, "pos": fb.dec_pos,
                     "page_table": fb.dec_page_table}, plan=self.plan)
        finally:
            if tel is not None:
                self._end_dispatch(tel, t)
        nxt = self._fetch(nxt)
        if graph is not None:
            self.stats["decode_graph_replays"] += 1
        for i, r in enumerate(dec):
            self.live[r.request_id]["next"] = int(nxt[i])
        self.stats["decode_steps"] += B
        self.stats["decode_batches"] += 1
        self.stats["model_dispatches"] += 1

    def _decode_batch_dense(self, dec: List[Request]) -> None:
        """DENSE reference: concatenate the live caches into the batch
        cache (O(B * S) copies every iteration), one decode dispatch,
        then give each request its view of the result — the cost the
        paged plane removes."""
        caches = _cache_concat(
            [self.live[r.request_id]["cache"] for r in dec])
        self.stats["cache_concat_calls"] += 1
        tokens = np.asarray([self.live[r.request_id]["next"] for r in dec],
                            np.int32)
        pos = np.asarray([r.prompt_len + len(r.output_tokens) - 1
                          for r in dec], np.int32)
        tokens, pos = lower_arrays((tokens, pos), self.device)
        nxt, caches = self.api.decode(self.params, caches,
                                      {"tokens": tokens, "pos": pos})
        nxt = nxt.cpu().numpy()             # waits for the device
        for i, r in enumerate(dec):
            self.live[r.request_id]["cache"] = _cache_index(caches, i)
            self.live[r.request_id]["next"] = int(nxt[i])
        self.stats["decode_steps"] += len(dec)
        self.stats["decode_batches"] += 1
        self.stats["model_dispatches"] += 1

    # ---- failure ---------------------------------------------------------------

    def attach_faults(self, faults,
                      breaker: Optional[CircuitBreaker] = None) -> None:
        """Wire the cluster's shared fault injector into this engine's
        fault points, plus a per-instance circuit breaker over the
        host-tier restore/prefetch path (only when the tier exists)."""
        self.faults = faults
        if self.econf.host_capacity_tokens > 0:
            self._cb = breaker if breaker is not None else CircuitBreaker()

    def attach_copy_log(self) -> CopyLog:
        """Time this engine's host<->device copies from now on (CUDA
        events on the stream that runs each copy, and the host wall
        blocked in the demote drain); returns the log. CPU engines
        record nothing."""
        if self.copy_log is None:
            self.copy_log = CopyLog()
        return self.copy_log

    def attach_telemetry(self, telemetry) -> None:
        """Bind this engine's stats surfaces into the shared telemetry
        registry (engine_* / sched_* / hoststore_* series labeled with
        the instance id) and register callback gauges over the live
        token accounting."""
        inst = self.econf.instance_id
        self.telemetry = telemetry
        self.stats = telemetry.adopt(self.stats, "engine", instance=inst)
        sch = self.scheduler
        sch.telemetry = telemetry
        sch.stats = telemetry.adopt(sch.stats, "sched", instance=inst)
        if self.host_store is not None:
            self.host_store.stats = telemetry.adopt(
                self.host_store.stats, "hoststore", instance=inst)
        telemetry.gauge_fn("sched_used_tokens",
                           lambda s=sch: s.used_tokens, instance=inst)
        telemetry.gauge_fn("sched_host_used_tokens",
                           lambda s=sch: s.host_used_tokens,
                           instance=inst)
        telemetry.gauge_fn("sched_prefetch_reserved_tokens",
                           lambda s=sch: s.prefetch_reserved_tokens,
                           instance=inst)
        # per-shard pool occupancy of a tensor-parallel engine: every
        # shard holds a 1/chips slice of every live page, so its share in
        # tokens is the pool's used pages x page_size / chips (read
        # through the engine, so the gauge survives fail()'s rebuild)
        if self.mesh is not None:
            for s in range(self.chips):
                telemetry.gauge_fn(
                    "engine_shard_pool_tokens",
                    lambda e=self: (e.pool.used_pages * e.pool.page_size
                                    // e.chips),
                    instance=inst, shard=s)

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
        if self.paged:
            # fresh pool, host store, tier and draft plane + re-hook the
            # tree
            self._init_paged()
        else:
            self._init_dense()      # fresh pool + empty prefix store
        return reqs

    @property
    def depth(self) -> int:
        return self.scheduler.depth
