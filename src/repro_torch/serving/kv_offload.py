"""The host KV tier (counterpart of the JAX package's
``serving/kv_offload.py``).

Device memory is tier 0 (the paged pool); this module adds tier 1: host
RAM holding *demoted* KV. Under memory pressure the local scheduler's
eviction demotes a radix node's KV instead of dropping it: the node's
pages are gathered on the card and copied to the host in ONE batched
transfer per eviction plan, and parked here, keyed by the node's
content-addressed path key at token granularity. A later hit on a
demoted prefix restores it host-to-device into fresh pages instead of
recomputing the prefill. Entries are portable: migration ships an entry
to another instance's ``HostKVStore``.

  * ``HostKVStore`` owns the BYTES: numpy KV spans keyed by path key,
    one array [span, KH, D] per pool leaf. bfloat16 leaves are held as
    uint16 bit views (numpy has no bfloat16), so they round-trip bit for
    bit. Capacity is the scheduler's (single authority); the store only
    tracks usage so the two can be reconciled.
  * ``PagedHostTier`` is the DATA MOVER the scheduler drives. Its
    bookkeeping is the reference's; its data movement is built for CUDA
    streams:

      - snapshot: ``demote_many`` gathers every page of the plan, of every
        pool leaf, into ONE fresh device tensor on the compute stream
        (``Engine.gather_pages_device``);
      - copy: it then issues the device-to-host copy at once, into pinned
        host memory with ``non_blocking=True``, on the engine's copy
        stream, which first waits on the compute stream;
      - lifetime: the gathered tensor is marked used by the copy stream
        (``record_stream``) and kept in the pending record with the
        copy's event;
      - drain: ``drain`` waits on that event only, then slices the pinned
        data into token spans for ``HostKVStore.put``.

    So the copy runs beside the step's forward on the card, and releasing
    the pages right after the gather is safe: the snapshot precedes, in
    stream order, every later write to them. On a CPU engine the same
    code copies synchronously, with no streams.

    On a tensor-parallel engine the snapshot is one tensor per shard
    (each shard's slice of the pages), each copied to the host on its own
    device's compute stream; ``drain`` joins the slices along the
    engine's ``shard_axis`` and adds the landing's wall to the engine's
    ``shard_dma_seconds``. Restores go the other way per shard
    (``Engine._scatter_shards``).

``CopyLog`` (attached on request: ``Engine.attach_copy_log``) times each
batched copy with CUDA events on the stream that ran it (bytes and
milliseconds per direction) and the host wall spent blocked in
``drain``; events are read only once they have completed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.radix_tree import PathKey

Pytree = Any


@dataclass
class HostEntry:
    """One demoted radix-node span: tokens [start, start+length) of the
    node's root->node sequence, as host numpy arrays per layer leaf.
    ``node_id`` pins the owning LOCAL node (collision guard: a path key
    names content, the node id disambiguates the astronomically rare
    digest collision within one instance)."""
    key: PathKey
    start: int                       # absolute token depth of the span
    kv: Pytree                       # {pj: {gg: {"k"/"v": np [L, KH, D]}}}
    length: int = 0
    node_id: int = -1

    def slice(self, lo: int, hi: int) -> Pytree:
        """Token-subrange [lo, hi) of this span, in ABSOLUTE depth."""
        a, b = lo - self.start, hi - self.start
        assert 0 <= a <= b <= self.length, (lo, hi, self.start, self.length)
        return _tree_map(lambda x: x[a:b], self.kv)


def _tree_map(fn, tree: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Pytree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out.extend(tree_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_from_leaves(paths: Sequence[Tuple], leaves: Sequence) -> Pytree:
    """Inverse of ``tree_leaves``: nested dicts from (path, leaf) pairs."""
    root: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def tree_concat(trees: Sequence[Pytree]) -> Pytree:
    """Leaf-wise numpy concatenation along the token axis."""
    if len(trees) == 1:
        return trees[0]
    paths = [p for p, _ in tree_leaves(trees[0])]
    cols = zip(*[[x for _, x in tree_leaves(t)] for t in trees])
    return tree_from_leaves(paths, [np.concatenate(c, 0) for c in cols])


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bfloat16 as uint16 bits (no copy)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class CopyLog:
    """Host<->device copy times of one engine. Each batched copy records
    a pair of timing events on the stream that ran it; ``fold`` adds the
    pairs that have completed (``block=True``: all of them, after a
    synchronize) into ``totals``, so reading a time never stalls a step.
    CPU engines record nothing."""

    def __init__(self):
        self.totals = {"d2h_bytes": 0, "d2h_ms": 0.0, "d2h_copies": 0,
                       "h2d_bytes": 0, "h2d_ms": 0.0, "h2d_copies": 0,
                       "drain_blocked_s": 0.0}
        self._open: List[Tuple[str, int, Any, Any]] = []

    def start(self, stream) -> Any:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def stop(self, kind: str, nbytes: int, ev0, stream) -> Any:
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record(stream)
        self._open.append((kind, nbytes, ev0, ev1))
        return ev1

    def fold(self, block: bool = False) -> Dict[str, float]:
        keep = []
        for kind, nbytes, ev0, ev1 in self._open:
            if block:
                ev1.synchronize()
            elif not ev1.query():
                keep.append((kind, nbytes, ev0, ev1))
                continue
            self.totals[f"{kind}_bytes"] += nbytes
            self.totals[f"{kind}_ms"] += ev0.elapsed_time(ev1)
            self.totals[f"{kind}_copies"] += 1
        self._open = keep
        return self.totals


class HostKVStore:
    """Host-RAM byte store for demoted KV, keyed by content-addressed
    path key. Capacity is enforced by the LocalScheduler (single
    authority); the store only tracks usage so the two layers can be
    reconciled."""

    def __init__(self):
        self.entries: Dict[PathKey, HostEntry] = {}
        self.used_tokens = 0
        self.stats = {"puts": 0, "drops": 0, "splits": 0, "ingests": 0,
                      "reads": 0, "prefetch_reads": 0}

    def __contains__(self, key) -> bool:
        return key in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def put(self, key, start: int, kv: Pytree, length: int,
            node_id: int = -1) -> None:
        assert key not in self.entries, f"span {key} already demoted"
        self.entries[key] = HostEntry(key, start, kv, length, node_id)
        self.used_tokens += length
        self.stats["puts"] += 1

    def get(self, key) -> Optional[HostEntry]:
        return self.entries.get(key)

    def read_span(self, key, node_id: int, lo: int, hi: int, *,
                  speculative: bool = False) -> Optional[Pytree]:
        """Verified read of tokens [lo, hi) under ``key``: None when
        the entry is missing, owned by a different node (digest
        collision — never hand out another prefix's KV), or does not
        cover the range. Reads are POLICY-NEUTRAL: no recency or heat
        update happens here — the scheduler decides what counts as a
        hit, and a ``speculative`` prefetch read never does (it only
        shows up in its own counter)."""
        e = self.entries.get(key)
        if (e is None or (node_id >= 0 and e.node_id != node_id)
                or e.start > lo or e.start + e.length < hi):
            return None
        self.stats["prefetch_reads" if speculative else "reads"] += 1
        return e.slice(lo, hi)

    def drop(self, key) -> int:
        e = self.entries.pop(key, None)
        if e is None:
            return 0
        self.used_tokens -= e.length
        self.stats["drops"] += 1
        return e.length

    def clear(self) -> None:
        self.entries.clear()
        self.used_tokens = 0

    def on_split(self, head, tail) -> None:
        """Radix-node split hook. The TAIL keeps the pre-split path key
        (its end boundary is unchanged), so the existing entry's key now
        names the tail: the tokens past the cut stay under it, while
        the head's part is rekeyed under the head's new (shallower) key
        — numpy slicing, no device traffic. Mirrors the scheduler's
        LRU rekey exactly (same keys, same collision condition)."""
        e = self.entries.get(tail.path_key)
        if e is None or e.node_id != head.node_id:
            return                    # no entry, or a collided key's entry
        boundary = head.depth_tokens()           # absolute, post-split
        keep = boundary - e.start
        if keep <= 0:
            e.node_id = tail.node_id             # fully past the cut
            return
        if keep >= e.length:
            # span ends at/before the cut: the whole entry belongs to
            # the head — move it under the head's new key
            del self.entries[tail.path_key]
            e.key = head.path_key
            e.node_id = head.node_id
            if head.path_key in self.entries:    # digest collision
                self.used_tokens -= e.length     # (mirrors scheduler drop)
                self.stats["drops"] += 1
            else:
                self.entries[head.path_key] = e
            return
        head_kv = _tree_map(lambda x: x[:keep], e.kv)
        e.kv = _tree_map(lambda x: x[keep:], e.kv)
        head_len = keep
        e.length -= keep
        e.start = boundary
        e.node_id = tail.node_id
        if head.path_key in self.entries:        # digest collision
            self.used_tokens -= head_len
            self.stats["drops"] += 1
        else:
            self.entries[head.path_key] = HostEntry(
                head.path_key, boundary - keep, head_kv, head_len,
                head.node_id)
        self.stats["splits"] += 1

    def check_invariants(self) -> None:
        total = 0
        for key, e in self.entries.items():
            assert e.key == key
            assert e.length >= 0 and e.start >= 0
            for _, leaf in tree_leaves(e.kv):
                assert isinstance(leaf, np.ndarray), "host tier must hold numpy"
                assert leaf.shape[0] == e.length, (leaf.shape, e.length)
            total += e.length
        assert total == self.used_tokens, (total, self.used_tokens)


class PagedHostTier:
    """Data mover between an Engine's paged device plane and a
    HostKVStore. The LocalScheduler calls ``demote_many`` with the
    eviction plan's nodes, ``drop`` on host-capacity overflow, and
    ``export``/``ingest`` for tier-to-tier migration."""

    carries_bytes = True     # vs AccountingHostTier: payloads are real

    def __init__(self, engine, store: HostKVStore):
        self.engine = engine
        self.store = store
        # demotes whose device-to-host copy is in flight. Each record:
        # the gathered device tensor, its pinned host copy, the copy's
        # event (None on a CPU engine), the jobs, and the dispatch count
        # at issue; jobs may be cancelled by ``drop`` before it lands.
        self._pending: List[dict] = []

    # ---- demote: device -> host, copied beside the step's forward ---------

    def demote_many(self, nodes: Sequence) -> Dict[PathKey, int]:
        """Demote every node in an eviction plan whose KV is actually
        materialized in the pool: ONE gather over all their pages is
        issued NOW on the compute stream (a snapshot in a fresh device
        tensor) and its device-to-host copy is issued at once on the
        copy stream; ``drain`` lands the bytes. Releases the nodes' pool
        tables either way (safe: the snapshot precedes any later write
        in stream order). Returns {path_key: demoted_token_count} for
        spans now (or about to be) host-resident."""
        if self._pending and any(
                job[0] == n.path_key
                for rec in self._pending for job in rec["jobs"]
                for n in nodes):
            self.drain()              # re-demotion check needs those bytes
        eng, pool = self.engine, self.engine.pool
        ps = pool.page_size
        jobs: List[Tuple[PathKey, int, int, int, int, int]] = []
        all_pages: List[int] = []
        out: Dict[PathKey, int] = {}
        for node in nodes:
            key = ("node", node.path_key)
            t = pool.tables.get(key)
            if t is None:
                continue                       # KV never materialized
            end = node.depth_tokens()
            start = end - len(node.tokens)
            cov = min(t.num_tokens, end)       # table may be trimmed
            prev = self.store.get(node.path_key)
            if prev is not None and prev.node_id == node.node_id:
                # re-demotion of a restored-then-evicted node: the host
                # copy is still valid (KV is a pure function of the
                # token prefix) — no new transfer needed.
                out[node.path_key] = prev.length
                pool.release(key)
                continue
            if prev is not None:
                # digest collision with a foreign entry: drop, never
                # overwrite another prefix's KV
                pool.release(key)
                continue
            if cov > start:
                faults = getattr(eng, "faults", None)
                if faults is not None and faults.dma_fails("demote"):
                    # injected device->host DMA failure: the transfer is
                    # lost, so the span DROPS instead of demoting — the
                    # scheduler sees no demotion and the eviction
                    # notification reports the span as gone
                    pool.release(key)
                    continue
                p0, p1 = start // ps, -(-cov // ps)
                jobs.append((node.path_key, node.node_id, start, cov,
                             len(all_pages), p1 - p0))
                all_pages.extend(t.pages[p0:p1])
                out[node.path_key] = cov - start
            pool.release(key)
        if jobs:
            gathered = eng.gather_pages_device(all_pages)
            host, event = self._copy_to_host(gathered)
            self._pending.append({
                "gathered": gathered, "host": host, "event": event,
                "jobs": jobs, "cancelled": set(),
                "dispatches_at_issue": eng.stats["model_dispatches"]})
        return out

    def _copy_to_host(self, gathered):
        """Issue the snapshot's device-to-host copy: on the copy stream,
        after the compute stream's work so far, into pinned memory.
        Returns (host tensor, the copy's completion event); a CPU
        engine's snapshot already lies on the host (event None). A
        tensor-parallel engine's snapshot is a list of per-shard tensors:
        each is copied on its device's compute stream, and the result is
        (host tensors, events)."""
        eng = self.engine
        if isinstance(gathered, list):
            hosts, events = [], []
            for g in gathered:
                if g.device.type != "cuda":
                    hosts.append(g)
                    continue
                host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                host.copy_(g, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(g.device))
                hosts.append(host)
                events.append(ev)
            return hosts, events
        cs = eng.copy_stream
        if cs is None:
            return gathered, None
        # allocated before the copy is timed: a cold pinned allocation
        # costs host time, not copy time
        host = torch.empty(gathered.shape, dtype=gathered.dtype,
                           pin_memory=True)
        cs.wait_stream(torch.cuda.current_stream(eng.device))
        log = eng.copy_log
        with torch.cuda.stream(cs):
            ev0 = log.start(cs) if log is not None else None
            host.copy_(gathered, non_blocking=True)
            if log is not None:
                ev1 = log.stop("d2h", host.nbytes, ev0, cs)
            else:
                ev1 = torch.cuda.Event()
                ev1.record(cs)
        # the compute stream's allocator may not hand the snapshot's
        # memory out again before the copy stream has read it
        gathered.record_stream(cs)
        return host, ev1

    def pending_has(self, key) -> bool:
        """Is this span's demote copy still in flight (issued, not yet
        landed host-side)?"""
        return any(job[0] == key and key not in rec["cancelled"]
                   for rec in self._pending for job in rec["jobs"])

    def drain(self) -> None:
        """Land every pending demote's bytes in the store. Called by the
        engine at the END of a step — after the model dispatch was
        enqueued, so the copy ran beside compute — or forced earlier by
        a read that needs the bytes. Waits on each copy's event only."""
        pending, self._pending = self._pending, []
        eng = self.engine
        ps = eng.pool.page_size
        paths = eng.leaf_paths
        for rec in pending:
            if isinstance(rec["host"], list):
                # a tensor-parallel engine's shards: land and join them
                t0 = time.perf_counter()
                for ev in rec["event"]:
                    ev.synchronize()
                arr = np.concatenate([host_numpy(h) for h in rec["host"]],
                                     axis=eng.shard_axis)
                eng.stats["shard_dma_seconds"] += time.perf_counter() - t0
            else:
                if rec["event"] is not None:
                    t0 = time.perf_counter()
                    rec["event"].synchronize()
                    if eng.copy_log is not None:
                        eng.copy_log.totals["drain_blocked_s"] += (
                            time.perf_counter() - t0)
                arr = host_numpy(rec["host"])  # [n_leaves, n, PS, KH, D]
            demoted = 0
            for key, node_id, start, cov, ofs, npg in rec["jobs"]:
                if key in rec["cancelled"]:
                    continue
                base = (start // ps) * ps
                rows = arr[:, ofs:ofs + npg].reshape(
                    (arr.shape[0], npg * ps) + arr.shape[3:])
                span = np.ascontiguousarray(
                    rows[:, start - base:cov - base])
                self.store.put(key, start,
                               tree_from_leaves(paths, list(span)),
                               cov - start, node_id=node_id)
                demoted += cov - start
            eng.stats["demoted_tokens"] += demoted
            eng.stats["demote_batches"] += 1
            if eng.stats["model_dispatches"] > rec["dispatches_at_issue"]:
                eng.stats["demote_batches_overlapped"] += 1
        # demote_overlap_frac is a derived StatsDict key on Engine.stats
        # — computed at read time, never recomputed in this drain loop

    # ---- drop: host entry dies --------------------------------------------

    def drop(self, key) -> None:
        for rec in self._pending:
            for job in rec["jobs"]:
                if job[0] == key:
                    rec["cancelled"].add(key)
        self.store.drop(key)

    # ---- migration endpoints ------------------------------------------------

    def export(self, node, lo: int, hi: int) -> Optional[Pytree]:
        """Slice this node's host entry for tokens [lo, hi) — the
        migration source side. Forces a drain (the bytes must exist to
        ship) and verifies entry ownership (collision guard)."""
        if self._pending:
            self.drain()
        e = self.store.get(node.path_key)
        if (e is None or e.node_id != node.node_id
                or e.start > lo or e.start + e.length < hi):
            return None
        return e.slice(lo, hi)

    def ingest(self, node, start: int, length: int, payload: Pytree,
               offset: int) -> None:
        """Land a migrated span [start, start+length) for ``node`` —
        the migration target side. ``payload`` covers the shipped piece
        from ``offset`` relative tokens in; the copy models the network
        transfer landing in this host's RAM."""
        if payload is None:
            return
        if self._pending:
            self.drain()
        kv = _tree_map(
            lambda x: np.ascontiguousarray(x[offset:offset + length]),
            payload)
        self.store.put(node.path_key, start, kv, length,
                       node_id=node.node_id)
        self.store.stats["ingests"] += 1
