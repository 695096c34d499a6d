"""Token-level radix (compressed prefix) tree — Preble §3.2/§3.3.

Used in two places:
  * the GLOBAL scheduler keeps one forest of these trees with per-node
    instance sets and window-H hit histories (who caches what, how hot);
  * each LOCAL scheduler keeps one tree tracking what its own instance
    caches, with LRU timestamps for eviction.

The tree stores sequences of token ids.  Each edge/node holds a token
span; children are indexed by their first token for O(1) fan-out lookup.
A node is "cached on instance i" when i appears in ``node.instances``.

Prefix identity is CONTENT-ADDRESSED (DESIGN.md §9): every node carries
a ``PathKey`` — an incremental rolling hash of its full root→node token
path plus the absolute depth — maintained in O(edge) through inserts
and splits. Node ids are allocated PER TREE (each tree owns its own
counter): they are meaningful only inside one tree (pins, eviction
plans, `_hot_nodes`), while everything that crosses trees or tiers —
eviction/demotion/host-drop notifications, host-store entries, the
migration protocol — is keyed by path. A ``PrefixSpan`` (path key of
the span's END boundary + its token length) names the same KV range in
any tree regardless of how that tree happened to split its nodes,
because every split boundary a local tree has, the global forest that
saw a superset of the traffic has too.

Hash-collision fallback: the key index keeps a bucket per key; a bucket
with >1 nodes (two distinct paths, same 61-bit digest AND depth —
~2^-61 per pair) is AMBIGUOUS: `node_by_key` then resolves only with
full-path verification (explicit tokens) and returns None otherwise, so
consumers degrade to recompute — never to another prefix's KV.

This is pure host-side control-plane code (no jax).
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Sequence, Set, Tuple)

# Rolling polynomial hash over token ids (mod a Mersenne prime). The
# digest of a path extends incrementally token by token, so a node's
# key derives from its parent's in O(len(edge)).
_HASH_MOD = (1 << 61) - 1
_HASH_BASE = 1_000_003

# Version tag of the cross-tree notification/migration protocol (v2 =
# content-addressed PrefixSpans, keyword-only tier arguments).
NOTIFY_PROTOCOL_VERSION = 2


def extend_digest(digest: int, tokens: Sequence[int]) -> int:
    for t in tokens:
        digest = (digest * _HASH_BASE + t + 1) % _HASH_MOD
    return digest


class PathKey(NamedTuple):
    """Content-addressed identity of one root→boundary token path."""
    digest: int          # rolling hash of tokens[0:depth]
    depth: int           # absolute token depth of the boundary


class PrefixSpan(NamedTuple):
    """A token range [key.depth - length, key.depth) named by content:
    the unit of the eviction/demotion/migration protocol."""
    key: PathKey
    length: int


ROOT_KEY = PathKey(0, 0)


def path_key_of(tokens: Sequence[int]) -> PathKey:
    """Key of an explicit token sequence (tests / protocol consumers)."""
    return PathKey(extend_digest(0, tokens), len(tokens))


class RadixNode:
    """One node of the radix tree.  ``tokens`` is the edge label."""

    __slots__ = (
        "node_id",
        "path_key",
        "tokens",
        "parent",
        "children",
        "instances",
        "host_instances",
        "hit_times",
        "last_access",
        "ref_count",
    )

    def __init__(self, tokens: Tuple[int, ...], parent: Optional["RadixNode"],
                 node_id: int = 0):
        # node_id is TREE-LOCAL (see module docstring); path_key is the
        # portable identity, derived incrementally from the parent's.
        self.node_id: int = node_id
        if parent is None:
            self.path_key: PathKey = ROOT_KEY
        else:
            pk = parent.path_key
            self.path_key = PathKey(extend_digest(pk.digest, tokens),
                                    pk.depth + len(tokens))
        self.tokens: Tuple[int, ...] = tokens
        self.parent = parent
        self.children: Dict[int, RadixNode] = {}
        # Which model instances currently cache this node's KV/state.
        self.instances: Set[int] = set()
        # Which instances hold this node's KV *demoted to host memory*
        # (hierarchical tiering): re-hitting it costs restore_time(len),
        # not recompute. An instance can appear in both sets (host copy
        # retained after a restore re-promoted the node to device).
        self.host_instances: Set[int] = set()
        # Per-instance deque of hit timestamps within the history window H.
        self.hit_times: Dict[int, deque] = {}
        self.last_access: float = 0.0
        # Number of in-flight requests pinning this node (eviction guard).
        self.ref_count: int = 0

    # ---- structure helpers -------------------------------------------------

    def depth_tokens(self) -> int:
        """Total tokens from root to (and including) this node."""
        n, total = self, 0
        while n is not None:
            total += len(n.tokens)
            n = n.parent
        return total

    def path(self) -> List["RadixNode"]:
        out: List[RadixNode] = []
        n = self
        while n is not None:
            out.append(n)
            n = n.parent
        out.reverse()
        return out

    def is_leaf(self) -> bool:
        return not self.children

    def full_tokens(self) -> Tuple[int, ...]:
        """Root→node token path (O(depth) parent walk) — the content a
        PathKey digests; used for full-path verification on hash match."""
        parts: List[Tuple[int, ...]] = []
        n: Optional[RadixNode] = self
        while n is not None:
            parts.append(n.tokens)
            n = n.parent
        parts.reverse()
        return tuple(t for p in parts for t in p)

    def span(self) -> PrefixSpan:
        """This node's token range as a portable protocol span."""
        return PrefixSpan(self.path_key, len(self.tokens))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"RadixNode(id={self.node_id}, len={len(self.tokens)}, inst={sorted(self.instances)})"


@dataclass
class MatchResult:
    """Result of matching a prompt against the tree."""

    matched_len: int                       # total matched tokens
    path: List[RadixNode]                  # matched nodes root→deepest
    last_node: Optional[RadixNode]         # deepest node touched (may be partial)
    last_node_matched: int                 # tokens matched inside last_node
    # per-instance matched length: how many of matched_len each instance caches
    per_instance_len: Dict[int, int] = field(default_factory=dict)
    # matched tokens an instance holds ONLY in its host-offload tier
    # (demoted KV): reusable at restore_time(len) instead of recompute.
    # Disjoint from per_instance_len (device caching wins the count).
    per_instance_host_len: Dict[int, int] = field(default_factory=dict)


class RadixTree:
    """A forest rooted at a sentinel node (paper: several global trees —
    a sentinel root with children is an equivalent representation)."""

    def __init__(self, window: float = 180.0,
                 id_source: Optional[Iterator[int]] = None):
        # PER-TREE node ids: every tree allocates independently (tests
        # randomize the start to prove nothing cross-tree leans on ids).
        self._ids: Iterator[int] = (id_source if id_source is not None
                                    else itertools.count())
        self.root = RadixNode((), None, node_id=next(self._ids))
        self.window = window  # history window H in seconds (default 3 min)
        self._token_count = 0  # cached tokens (nodes with >=1 instance count full)
        # node-id -> node index: O(1) lookup for same-tree references
        # (pins, eviction plans) instead of an O(all-nodes) walk
        self._by_id: Dict[int, RadixNode] = {}
        # path-key -> nodes index: O(1) content-addressed lookup for the
        # cross-tree protocol. A bucket normally holds exactly one node;
        # >1 marks a digest collision (ambiguous key, see node_by_key).
        self._by_key: Dict[PathKey, List[RadixNode]] = {}
        # structural hooks: each called as hook(head, tail) after a node
        # split, with head keeping the id/prefix and tail the new suffix
        # node (and the ORIGINAL path key, whose boundary is unchanged).
        # The local scheduler keeps pin lists aligned; engines keep
        # page-table aliases aligned with node boundaries.
        self.split_hooks: List[Callable[[RadixNode, RadixNode], None]] = []

    def get_node(self, node_id: int) -> Optional[RadixNode]:
        return self._by_id.get(node_id)

    # ---- content-addressed index -------------------------------------------

    def _register(self, node: RadixNode) -> None:
        self._by_id[node.node_id] = node
        self._by_key.setdefault(node.path_key, []).append(node)

    def _unregister(self, node: RadixNode) -> None:
        self._by_id.pop(node.node_id, None)
        bucket = self._by_key.get(node.path_key)
        if bucket is not None:
            try:
                bucket.remove(node)
            except ValueError:
                pass
            if not bucket:
                del self._by_key[node.path_key]

    def key_ambiguous(self, key: PathKey) -> bool:
        """True when two distinct token paths in THIS tree collide on
        (digest, depth) — consumers must not address KV by this key."""
        return len(self._by_key.get(key, ())) > 1

    def node_by_key(self, key: PathKey,
                    tokens: Optional[Sequence[int]] = None
                    ) -> Optional[RadixNode]:
        """Resolve a path key to this tree's node ending at that
        boundary. On an ambiguous (collided) key, resolution requires
        ``tokens`` — the expected root→boundary path — and verifies the
        full path; without tokens it returns None (callers degrade to
        recompute, never to another prefix's KV)."""
        bucket = self._by_key.get(key)
        if not bucket:
            return None
        if tokens is not None:
            for n in bucket:
                if n.full_tokens() == tuple(tokens):
                    return n
            return None
        if len(bucket) == 1:
            return bucket[0]
        return None

    def resolve_span(self, span: PrefixSpan,
                     tokens: Optional[Sequence[int]] = None
                     ) -> List[RadixNode]:
        """Resolve a protocol span to the chain of THIS tree's nodes
        covering its token range, deepest first. The sender's node may
        map to several nodes here (this tree split finer) — boundaries
        are compatible because split boundaries only ever refine. An
        unresolvable/ambiguous key, or a chain whose node boundaries
        would overshoot the span (stale notification), yields a partial
        (possibly empty) chain — safe no-op degradation."""
        node = self.node_by_key(span.key, tokens)
        chain: List[RadixNode] = []
        covered = 0
        while (node is not None and node.parent is not None
               and covered < span.length):
            if covered + len(node.tokens) > span.length:
                break
            chain.append(node)
            covered += len(node.tokens)
            node = node.parent
        return chain

    # ---- matching ----------------------------------------------------------

    def match(self, tokens: Sequence[int], now: float = 0.0,
              update_stats: bool = False, instance: Optional[int] = None) -> MatchResult:
        """Longest-prefix match of ``tokens`` against the tree.

        ``per_instance_len`` reports, for every instance appearing on the
        matched path, the number of matched tokens that instance caches —
        this is what E2 uses to pick the exploit target (GPU with the
        longest cached prefix, Alg. 1).
        """
        node = self.root
        matched: List[RadixNode] = []
        i = 0
        per_inst: Dict[int, int] = {}
        per_host: Dict[int, int] = {}
        last_node: Optional[RadixNode] = None
        last_matched = 0

        def count(child: RadixNode, j: int) -> None:
            for inst in child.instances:
                per_inst[inst] = per_inst.get(inst, 0) + j
            for inst in child.host_instances:
                if inst not in child.instances:
                    per_host[inst] = per_host.get(inst, 0) + j

        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            span = child.tokens
            j = 0
            limit = min(len(span), len(tokens) - i)
            while j < limit and span[j] == tokens[i + j]:
                j += 1
            if j == 0:
                break
            last_node = child
            last_matched = j
            if j == len(span):
                matched.append(child)
                count(child, j)
                if update_stats:
                    child.last_access = now
                i += j
                node = child
                if j < limit or i == len(tokens):
                    if j < len(span):
                        break
                continue
            # partial match inside this child's span
            count(child, j)
            i += j
            break
        return MatchResult(
            matched_len=i,
            path=matched,
            last_node=last_node,
            last_node_matched=last_matched,
            per_instance_len=per_inst,
            per_instance_host_len=per_host,
        )

    def tiered_match(self, tokens: Sequence[int], instance: int,
                     now: float = 0.0, update_stats: bool = False
                     ) -> Tuple[MatchResult, int, int]:
        """Match + the two reusable prefix lengths for ``instance``:

        ``device_len`` — contiguous fully-matched prefix the instance
        caches on device (forkable page aliases; eviction is leaf-first,
        so device caching along a path is always a prefix of it);
        ``host_len`` — tokens contiguously *extending* device_len that
        the instance holds demoted in its host tier (restorable at
        restore_time instead of recompute). Returns (match, device_len,
        host_len)."""
        m = self.match(tokens, now=now, update_stats=update_stats)
        device_len = 0
        host_len = 0
        phase = "device"
        for node in m.path:
            span = len(node.tokens)
            if phase == "device":
                if instance in node.instances:
                    device_len += span
                    continue
                phase = "host"
            if instance in node.host_instances:
                host_len += span
            else:
                phase = "done"
                break
        # partial match inside the deepest touched node: admission will
        # split it at this boundary (insert), turning the partial span
        # into a full node — so it is reusable and counts here too
        if (phase != "done" and m.last_node is not None
                and device_len + host_len < m.matched_len
                and m.last_node_matched < len(m.last_node.tokens)):
            part = m.last_node_matched
            if phase == "device" and instance in m.last_node.instances:
                device_len += part
            elif instance in m.last_node.host_instances:
                host_len += part
        return m, device_len, host_len

    # ---- insertion ---------------------------------------------------------

    def insert(self, tokens: Sequence[int], instance: Optional[int] = None,
               now: float = 0.0, record: bool = True,
               touch: bool = True) -> List[RadixNode]:
        """Insert ``tokens``; splits partially-matched nodes (paper §3.2).

        Returns the full node path covering the sequence. If ``instance`` is
        given, marks every node on the path as cached there and (unless
        ``record=False`` — for re-inserts of an already-counted serve,
        e.g. the engine's post-prefill publish) records a window-H hit.
        ``touch=False`` skips the LRU last_access refresh — for purely
        STRUCTURAL inserts (a prefetch splitting a boundary ahead of
        admission) that must not count as a read of the path.
        """
        tokens = tuple(tokens)
        node = self.root
        i = 0
        path: List[RadixNode] = []
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                leaf = RadixNode(tokens[i:], node, node_id=next(self._ids))
                node.children[tokens[i]] = leaf
                self._register(leaf)
                path.append(leaf)
                i = len(tokens)
                break
            span = child.tokens
            j = 0
            limit = min(len(span), len(tokens) - i)
            while j < limit and span[j] == tokens[i + j]:
                j += 1
            if j == len(span):
                path.append(child)
                node = child
                i += j
                continue
            # split child at j: child keeps span[:j], new tail node gets span[j:]
            self._split(child, j)
            path.append(child)
            node = child
            i += j
            # loop continues: either insert remainder as new leaf or done
        for n in path:
            if touch:
                n.last_access = now
            if instance is not None:
                n.instances.add(instance)
                if record:
                    self.record_hit(n, instance, now)
        return path

    def _split(self, node: RadixNode, at: int) -> RadixNode:
        """Split ``node`` so it keeps tokens[:at]; tail becomes its child.

        Path-key maintenance is O(at) — the head's new key extends the
        parent's digest over tokens[:at]; the TAIL keeps the original
        key (its end boundary, hence its root→boundary content, is
        unchanged), so host-store entries / notifications in flight
        keyed by the old identity still name the same token range."""
        assert 0 < at < len(node.tokens)
        tail = RadixNode(node.tokens[at:], node, node_id=next(self._ids))
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.instances = set(node.instances)
        tail.host_instances = set(node.host_instances)
        tail.hit_times = {k: deque(v) for k, v in node.hit_times.items()}
        tail.last_access = node.last_access
        tail.ref_count = node.ref_count
        self._unregister(node)
        parent_key = node.parent.path_key
        node.tokens = node.tokens[:at]
        node.children = {tail.tokens[0]: tail}
        tail.path_key = node.path_key          # end boundary unchanged
        node.path_key = PathKey(
            extend_digest(parent_key.digest, node.tokens),
            parent_key.depth + at)
        self._register(node)
        self._register(tail)
        for hook in self.split_hooks:
            hook(node, tail)
        return tail

    # ---- window-H statistics ------------------------------------------------

    def record_hit(self, node: RadixNode, instance: int, now: float) -> None:
        dq = node.hit_times.setdefault(instance, deque())
        dq.append(now)
        self._trim(dq, now)

    def _trim(self, dq: deque, now: float) -> None:
        cutoff = now - self.window
        while dq and dq[0] < cutoff:
            dq.popleft()

    def hits_in_window(self, node: RadixNode, now: float,
                       instance: Optional[int] = None) -> int:
        if instance is not None:
            dq = node.hit_times.get(instance)
            if not dq:
                return 0
            self._trim(dq, now)
            return len(dq)
        total = 0
        for dq in node.hit_times.values():
            self._trim(dq, now)
            total += len(dq)
        return total

    # ---- instance bookkeeping ----------------------------------------------

    def remove_instance(self, node: RadixNode, instance: int) -> None:
        node.instances.discard(instance)
        node.hit_times.pop(instance, None)

    def drop_instance_everywhere(self, instance: int) -> int:
        """Instance failure: remove it from every node — both tiers (its
        host memory dies with it). Returns #nodes touched."""
        touched = 0
        for n in self.iter_nodes():
            if instance in n.instances or instance in n.host_instances:
                self.remove_instance(n, instance)
                n.host_instances.discard(instance)
                touched += 1
        return touched

    def prune_upward(self, node: RadixNode, now: float) -> int:
        """Scoped prune: remove ``node`` if it is a dead leaf (no
        caching instance, no pins, no window-H hits), then retry up the
        parent chain — O(depth), for hot paths where only these nodes'
        status changed (eviction notifications). ``prune_dead`` remains
        the full-forest fixpoint."""
        removed = 0
        while (node is not None and node.parent is not None
               and node.is_leaf() and not node.instances
               and not node.host_instances
               and node.ref_count == 0
               and self.hits_in_window(node, now) == 0):
            parent = node.parent
            del parent.children[node.tokens[0]]
            self._unregister(node)
            removed += 1
            node = parent
        return removed

    def prune_dead(self, now: float) -> int:
        """Remove leaf nodes with no caching instance and no window-H hits
        (paper §3.2 'we remove it from the tree'). Iterates to a fixpoint."""
        removed = 0
        changed = True
        while changed:
            changed = False
            for n in list(self.iter_nodes()):
                if (n.is_leaf() and not n.instances and not n.host_instances
                        and n.ref_count == 0
                        and self.hits_in_window(n, now) == 0 and n.parent is not None):
                    del n.parent.children[n.tokens[0]]
                    self._unregister(n)
                    removed += 1
                    changed = True
        return removed

    # ---- traversal ----------------------------------------------------------

    def iter_nodes(self) -> Iterator[RadixNode]:
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def nodes_cached_on(self, instance: int) -> List[RadixNode]:
        return [n for n in self.iter_nodes() if instance in n.instances]

    def cached_tokens(self, instance: int) -> int:
        return sum(len(n.tokens) for n in self.nodes_cached_on(instance))

    def subtree_nodes(self, node: RadixNode) -> List[RadixNode]:
        out = [node]
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    # ---- eviction (local-scheduler view) -------------------------------------

    def lru_eviction_order(self, instance: int) -> List[RadixNode]:
        """Leaf-first LRU order of this instance's cached nodes (§3.3):
        a node may only be evicted after all its cached descendants."""
        nodes = self.nodes_cached_on(instance)
        # depth ensures children sort before parents on timestamp ties
        return sorted(nodes, key=lambda n: (n.last_access, -n.depth_tokens()))

    def plan_eviction(self, instance: int, tokens_needed: int,
                      protected: Optional[Set[int]] = None) -> List[RadixNode]:
        """Pick nodes to evict (LRU, leaf-first) to free >= tokens_needed.

        ``protected`` node-ids (e.g. the match path of the incoming request)
        are skipped. Used both by the local scheduler to actually evict and
        by the global scheduler to *estimate* M_i (Alg. 2) without evicting.
        """
        protected = protected or set()
        freed = 0
        plan: List[RadixNode] = []
        planned: Set[int] = set()
        candidates = self.lru_eviction_order(instance)
        for n in candidates:
            if freed >= tokens_needed:
                break
            if n.node_id in protected or n.ref_count > 0:
                continue
            # cannot evict a node whose descendants are still cached here
            # unless those descendants are already in the plan
            blocked = False
            for d in self.subtree_nodes(n)[1:]:
                if instance in d.instances and d.node_id not in planned:
                    blocked = True
                    break
            if blocked:
                continue
            plan.append(n)
            planned.add(n.node_id)
            freed += len(n.tokens)
        return plan

    def evict(self, nodes: Iterable[RadixNode], instance: int) -> int:
        freed = 0
        for n in nodes:
            if instance in n.instances:
                self.remove_instance(n, instance)
                freed += len(n.tokens)
        return freed

    # ---- debug / stats -------------------------------------------------------

    def total_nodes(self) -> int:
        return sum(1 for _ in self.iter_nodes())

    def total_tokens(self) -> int:
        return sum(len(n.tokens) for n in self.iter_nodes())
