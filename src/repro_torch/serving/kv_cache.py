"""Paged KV cache pool — host-side page accounting (vLLM-style, adapted
to TPU alignment).

Pages are fixed-size token blocks. TPU adaptation: the default page size
is 128 tokens so a page's KV forms whole 128-wide MXU tiles when the
Pallas kernels stream pages HBM->VMEM (GPU systems use 16-token blocks
tuned for warp-level gather; that granularity would waste MXU tiles).

Shared prompt prefixes are *ref-counted*: when two sequences share a
prefix, the shared pages appear in both page tables with refcount 2, and
a sequence forks copy-on-write at its first divergent page. Freeing a
sequence decrements refcounts; pages hit the free list at zero.

The pool tracks *token capacity* for the local scheduler's admission and
eviction logic; the device tensors live with the engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class PageTable:
    """One sequence's ordered page list + length bookkeeping."""
    seq_id: int
    pages: List[int] = field(default_factory=list)
    num_tokens: int = 0          # valid tokens across the pages

    def last_page_room(self, page_size: int) -> int:
        if not self.pages:
            return 0
        used = self.num_tokens - (len(self.pages) - 1) * page_size
        return page_size - used


class PagedKVPool:
    def __init__(self, num_pages: int, page_size: int = 128):
        assert page_size % 128 == 0 or page_size in (8, 16, 32, 64), \
            "page size should be MXU-tile friendly"
        self.num_pages = num_pages
        self.page_size = page_size
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.refcount: Dict[int, int] = {}
        self.tables: Dict[int, PageTable] = {}
        # pages permanently out of circulation (e.g. an engine's scratch
        # page that padded decode lanes write into); owned by no table
        self.reserved: Set[int] = set()

    # ---- capacity ------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self.free)

    def free_tokens(self) -> int:
        return self.free_pages * self.page_size

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    # ---- allocation ----------------------------------------------------

    def create(self, seq_id: int) -> PageTable:
        assert seq_id not in self.tables, f"seq {seq_id} exists"
        t = PageTable(seq_id)
        self.tables[seq_id] = t
        return t

    def _alloc_page(self) -> int:
        if not self.free:
            raise MemoryError("KV pool exhausted")
        p = self.free.pop()
        self.refcount[p] = 1
        return p

    def reserve_page(self) -> int:
        """Permanently take one page out of circulation and return its
        id. Reserved pages belong to no sequence and are never freed."""
        p = self._alloc_page()
        self.reserved.add(p)
        return p

    def can_append(self, seq_id: int, tokens: int) -> bool:
        t = self.tables[seq_id]
        need = self.pages_for(max(tokens - t.last_page_room(self.page_size),
                                  0))
        return need <= self.free_pages

    def append(self, seq_id: int, tokens: int) -> List[int]:
        """Extend a sequence by ``tokens``; returns newly allocated pages.
        Copy-on-write: if the tail page is shared, it is copied first."""
        t = self.tables[seq_id]
        new_pages: List[int] = []
        room = t.last_page_room(self.page_size)
        if tokens > 0 and room > 0 and t.pages \
                and self.refcount[t.pages[-1]] > 1:
            # CoW the shared partial tail page
            old = t.pages[-1]
            cp = self._alloc_page()
            self.refcount[old] -= 1
            t.pages[-1] = cp
            new_pages.append(cp)
        remaining = max(tokens - room, 0)
        for _ in range(self.pages_for(remaining)):
            p = self._alloc_page()
            t.pages.append(p)
            new_pages.append(p)
        t.num_tokens += tokens
        return new_pages

    # ---- prefix sharing --------------------------------------------------

    def fork(self, parent_id: int, child_id: int,
             shared_tokens: Optional[int] = None) -> PageTable:
        """Create ``child`` sharing the parent's first ``shared_tokens``
        (default: all). Shared pages are refcounted, not copied."""
        parent = self.tables[parent_id]
        if shared_tokens is None:
            shared_tokens = parent.num_tokens
        shared_tokens = min(shared_tokens, parent.num_tokens)
        # only whole shared pages are reusable without CoW; the partial
        # boundary page is shared too (CoW on first append).
        n_pages = self.pages_for(shared_tokens) if shared_tokens else 0
        child = self.create(child_id)
        child.pages = parent.pages[:n_pages]
        child.num_tokens = shared_tokens
        for p in child.pages:
            self.refcount[p] += 1
        return child

    # ---- freeing ----------------------------------------------------------

    def release(self, seq_id: int) -> int:
        """Free a sequence; returns pages actually returned to the pool."""
        t = self.tables.pop(seq_id, None)
        if t is None:
            return 0
        freed = 0
        for p in t.pages:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                del self.refcount[p]
                self.free.append(p)
                freed += 1
        return freed

    def trim(self, seq_id: int, keep_tokens: int) -> int:
        """Shrink a sequence to its first ``keep_tokens`` (partial
        eviction of a radix-tree node tail). Returns pages freed."""
        t = self.tables[seq_id]
        keep_pages = self.pages_for(keep_tokens) if keep_tokens else 0
        freed = 0
        for p in t.pages[keep_pages:]:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                del self.refcount[p]
                self.free.append(p)
                freed += 1
        t.pages = t.pages[:keep_pages]
        t.num_tokens = min(t.num_tokens, keep_tokens)
        return freed

    # ---- invariants (property tests) ---------------------------------------

    def check_invariants(self) -> None:
        live: Dict[int, int] = {}
        for p in self.reserved:
            live[p] = 1
        for t in self.tables.values():
            assert t.num_tokens <= len(t.pages) * self.page_size
            for p in t.pages:
                assert p not in self.reserved, "reserved page in a table"
                live[p] = live.get(p, 0) + 1
        assert live == self.refcount, (live, self.refcount)
        assert len(self.free) + len(self.refcount) == self.num_pages
        assert not (set(self.free) & set(self.refcount)), "page both free+live"
