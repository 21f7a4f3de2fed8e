"""Paged KV-cache block pool: allocator, refcounts, prefix index.

The dense cache allocates ``n_slots * max_len`` KV positions up front, so
memory scales with the worst-case request and identical prompt prefixes
are prefilled once per request.  The paged cache fixes both: the physical
cache is a pool of fixed-size pages, each slot maps logical token blocks
to physical pages through a per-slot page table, and a prefix index keyed
on chained token-block hashes lets requests that share a prompt prefix
map their leading pages to the *same* physical blocks.

Everything here is host-side bookkeeping (plain Python / numpy over int
page ids); the device page store and its writes live in
``models/dense.py`` and ``serve/cache_ops.py``, its reads in the paged
flash-decode kernel.  The counters are plain ints.

Invariants:

* Physical page 0 is the **trash page**: never allocated, permanently
  pinned.  Unmapped page-table entries point at it, so masked writes from
  inactive slots land somewhere harmless.
* ``ref[p]`` counts owners: each slot mapping the page holds one ref, and
  a prefix-index entry holds one ref.  A page returns to the free list
  only at refcount zero.
* A slot only ever *writes* a page it owns exclusively (refcount 1 and
  unregistered); the engine copies-on-write before any divergent write
  into a shared page.
* Index entries whose page has no other owner are evictable: allocation
  falls back to dropping one of them when the free list is empty, so the
  prefix cache can never deadlock the pool.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np


class PoolExhausted(RuntimeError):
    """Terminal pool exhaustion for *direct* :meth:`PagePool.alloc`
    callers (tests, offline tools).  The serve path never raises this:
    the stepper allocates through :meth:`PagePool.try_alloc` and turns a
    ``None`` into :class:`PagePressure`, which the engine resolves by
    preempting a slot."""


class PagePressure(Exception):
    """Backpressure signal: a serve-path page allocation could not be
    satisfied right now.  Not an error — the engine catches it, preempts
    a slot and retries the step.  ``slot`` is the slot that needed the
    page (None during admission reservation)."""

    def __init__(self, slot: Optional[int] = None, needed: int = 1):
        super().__init__(f"page pressure (slot={slot}, needed={needed})")
        self.slot = slot
        self.needed = needed


def block_hashes(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Chained hash per full token block: ``h[i] = sha1(h[i-1] || block_i)``
    over the blocks' int32 bytes.

    Chaining makes each hash identify the whole prefix up to and including
    block ``i``, so one dict lookup per block walks the shared-prefix
    chain.  Only *full* blocks are hashed — a partial tail block is never
    shared.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: List[bytes] = []
    h = b""
    for i in range(len(toks) // page_size):
        h = hashlib.sha1(h + toks[i * page_size:(i + 1) * page_size]
                         .tobytes()).digest()
        out.append(h)
    return out


class PagePool:
    """Fixed-capacity page allocator with refcounts and a prefix index."""

    TRASH = 0

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least the trash page plus one "
                             f"allocatable page, got n_pages={n_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        # pop() hands out ascending ids (cosmetic; readable tests and logs)
        self.free = list(range(n_pages - 1, 0, -1))
        self.ref = np.zeros(n_pages, np.int64)
        self.ref[self.TRASH] = 1          # pinned forever
        self.index: dict = {}             # block hash -> phys page
        self._page_hash: dict = {}        # phys page -> block hash
        self.alloc_count = 0
        self.cow_copies = 0
        self.evictions = 0
        self.prefix_lookups = 0
        self.prefix_block_hits = 0
        self.in_use_peak = 0

    # -- capacity ------------------------------------------------------------
    def pages_in_use(self) -> int:
        return self.n_pages - 1 - len(self.free)

    def evictable(self) -> int:
        """Prefix-index pages with no other owner — reclaimable on demand
        by :meth:`try_alloc`'s eviction fallback."""
        return sum(1 for p in self.index.values() if self.ref[p] == 1)

    def available(self) -> int:
        """Pages an allocator could obtain right now (free list plus
        index-only evictables).  Admission checks this *before* binding
        slots, so a group reservation cannot fail from a miscounted
        capacity."""
        return len(self.free) + self.evictable()

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.page_size)

    def try_alloc(self) -> Optional[int]:
        """Take a fresh page (refcount 1), or ``None`` when the pool is
        exhausted after the index-eviction fallback.  This is the *only*
        allocator on the serve path: exhaustion goes through the engine's
        backpressure protocol instead of an exception."""
        if not self.free and not self._evict_one():
            return None
        p = self.free.pop()
        self.ref[p] = 1
        self.alloc_count += 1
        self.in_use_peak = max(self.in_use_peak, self.pages_in_use())
        return p

    def alloc(self) -> int:
        """:meth:`try_alloc` for direct callers outside the serve loop;
        raises :class:`PoolExhausted` instead of returning ``None``."""
        p = self.try_alloc()
        if p is None:
            raise PoolExhausted(  # repro: noqa[RPR008] the protocol's own terminal path — the serve stepper calls try_alloc and never reaches this
                f"page pool exhausted ({self.n_pages - 1} pages, "
                f"page_size={self.page_size}); raise n_pages")
        return p

    def _evict_one(self) -> bool:
        """Drop one prefix-index entry whose page has no other owner."""
        for h, p in list(self.index.items()):
            if self.ref[p] == 1:
                self._unregister(h, p)
                self.ref[p] = 0
                self.free.append(p)
                self.evictions += 1
                return True
        return False

    # -- refcounts -----------------------------------------------------------
    def incref(self, p: int):
        assert p != self.TRASH
        self.ref[p] += 1

    def decref(self, p: int):
        assert p != self.TRASH and self.ref[p] > 0, (p, self.ref[p])
        self.ref[p] -= 1
        if self.ref[p] == 0:
            h = self._page_hash.get(p)
            if h is not None:       # defensive; the index normally holds a ref
                self._unregister(h, p)
            self.free.append(p)

    # -- prefix index --------------------------------------------------------
    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest cached prefix: physical pages for the leading blocks
        whose hash chain is indexed.  The caller owns one ref per returned
        page (already incref'd here)."""
        out: List[int] = []
        self.prefix_lookups += 1
        for h in hashes:
            p = self.index.get(h)
            if p is None:
                break
            out.append(p)
        for p in out:
            self.incref(p)
        self.prefix_block_hits += len(out)
        return out

    def lookup_blocks(self, hashes: Sequence[bytes]) -> int:
        """Non-acquiring :meth:`match`: how many leading blocks are cached
        right now (admission grouping only)."""
        n = 0
        for h in hashes:
            if h not in self.index:
                break
            n += 1
        return n

    def register(self, h: bytes, p: int):
        """Publish page ``p`` as the block for hash ``h``.  The index holds
        its own ref, so the page survives slot retirement until evicted.
        First registration wins; re-registering is a no-op."""
        if p == self.TRASH or h in self.index:
            return
        self.index[h] = p
        self._page_hash[p] = h
        self.incref(p)

    def _unregister(self, h: bytes, p: int):
        del self.index[h]
        del self._page_hash[p]

    def is_shared(self, p: int) -> bool:
        """True if writing ``p`` needs copy-on-write first: another slot or
        the prefix index also owns it."""
        return p != self.TRASH and self.ref[p] > 1
