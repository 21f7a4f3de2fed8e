"""Decode steppers: the prefill/decode core per cache kind.

A stepper owns the *device* half of serving — the model calls and the
persistent cache state they advance: the dense ``(n_slots, max_len)``
cache block for :class:`DenseStepper`, the page store +
:class:`.pages.PagePool` + per-slot page tables for :class:`PagedStepper`.
The engine's single serve loop drives either through one narrow
interface:

* ``begin()`` — reset per-serve device state (dense allocates a fresh
  cache; the page store persists so the prefix index keeps paying off),
* ``admit_group`` / ``admit_single`` — bucketed batched admission and the
  exact-length fallback for models without ``prompt_len`` prefill,
* ``plain_step`` — one masked decode step (teacher-forcing chunked /
  prefix-hit prompt tails from the slot table's ``fill`` lists),
* ``spec_cycle`` + ``post_spec_slot`` / ``spec_rollback`` — one
  speculative draft + verify burst and its rejected-suffix rollback
  (dense: length truncation; paged: returning exclusively owned pages past
  the accepted depth),
* ``retire`` / ``preempt`` / ``fill_done`` — slot lifecycle hooks (paged:
  release page refs / publish full blocks to the prefix index),
* ``reserve_admit`` / ``pages_needed`` / ``fits_pool`` /
  ``slot_overflows`` — the capacity side of the backpressure protocol
  (trivially satisfied dense),
* ``prefill1`` / ``decode`` — the dense bodies, also used by ``generate``.

Under a mesh the caches and page stores come from the engine
(``new_cache`` / ``new_paged_cache``: this rank's KV heads, its block of
slots when the slots are cut over ``data``), page tables stay whole on
every rank, and each page update stays local to the rank's heads.  A
step's logits of this rank's slots are gathered over ``data`` before the
sampler (``engine.gather_rows``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import instrument
from .cache_ops import (copy_page, merge_slots, scatter_prefill_pages,
                        truncate_slot, write_slot)
from .pages import PagePool, PagePressure, block_hashes
from .sampler import policy_in_use, sample_tokens
from .slots import SlotTable


class DenseStepper:
    """Serving core over one dense ``(n_slots, max_len)`` cache."""

    kind = "dense"

    def __init__(self, engine):
        self.engine = engine
        self.cache = None
        self.prefill_calls = 0      # model prefill calls (metrics())

    # -- lifecycle -----------------------------------------------------------
    def begin(self):
        eng = self.engine
        self.cache = eng.new_cache(eng.model, eng.n_local_slots, eng.max_len)

    def retire(self, st: SlotTable, s: int):
        pass

    def preempt(self, st: SlotTable, s: int):
        """Release the slot for eviction-and-resume.  Dense KV is a fixed
        block per slot — nothing to hand back; the resume's prefill
        recomputes it."""
        self.retire(st, s)

    def fill_done(self, st: SlotTable, s: int):
        pass

    # -- capacity (backpressure protocol; trivially satisfied dense) ---------
    def reserve_admit(self, counts):
        """Pre-own pages for a whole admission group before any slot binds
        (paged only)."""
        return None

    def pages_needed(self, n_tokens: int):
        """Pages a sequence of ``n_tokens`` needs, or None when the cache
        kind has no page concept."""
        return None

    def fits_pool(self, n_pages: int) -> bool:
        return True

    def slot_overflows(self, st: SlotTable, s: int) -> bool:
        """True when the slot's own next token can never be allocated (its
        sequence exceeds the whole pool): preempting it would livelock, so
        the engine truncates instead."""
        return False

    # -- bodies ----------------------------------------------------------------
    def policy_args(self, temps, top_k, top_p):
        """Device policy args, with top-k/top-p dropped to ``None`` when no
        row in the batch uses them (their full-vocab sorts would otherwise
        run every decode step)."""
        dev = self.engine.device
        use_tk, use_tp = policy_in_use(top_k, top_p)
        tk = torch.as_tensor(np.asarray(top_k), dtype=torch.int32,
                             device=dev) if use_tk else None
        tp = torch.as_tensor(np.asarray(top_p), dtype=torch.float32,
                             device=dev) if use_tp else None
        return (torch.as_tensor(np.asarray(temps), dtype=torch.float32,
                                device=dev), tk, tp)

    def _sample(self, logits, policy):
        temps, top_k, top_p = policy
        return sample_tokens(logits, temps, top_k, self.engine.generator,
                             top_p)

    def prefill1(self, tokens, policy):
        """Exact-length batch-1 prefill into a fresh cache; returns
        (first token (1,), cache)."""
        eng = self.engine
        cache = eng.new_cache(eng.model, 1, eng.max_len)
        self.prefill_calls += 1
        logits, cache = eng.model.prefill(eng.params, tokens, cache)
        return self._sample(logits[:, 0], policy), cache

    def decode(self, cache, slot_last, active, policy, rows=slice(None)):
        """One decode step with inactive slots masked.

        Inactive slots still flow through the batched matmuls (shape
        stability) but their ``len`` is restored afterwards and their
        in-bounds scratch write lands at a position attention masks out —
        a dead slot's cache length can never pass ``max_len``.  ``rows``
        are the slots ``cache`` holds (this rank's block when the slots
        are cut over ``data``): the step runs those rows and gathers their
        logits to every slot before the sampler."""
        eng = self.engine
        act = active[rows]
        old_len = cache["len"]
        safe_len = torch.where(act, old_len,
                               torch.clamp(old_len, max=eng.max_len - 1))
        logits, cache = eng.model.decode_step(eng.params,
                                              dict(cache, len=safe_len),
                                              slot_last[rows, None])
        cache = dict(cache, len=torch.where(act, cache["len"], old_len))
        logits = logits[:, 0]
        if rows != slice(None):
            logits = eng.gather_rows(logits)
        nxt = self._sample(logits, policy)
        return torch.where(active, nxt, slot_last), cache

    # -- admission entry points ----------------------------------------------
    def admit_group(self, st: SlotTable, tokens, plen, admit_mask, group,
                    reserved=None):
        """Batched bucketed prefill into a scratch cache, merged into the
        admitted slots; samples each admitted slot's first token."""
        eng = self.engine
        dev = eng.device
        rows = eng._rows
        mask = torch.as_tensor(admit_mask, device=dev)
        scratch = eng.new_cache(eng.model, eng.n_local_slots, eng.max_len)
        self.prefill_calls += 1
        logits, new = eng.model.prefill(
            eng.params, torch.as_tensor(tokens[rows], device=dev), scratch,
            torch.as_tensor(plen[rows], device=dev))
        self.cache = merge_slots(self.cache, new, mask[rows])
        first = self._sample(eng.gather_rows(logits[:, 0]),
                             self.policy_args(st.temps, st.top_k, st.top_p))
        st.slot_last = torch.where(mask, first, st.slot_last)

    def admit_single(self, st: SlotTable, req, s: int, eff):
        first, c1 = self.prefill1(
            torch.as_tensor(np.asarray(eff, np.int32),
                            device=self.engine.device)[None],
            self.policy_args([req.temperature], [req.top_k], [req.top_p]))
        self.cache = write_slot(self.cache, c1, s)
        st.slot_last = st.slot_last.clone()
        st.slot_last[s] = first[0]

    # -- decode-loop entry points --------------------------------------------
    def plain_step(self, st: SlotTable):
        eng = self.engine
        sl = st.input_tokens()
        if eng._spec is not None:
            # keep the independent draft's cache aligned through plain
            # fallback and fill steps (the self-draft shares the cache)
            eng._spec.track_step(sl, np.where(
                st.active, st.slot_len,
                np.minimum(st.slot_len, eng.max_len - 1)))
        st.slot_last, self.cache = self.decode(
            self.cache, sl, torch.as_tensor(st.active, device=eng.device),
            self.policy_args(st.temps, st.top_k, st.top_p), eng._rows)

    def spec_cycle(self, st: SlotTable, k_eff: int):
        """One speculative cycle; inactive slots' bursts start at a length
        clamped so that all k_eff + 1 writes stay inside the cache."""
        eng = self.engine
        lens = np.where(st.active, st.slot_len,
                        np.minimum(st.slot_len, eng.max_len - (k_eff + 1)))
        out, n_acc, self.cache = eng._spec.run_cycle(
            self.cache, lens, st.slot_last, st.active, st.temps, st.top_k,
            st.top_p, k_eff)
        return out, n_acc

    def post_spec_slot(self, st: SlotTable, s: int):
        pass

    def spec_rollback(self, st: SlotTable):
        """Republish the host lengths after a burst: rejected suffixes roll
        back by length alone."""
        self.cache = truncate_slot(self.cache,
                                   st.slot_len[self.engine._rows])


class PagedStepper(DenseStepper):
    """Serving core over the paged KV cache.

    Inherits the dense bodies (``generate`` uses them) and overrides the
    serve-loop hooks to run against the persistent page store.  The
    per-slot page ``table`` maps logical to physical pages; retired rows
    point at the trash page so masked writes can never touch a live page.
    """

    kind = "paged"

    def __init__(self, engine, page_size: int, n_pages):
        super().__init__(engine)
        eng = engine
        self.page_size = page_size
        self.pages_per_slot = -(-eng.max_len // page_size)
        # the default capacity means admission can never deadlock: every
        # slot can hold a full max_len sequence (+1 trash page)
        self.n_pages = (int(n_pages) if n_pages
                        else 1 + eng.n_slots * self.pages_per_slot)
        self.pool = PagePool(self.n_pages, page_size, faults=eng.faults,
                             registry=eng.registry)
        # persists across serve() calls so the prefix index keeps paying
        # off between bursts
        self.store = eng.new_paged_cache(self.n_pages, page_size)
        self.table = np.full((eng.n_slots, self.pages_per_slot),
                             PagePool.TRASH, np.int32)

    # -- lifecycle -----------------------------------------------------------
    def begin(self):
        pass    # the page store persists; slot tables were released at retire

    def retire(self, st: SlotTable, s: int):
        """Release the slot's page refs (index-held pages survive for
        cross-request reuse)."""
        for j in range(self.pages_per_slot):
            if self.table[s, j] != PagePool.TRASH:
                self.pool.decref(int(self.table[s, j]))
                self.table[s, j] = PagePool.TRASH

    def preempt(self, st: SlotTable, s: int):
        """Backpressure eviction: publish every *full* KV block — prompt and
        generated tokens alike — to the prefix index under the
        effective-sequence hash chain, then release the slot's refs.  The
        index refs keep those pages alive, so the resume's prefix-hit
        admission maps them straight back and only the partial tail block
        recomputes.  (Under continued pressure the registered pages are
        index-only and evictable, so publishing them cannot wedge the
        pool.)"""
        req = st.req[s]
        ps = self.page_size
        nfull = int(st.slot_len[s]) // ps
        if nfull:
            eff = np.concatenate([
                np.asarray(req.prompt, np.int32),
                np.asarray(req.out_tokens or [], np.int32)])
            hs = block_hashes(eff[:nfull * ps], ps)
            for j in range(nfull):
                if self.table[s, j] != PagePool.TRASH:
                    self.pool.register(hs[j], int(self.table[s, j]))
        self.retire(st, s)

    def fill_done(self, st: SlotTable, s: int):
        self.register_prompt_pages(st, s)

    # -- capacity (backpressure protocol) ------------------------------------
    def _take_page(self, slot=None) -> int:
        p = self.pool.try_alloc()
        if p is None:
            raise PagePressure(slot)
        return p

    def reserve_admit(self, counts):
        """Allocate every page an admission group needs up front; on
        failure release the partial reservation and raise
        :class:`.pages.PagePressure` with nothing bound.  Admission
        pre-checks ``pool.available()``, so this does not fail in
        practice."""
        got = []
        for c in counts:
            pages = []
            for _ in range(c):
                p = self.pool.try_alloc()
                if p is None:
                    for q in pages + [q for lst in got for q in lst]:
                        self.pool.decref(q)
                    raise PagePressure(None, c)
                pages.append(p)
            got.append(pages)
        return got

    def pages_needed(self, n_tokens: int):
        return self.pool.pages_for(n_tokens)

    def fits_pool(self, n_pages: int) -> bool:
        return n_pages <= self.n_pages - 1

    def slot_overflows(self, st: SlotTable, s: int) -> bool:
        return not self.fits_pool(
            self.pool.pages_for(int(st.slot_len[s]) + 1))

    # -- page bookkeeping ----------------------------------------------------
    def ensure_writable(self, s: int, pos: int):
        """Make the page holding position ``pos`` safe for slot ``s`` to
        write: allocate if unmapped, copy-on-write if shared with another
        slot or the prefix index.  Exhaustion raises
        :class:`.pages.PagePressure` for the engine to relieve by
        preemption."""
        lp = pos // self.page_size
        phys = int(self.table[s, lp])
        if phys == PagePool.TRASH:
            self.table[s, lp] = self._take_page(s)
            instrument.page_event(self.engine, "page_alloc", slot=s,
                                  block=lp)
        elif self.pool.is_shared(phys):
            fresh = self._take_page(s)
            copy_page(self.store, phys, fresh)
            self.pool.decref(phys)
            self.table[s, lp] = fresh
            self.pool.cow_copies += 1
            instrument.page_event(self.engine, "cow", slot=s, block=lp)

    def register_prompt_pages(self, st: SlotTable, s: int):
        """Publish the slot's hashed full blocks for future reuse (the index
        takes its own ref; partial tail blocks are never shared).
        ``st.hashes[s]`` covers the *effective* prompt — for a resumed
        request that includes its emitted tokens, so its blocks register
        under the chain they were published to at preemption."""
        for j in range(len(st.hashes[s])):
            self.pool.register(st.hashes[s][j], int(self.table[s, j]))

    # -- admission entry points ----------------------------------------------
    def admit_group(self, st: SlotTable, tokens, plen, admit_mask, group,
                    reserved=None):
        """Bucketed batched prefill into a dense scratch cache sized to the
        bucket (padded up to a page multiple), scattered into the pages
        pre-owned by :meth:`reserve_admit` (``reserved``, one page list per
        group member in order).  ``st.slot_len`` already holds each slot's
        admitted length; chunked slots defer prefix-index registration to
        ``fill_done``."""
        eng = self.engine
        dev = eng.device
        b = tokens.shape[1]
        ps = self.page_size
        n_scratch_pages = -(-b // ps)
        mask = torch.as_tensor(admit_mask, device=dev)
        scratch = eng.new_cache(eng.model, eng.n_slots, n_scratch_pages * ps)
        self.prefill_calls += 1
        logits, scratch = eng.model.prefill(
            eng.params, torch.as_tensor(tokens, device=dev), scratch,
            torch.as_tensor(plen, device=dev))
        first = self._sample(logits[:, 0],
                             self.policy_args(st.temps, st.top_k, st.top_p))
        st.slot_last = torch.where(mask, first, st.slot_last)
        all_ids = np.full((len(group), n_scratch_pages), PagePool.TRASH,
                          np.int32)
        for gi, (req, s) in enumerate(group):
            phys = reserved[gi]
            assert len(phys) == -(-int(st.slot_len[s]) // ps)
            all_ids[gi, :len(phys)] = phys
            self.table[s, :len(phys)] = phys
        scatter_prefill_pages(self.store, scratch, [s for _, s in group],
                              all_ids)
        for req, s in group:
            if st.fill[s] is None:
                self.register_prompt_pages(st, s)

    def admit_single(self, st: SlotTable, req, s: int, eff):
        raise NotImplementedError(
            "paged serving requires prompt_len prefill")

    # -- decode-loop entry point ---------------------------------------------
    def plain_step(self, st: SlotTable):
        """One decode step against the page store.  Retired slots decode at
        a clamped length through trash-page table rows, so their masked
        write can never touch a live page."""
        eng = self.engine
        dev = eng.device
        lens = np.minimum(st.slot_len, eng.max_len - 1)
        for s in range(eng.n_slots):
            if st.active[s]:
                lens[s] = st.slot_len[s]
                self.ensure_writable(s, int(st.slot_len[s]))
        slot_last = st.input_tokens()
        if eng._spec is not None:
            # align the independent draft's cache through fill and fallback
            # steps (it sees the same token stream)
            eng._spec.track_step(slot_last, lens)
        active = torch.as_tensor(st.active, device=dev)
        logits, self.store = eng.model.decode_step_paged(
            eng.params, self.store, slot_last[:, None],
            torch.as_tensor(self.table, device=dev),
            torch.as_tensor(lens.astype(np.int32), device=dev))
        nxt = self._sample(logits[:, 0],
                           self.policy_args(st.temps, st.top_k, st.top_p))
        st.slot_last = torch.where(active, nxt, slot_last)

    def spec_cycle(self, st: SlotTable, k_eff: int):
        """Paged speculative cycle: own every page the burst writes
        (allocate, or copy-on-write) first, then draft + verify."""
        eng = self.engine
        lens = np.minimum(st.slot_len, eng.max_len - (k_eff + 1))
        for s in range(eng.n_slots):
            if not st.active[s]:
                continue
            lens[s] = st.slot_len[s]
            for pos in range(int(st.slot_len[s]),
                             int(st.slot_len[s]) + k_eff + 1):
                self.ensure_writable(s, pos)
        out, n_acc, self.store = eng._spec.run_cycle(
            self.store, lens, st.slot_last, st.active, st.temps, st.top_k,
            st.top_p, k_eff, table=self.table)
        return out, n_acc

    def post_spec_slot(self, st: SlotTable, s: int):
        """Rejected-suffix rollback: pages wholly past the accepted depth
        were allocated (or copied) for this burst and are exclusively owned;
        shared prefix pages all sit below ``slot_len``."""
        ps = self.page_size
        trimmed = 0
        for j in range(self.pages_per_slot):
            phys = int(self.table[s, j])
            if phys != PagePool.TRASH and j * ps >= st.slot_len[s]:
                if self.pool.is_shared(phys):
                    raise RuntimeError(f"slot {s}: page {phys} past the "
                                       f"accepted depth is shared")
                self.pool.decref(phys)
                self.table[s, j] = PagePool.TRASH
                trimmed += 1
        if trimmed:
            instrument.page_event(self.engine, "page_trim", slot=s,
                                  pages=trimmed)

    def spec_rollback(self, st: SlotTable):
        pass    # per-slot page trim happens in post_spec_slot
