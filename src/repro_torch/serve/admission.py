"""Admission strategies over the shared slot table.

One pipeline, strategies tried in order per free-slot pass:

* :class:`PrefixHitAdmission` (paged only) — the head request's leading
  prompt blocks are already in the prefix index: map the shared pages,
  skip their prefill, stream the uncached tail through the decode step
  via the slot's ``fill`` list.
* :class:`BucketedAdmission` — group FIFO-ordered waiting requests that
  share the head request's length bucket and prefill them in one
  slot-aligned batch.  With chunked prefill enabled, a long prompt is
  admitted as its first ``prefill_chunk`` tokens (one bucket-sized
  batched prefill) and the remainder teacher-forces through subsequent
  decode steps — a long admission never stalls the decode batch for
  more than one chunk.  On the paged path, queued requests whose first
  block duplicates a group member's are deferred one pass so they hit the
  index instead of prefilling the same prefix twice.
* :class:`SingleAdmission` — exact-length batch-1 fallback for models
  whose ``prefill`` takes no ``prompt_len``; chunking is then disabled.

Strategies mutate only the :class:`.slots.SlotTable` and the stepper (via
its admission entry points); emission, accounting, and finish checks stay
in the engine.
"""
from __future__ import annotations

import numpy as np

from .buckets import bucket_for
from .pages import PagePressure, block_hashes
from .slots import SlotTable, effective_prompt


class PrefixHitAdmission:
    def __init__(self, engine):
        self.engine = engine

    def admit(self, run, free) -> bool:
        eng = self.engine
        st, stp = run.st, eng._stepper
        head = run.queue[0]
        eff = effective_prompt(head)
        hashes = run.hashes_of(head)
        if not stp.pool.lookup_blocks(hashes):
            return False
        # prefix hit: map the shared pages, skip their prefill, stream the
        # tail through decode.  A resumed preempted request lands here by
        # design — its blocks were registered at preemption, so only the
        # partial tail block recomputes.
        run.queue.pop(0)
        s = free[0]
        matched = stp.pool.match(hashes)
        # always leave >= 1 token to process so the first sampled token has
        # logits; a fully cached prompt re-feeds its last token (the write
        # into the shared final page is what triggers copy-on-write)
        cached = min(len(matched) * stp.page_size, len(eff) - 1)
        for j, phys in enumerate(matched):
            stp.table[s, j] = phys
        eng._admit_bind(run, head, s)
        st.hashes[s] = hashes
        st.slot_len[s] = cached
        st.fill[s] = eff[cached:]
        eng._m["prefix_hits"] += 1
        eng._m["prefix_hit_tokens"] += cached
        return True


class BucketedAdmission:
    def __init__(self, engine):
        self.engine = engine

    def admit(self, run, free) -> bool:
        """Admit a bucket group from the queue head into ``free`` slots.
        Returns True if it made progress."""
        eng = self.engine
        st, stp = run.st, eng._stepper
        queue = run.queue
        paged = stp.kind == "paged"
        chunk = eng.prefill_chunk

        def admit_len(n: int) -> int:
            return min(n, chunk) if chunk else n

        progress = False
        while queue and eng._handle_immediate(queue[0], run.results):
            queue.pop(0)
            progress = True
        if not queue:
            return progress
        head = queue[0]
        b = bucket_for(eng.buckets, admit_len(len(effective_prompt(head))))
        group, seen_block0 = [], set()
        # paged capacity pre-check: never bind more prompt pages than the
        # pool can produce right now (free + evictable)
        pages_left = stp.pool.available() if paged else 0
        i = 0
        while i < len(queue) and len(group) < len(free):
            r = queue[i]
            if eng._handle_immediate(r, run.results):
                queue.pop(i)
                progress = True
                continue
            eff = effective_prompt(r)
            al = admit_len(len(eff))
            hs = run.hashes_of(r) if paged else None
            if paged and r is not head and hs and (
                    stp.pool.lookup_blocks(hs) or hs[0] in seen_block0):
                i += 1
                continue
            if bucket_for(eng.buckets, al) != b or (
                    paged and stp.pool.pages_for(al) > pages_left):
                i += 1
                continue
            if paged:
                pages_left -= stp.pool.pages_for(al)
                if hs:
                    seen_block0.add(hs[0])
            group.append((queue.pop(i), hs, eff))
        if not group:
            return progress
        reserved = None
        if paged:
            try:
                reserved = stp.reserve_admit(
                    [stp.pool.pages_for(admit_len(len(eff)))
                     for (_, _, eff) in group])
            except PagePressure:
                # nothing was bound: re-queue the group, let the engine
                # relieve the pressure
                for (r, _, _) in reversed(group):
                    queue.insert(0, r)
                raise
        tokens = np.zeros((st.n, b), np.int32)
        plen = np.ones(st.n, np.int32)
        admit_mask = np.zeros(st.n, bool)
        placed = []
        for (req, hs, eff), s in zip(group, free):
            al = admit_len(len(eff))
            tokens[s, :al] = eff[:al]
            plen[s] = al
            admit_mask[s] = True
            eng._admit_bind(run, req, s)
            st.hashes[s] = hs
            st.slot_len[s] = al
            if al < len(eff):
                # chunked admission: the rest of the prompt teacher-forces
                # through decode; no token emits until the fill drains
                # (the first token sampled below is a mid-prompt
                # continuation, discarded)
                st.fill[s] = eff[al:]
                eng._m["chunked_admissions"] += 1
            placed.append((req, s))
        stp.admit_group(st, tokens, plen, admit_mask, placed, reserved)
        eng._m["prefill_batches"] += 1
        toks = st.slot_last.cpu().numpy()
        for req, s in placed:
            if st.fill[s] is None:
                eng._post_admit(run, req, s, int(toks[s]))
        return True


class SingleAdmission:
    def __init__(self, engine):
        self.engine = engine

    def admit(self, run, free) -> bool:
        eng = self.engine
        st = run.st
        progress, req = False, None
        while run.queue:
            cand = run.queue.pop(0)
            if eng._handle_immediate(cand, run.results):
                progress = True
                continue
            req = cand
            break
        if req is None:
            return progress
        s = free[0]
        eff = effective_prompt(req)
        eng._admit_bind(run, req, s)
        st.slot_len[s] = len(eff)
        eng._stepper.admit_single(st, req, s, eff)
        eng._m["prefill_batches"] += 1
        eng._post_admit(run, req, s, int(st.slot_last[s]))
        return True


class AdmissionPipeline:
    """Orders the strategies for the engine's cache kind and drains the
    queue into free slots until neither slots nor admissible requests
    remain."""

    def __init__(self, engine):
        self.engine = engine
        if engine._stepper.kind == "paged":
            self.strategies = [PrefixHitAdmission(engine),
                               BucketedAdmission(engine)]
        elif engine._supports_plen:
            self.strategies = [BucketedAdmission(engine)]
        else:
            self.strategies = [SingleAdmission(engine)]

    def fill_slots(self, run):
        eng = self.engine
        while True:
            free = run.st.free()
            if not free or not run.queue:
                return
            while run.queue and eng._handle_immediate(run.queue[0],
                                                      run.results):
                run.queue.pop(0)
            if not run.queue:
                continue
            for strat in self.strategies:
                if strat.admit(run, free):
                    break
            else:
                return


class ServeRun:
    """Per-``serve()`` scope: the FIFO queue, the results dict, the slot
    table, and the prompt-hash memo (hashes are deterministic per request:
    computed once, not once per fill pass)."""

    def __init__(self, engine, requests):
        self.queue = list(requests)
        self.results: dict = {}
        self.st = SlotTable(engine.n_slots, engine.device)
        self._engine = engine
        self._hash_cache: dict = {}

    def hashes_of(self, req) -> list:
        """Block hashes of the request's *effective* prompt.  The memo key
        includes the effective length: a preempted request comes back with
        its emitted tokens folded into the prompt, so its chain grows
        between admissions and a stale entry would miss the pages
        registered at preemption."""
        eff = effective_prompt(req)
        ent = self._hash_cache.get(id(req))
        if ent is None or ent[0] is not req or ent[1] != len(eff):
            ent = (req, len(eff),
                   block_hashes(eff, self._engine._stepper.page_size))
            self._hash_cache[id(req)] = ent
        return ent[2]
