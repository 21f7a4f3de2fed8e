"""Admission strategies over the shared slot table.

One pipeline, tried per free-slot pass:

* :class:`BucketedAdmission` — group FIFO-ordered waiting requests that
  share the head request's length bucket and prefill them in one
  slot-aligned batch.  With chunked prefill enabled, a long prompt is
  admitted as its first ``prefill_chunk`` tokens (one bucket-sized
  batched prefill) and the remainder teacher-forces through subsequent
  decode steps — a long admission never stalls the decode batch for
  more than one chunk.
* :class:`SingleAdmission` — exact-length batch-1 fallback for models
  whose ``prefill`` takes no ``prompt_len``; chunking is then disabled.

Prefix-hit admission arrives with the paged KV cache.  Strategies mutate
only the :class:`.slots.SlotTable` and the stepper (via its admission
entry points); emission, accounting, and finish checks stay in the
engine.
"""
from __future__ import annotations

import numpy as np

from .buckets import bucket_for
from .slots import SlotTable, effective_prompt


class BucketedAdmission:
    def __init__(self, engine):
        self.engine = engine

    def admit(self, run, free) -> bool:
        """Admit a bucket group from the queue head into ``free`` slots.
        Returns True if it made progress."""
        eng = self.engine
        st, stp = run.st, eng._stepper
        queue = run.queue
        chunk = eng.prefill_chunk

        def admit_len(n: int) -> int:
            return min(n, chunk) if chunk else n

        progress = False
        while queue and eng._handle_immediate(queue[0], run.results):
            queue.pop(0)
            progress = True
        if not queue:
            return progress
        b = bucket_for(eng.buckets, admit_len(len(effective_prompt(queue[0]))))
        group = []
        i = 0
        while i < len(queue) and len(group) < len(free):
            r = queue[i]
            if eng._handle_immediate(r, run.results):
                queue.pop(i)
                progress = True
                continue
            eff = effective_prompt(r)
            if bucket_for(eng.buckets, admit_len(len(eff))) != b:
                i += 1
                continue
            group.append((queue.pop(i), eff))
        if not group:
            return progress
        tokens = np.zeros((st.n, b), np.int32)
        plen = np.ones(st.n, np.int32)
        admit_mask = np.zeros(st.n, bool)
        placed = []
        for (req, eff), s in zip(group, free):
            al = admit_len(len(eff))
            tokens[s, :al] = eff[:al]
            plen[s] = al
            admit_mask[s] = True
            eng._admit_bind(run, req, s)
            st.slot_len[s] = al
            if al < len(eff):
                # chunked admission: the rest of the prompt teacher-forces
                # through decode; no token emits until the fill drains
                # (the first token sampled below is a mid-prompt
                # continuation, discarded)
                st.fill[s] = eff[al:]
                eng._m["chunked_admissions"] += 1
            placed.append((req, s))
        stp.admit_group(st, tokens, plen, admit_mask)
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
    """Picks the strategy for the engine's model and drains the queue into
    free slots until neither slots nor admissible requests remain."""

    def __init__(self, engine):
        self.engine = engine
        self.strategy = (BucketedAdmission(engine) if engine._supports_plen
                         else SingleAdmission(engine))

    def fill_slots(self, run):
        while True:
            free = run.st.free()
            if not free or not run.queue:
                return
            if not self.strategy.admit(run, free):
                return


class ServeRun:
    """Per-``serve()`` scope: the FIFO queue, the results dict and the
    slot table."""

    def __init__(self, engine, requests):
        self.queue = list(requests)
        self.results: dict = {}
        self.st = SlotTable(engine.n_slots, engine.device)
