"""Bucketed continuous-batching engine over FAQ-quantized weights.

Slot-based continuous batching: bucketed batched prefill, a batched
sampler fused into each decode step (one int32 per slot crosses to the
host per step), and inactive-slot masking so a draining batch can never
advance a dead slot's cache length past ``max_len``.

The engine is a thin orchestrator over three parts: the
:class:`.slots.SlotTable` (host-side slot state), an
:class:`.admission.AdmissionPipeline` (prefix-hit, bucketed or
single-request admission) and a stepper (:mod:`.stepper`: model calls and
the device cache).  Dense and paged serving run the *same* ``serve()``
loop; ``paged=True`` plugs in the :class:`.stepper.PagedStepper` with
shared-prefix reuse, copy-on-write and page-pool backpressure (a step that
cannot get a page preempts a slot, :mod:`.overload`).

**Chunked prefill** (``prefill_chunk``, default ``"auto"``): a prompt
longer than the chunk is admitted as its first chunk through one
bucket-sized batched prefill; the remainder teacher-forces through the
batched decode step, one token per step, interleaved with every other
slot's decoding.  ``"auto"`` picks the second-largest bucket; ``0`` /
``None`` restores monolithic prefill.  Greedy outputs are token-for-token
identical either way.

The weights are the *packed* QuantizedTensor representation — every
quantized matmul runs through the dequant-matmul kernel on the card.

``spec=SpecConfig(k, draft)`` turns decode steps into speculative draft +
verify cycles (:mod:`.spec`) with greedy output unchanged.

``clock=`` injects the deadline clock (default ``time.time``).  Tensor
parallelism, SLO admission, fault injection and tracing arrive in later
slices; their constructor arguments raise ``NotImplementedError`` until
then.
"""
from __future__ import annotations

import inspect
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from .admission import AdmissionPipeline, ServeRun
from .buckets import bucket_for, default_buckets
from .overload import relieve_pressure
from .pages import PagePressure
from .slots import Request, effective_prompt, empty_tokens
from .stepper import DenseStepper, PagedStepper

__all__ = ["Request", "ServeEngine"]

_LATER = ("mesh", "slo", "faults", "tracer")


def _first_tensor(tree):
    for v in tree.values():
        if isinstance(v, dict):
            found = _first_tensor(v)
            if found is not None:
                return found
        elif isinstance(v, torch.Tensor):
            return v
    return None


class ServeEngine:
    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 512, buckets=None, rng_seed: int = 0,
                 prefill_chunk="auto", clock=None, device="cuda",
                 paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None, spec=None, mesh=None,
                 slo=None, faults=None, tracer=None):
        given = dict(mesh=mesh, slo=slo, faults=faults, tracer=tracer)
        for name in _LATER:
            if given[name]:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported yet")
        self.device = resolve_device(device)
        leaf = _first_tensor(params)
        if leaf is not None and leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.clock = clock if clock is not None else time.time
        self.n_slots = n_slots
        self.max_len = max_len
        self.cfg = model.cfg
        if buckets is None:
            self.buckets = default_buckets(max_len)
        else:
            # the largest bucket is always exactly max_len so every
            # admissible prompt has a bucket
            self.buckets = tuple(sorted({min(int(b), max_len)
                                         for b in buckets} | {max_len}))
        self._supports_plen = (
            "prompt_len" in inspect.signature(model.prefill).parameters)
        probe = getattr(model, "supports_paged", None)
        self.paged = bool(paged and self._supports_plen
                          and probe is not None and probe())
        self.generator = torch.Generator(device=self.device).manual_seed(
            rng_seed)

        # chunked prefill: "auto" = second-largest bucket (disabled when
        # the grid has one bucket); 0/None = monolithic; an explicit chunk
        # rounds *up* to the bucket grid.  Requires prompt_len prefill.
        if not self._supports_plen or not prefill_chunk:
            self.prefill_chunk = None
        elif prefill_chunk == "auto":
            self.prefill_chunk = (self.buckets[-2]
                                  if len(self.buckets) > 1 else None)
        else:
            self.prefill_chunk = bucket_for(self.buckets, int(prefill_chunk))

        self._stepper = (PagedStepper(self, page_size, n_pages)
                         if self.paged else DenseStepper(self))
        # speculative decoding: a model without the span-write decode path
        # serves non-speculatively
        self._spec = None
        probe_spec = getattr(model, "supports_spec", None)
        if spec is not None and probe_spec is not None and probe_spec():
            from .spec import SpecRunner
            self._spec = SpecRunner(self, spec)
        self._admission = AdmissionPipeline(self)
        self._m = dict(tokens_generated=0, decode_steps=0, prefill_batches=0,
                       admitted=0, completed=0, expired=0, truncated=0,
                       prefix_hits=0, prefix_hit_tokens=0, fill_steps=0,
                       chunked_admissions=0, serve_time_s=0.0, preempted=0,
                       resumed=0, pressure_events=0, shed=0)
        # one-iteration admission hold after a pressure-relieving preemption
        self._hold_fill = False

    # -- paged state -----------------------------------------------------------
    def _paged_stepper(self) -> PagedStepper:
        if not self.paged:
            raise AttributeError("dense engine has no paged state")
        return self._stepper

    @property
    def pool(self):
        return self._paged_stepper().pool

    @property
    def _store(self):
        return self._paged_stepper().store

    @property
    def page_size(self):
        return self._paged_stepper().page_size

    @property
    def n_pages(self):
        return self._paged_stepper().n_pages

    def _check_prompt(self, req: Request) -> int:
        n = int(np.asarray(req.prompt).shape[0])
        if n < 1:
            raise ValueError(f"req {req.rid}: empty prompt")
        limit = self.buckets[-1] if self._supports_plen else self.max_len
        if n > limit:
            raise ValueError(
                f"req {req.rid}: prompt length {n} exceeds {limit}")
        return n

    def _never_fits(self, req: Request) -> bool:
        """True when the (effective) prompt needs more pages than the whole
        pool: it can never bind, however long it waits."""
        need = self._stepper.pages_needed(len(effective_prompt(req)) + 1)
        return need is not None and not self._stepper.fits_pool(need)

    # -- single-request path -------------------------------------------------
    def generate(self, request: Request) -> np.ndarray:
        """Single-request generate: exact-length batch-1 prefill + batch-1
        decode through the same stepper bodies as the batched path."""
        self._check_prompt(request)
        if request.max_new_tokens <= 0:
            return empty_tokens()
        t0 = self.clock()
        stp = self._stepper
        policy = stp.policy_args([request.temperature], [request.top_k],
                                 [request.top_p])
        tok = torch.as_tensor(np.asarray(request.prompt, np.int32),
                              device=self.device)[None]
        nxt, cache = stp.prefill1(tok, policy)
        active = torch.ones((1,), dtype=torch.bool, device=self.device)
        out = [nxt]
        n_steps = min(request.max_new_tokens - 1,
                      self.max_len - len(request.prompt))
        for _ in range(n_steps):
            nxt, cache = stp.decode(cache, nxt, active, policy)
            self._m["decode_steps"] += 1
            out.append(nxt)
        toks = torch.cat(out).cpu().numpy().astype(np.int32)
        self._m["tokens_generated"] += len(toks)
        self._m["serve_time_s"] += self.clock() - t0
        return toks

    # -- per-request accounting ----------------------------------------------
    def _settle(self, req: Request, results: dict, out, counter: str):
        """Record a request's terminal outcome without a slot."""
        req.outcome = counter
        results[req.rid] = out
        self._m[counter] += 1
        if req.on_finish:
            req.on_finish(req.rid, out)

    def _handle_immediate(self, req: Request, results: dict) -> bool:
        """True if the request completes without ever taking a slot.  A
        deadline exactly at the admission instant still admits (the
        cutoff is strict ``>``).  A resumed preempted request that expires
        while re-queued keeps the tokens it already produced (truncated,
        not expired)."""
        if req.deadline is not None and self.clock() > req.deadline:
            out = (np.asarray(req.out_tokens, np.int32)
                   if req.resume and req.out_tokens else empty_tokens())
            self._settle(req, results, out,
                         "truncated" if len(out) else "expired")
            return True
        if req.max_new_tokens <= 0:
            self._settle(req, results, empty_tokens(), "completed")
            return True
        return False

    def _emit(self, req: Request, tok: int):
        req.out_tokens.append(tok)
        self._m["tokens_generated"] += 1
        if req.on_token:
            req.on_token(req.rid, tok)

    def _admit_bind(self, run: ServeRun, req: Request, s: int):
        if req.resume:
            self._m["resumed"] += 1
        if self._spec is not None:
            # an independent draft prefills the effective prompt (prompt
            # plus emitted tokens for a resumed request) into its own cache
            self._spec.admit_slot(s, effective_prompt(req))
        run.st.bind(req, s)
        req.resume = False
        self._m["admitted"] += 1
        if req.on_admit:
            req.on_admit(req.rid)

    def _post_admit(self, run: ServeRun, req: Request, s: int, tok: int):
        """First-token emission for a fully-prefilled admission (chunked
        admissions emit nothing until their fill drains)."""
        self._emit(req, tok)
        self._finish_checks(run, req, s, None)

    def _finish(self, run: ServeRun, s: int, counter: str = "completed"):
        st = run.st
        req = st.req[s]
        out = np.asarray(req.out_tokens, np.int32)
        run.results[req.rid] = out
        req.outcome = counter
        self._m[counter] += 1
        st.clear(s)
        self._stepper.retire(st, s)
        if req.on_finish:
            req.on_finish(req.rid, out)

    def _finish_checks(self, run: ServeRun, req: Request, s: int, now):
        if len(req.out_tokens) >= req.max_new_tokens:
            self._finish(run, s)
        elif now is not None and req.deadline is not None \
                and now > req.deadline:
            self._finish(run, s, counter="truncated")
        elif run.st.slot_len[s] >= self.max_len:
            self._finish(run, s, counter="truncated")

    # -- continuous-batching loop --------------------------------------------
    def serve(self, requests: List[Request] = ()) -> dict:
        """Run requests to completion with slot-based batching.

        Returns {rid: np.ndarray of generated tokens}.  Requests with
        ``max_new_tokens=0`` complete immediately with an empty sequence;
        requests whose ``deadline`` already passed at admission expire
        with an empty sequence; a running request whose deadline passes
        mid-decode is truncated at the tokens produced so far.  A queue
        head that needs more pages than the whole pool is shed (outcome
        ``"shed"``, an empty sequence) once no slot is active, and the
        others are served, as the reference's no-progress guard does.

        Page exhaustion never escapes this loop: a step (or an admission
        reservation) raising :class:`.pages.PagePressure` is relieved by
        preempting the latest-deadline slot and retrying.
        """
        t0 = self.clock()
        for r in requests:
            self._check_prompt(r)
        run = ServeRun(self, requests)
        st = run.st
        self._stepper.begin()
        while True:
            try:
                # a pressure-relieving preemption holds admission for one
                # iteration: the retried step gets first claim on the
                # freed pages (otherwise the loop would re-admit the victim
                # right back into the same shortage, a livelock)
                hold_fill, self._hold_fill = self._hold_fill, False
                if run.queue and st.free() and not hold_fill:
                    self._admission.fill_slots(run)
                if not st.any_active():
                    if run.queue and self._never_fits(run.queue[0]):
                        # no slot holds a page, so a head that cannot bind
                        # now never will: shed it (the reference's
                        # no-progress guard, its pool half)
                        req = run.queue.pop(0)
                        self._settle(req, run.results,
                                     np.asarray(req.out_tokens, np.int32)
                                     if req.out_tokens else empty_tokens(),
                                     "shed")
                        continue
                    if run.queue:
                        continue    # immediates drained; re-admit
                    break
                k_eff = self._spec_k(st)
                if k_eff >= 1:
                    self._spec_step(run, k_eff)
                else:
                    self._plain_step(run)
            except PagePressure as pp:
                self._hold_fill = relieve_pressure(self, run, pp)
        self._m["serve_time_s"] += self.clock() - t0
        return run.results

    def _plain_step(self, run: ServeRun):
        """One masked decode step + post-step bookkeeping (teacher-forced
        fill consumption, emission, finish checks)."""
        st = run.st
        self._stepper.plain_step(st)
        toks = st.slot_last.cpu().numpy()   # one int32 per slot per step
        self._m["decode_steps"] += 1
        now = self.clock()
        for s in range(self.n_slots):
            req = st.req[s]
            if req is None or not st.active[s]:
                continue
            st.slot_len[s] += 1
            if st.slot_len[s] > self.max_len:
                raise RuntimeError(f"slot {s}: cache len {st.slot_len[s]} "
                                   f"> max_len {self.max_len}")
            if st.fill[s] is not None:
                self._m["fill_steps"] += 1
                st.fill[s] = st.fill[s][1:]
                if len(st.fill[s]):
                    if req.deadline is not None and now > req.deadline:
                        self._finish(run, s, counter="truncated")
                    continue        # still prefilling this slot
                # fill done: this step consumed the last prompt token, so
                # the sampled token is the first output
                st.fill[s] = None
                self._stepper.fill_done(st, s)
            self._emit(req, int(toks[s]))
            self._finish_checks(run, req, s, now)

    def _spec_step(self, run: ServeRun, k_eff: int):
        """One speculative draft + verify burst and its emission; rejected
        suffixes roll back through the stepper hooks."""
        st = run.st
        out, n_acc = self._stepper.spec_cycle(st, k_eff)
        last = st.slot_last.cpu().numpy().copy()
        self._m["decode_steps"] += 1
        now = self.clock()
        for s in range(self.n_slots):
            req = st.req[s]
            if req is None or not st.active[s]:
                continue
            consumed = 0
            for i in range(int(n_acc[s]) + 1):
                consumed = i + 1
                st.slot_len[s] += 1
                if st.slot_len[s] > self.max_len:
                    raise RuntimeError(f"slot {s}: cache len "
                                       f"{st.slot_len[s]} > max_len "
                                       f"{self.max_len}")
                last[s] = int(out[s, i])
                self._emit(req, int(out[s, i]))
                self._finish_checks(run, req, s, now)
                if not st.active[s]:
                    break
            # draft proposals that reached the output (position n_acc is the
            # correction or bonus, not a proposal)
            self._spec.m["emitted_draft_tokens"] += min(consumed,
                                                        int(n_acc[s]))
            if st.active[s]:
                self._stepper.post_spec_slot(st, s)
        st.slot_last = torch.as_tensor(last, device=self.device)
        self._stepper.spec_rollback(st)

    def _spec_k(self, st) -> int:
        """Draft depth for this iteration: the configured k shrunk to the
        tightest active slot's cache room (a cycle writes k + 1 positions
        per slot) and to the largest remaining token budget (a deeper burst
        would be paid for and thrown away).  0 runs a plain decode step:
        near-capacity slots and prompt-filling slots (chunked or prefix
        hit) keep the truncation semantics of non-speculative serving."""
        if self._spec is None:
            return 0
        live = [s for s in range(self.n_slots) if st.active[s]]
        if any(st.fill[s] is not None for s in live):
            return 0
        room = min(self.max_len - int(st.slot_len[s]) for s in live)
        budget = max(st.req[s].max_new_tokens - len(st.req[s].out_tokens)
                     for s in live)
        return max(0, min(self._spec.cfg.k, room - 1, budget - 1))

    # -- observability -------------------------------------------------------
    def metrics(self) -> dict:
        """Counter snapshot (a plain dict) plus the engine's settings; a
        paged engine adds its pool's numbers.  ``peak_cache_bytes`` counts
        the peak of *pinned* pages (what a deployment would size
        ``n_pages`` from); ``alloc_cache_bytes`` is the whole store."""
        m = dict(self._m)
        m["tokens_per_step"] = (m["tokens_generated"]
                                / max(m["decode_steps"], 1))
        m["spec"] = self._spec is not None
        if self._spec is not None:
            m.update(self._spec.metrics())
            m["accept_rate"] = (m["accepted_tokens"]
                                / max(m["proposed_tokens"], 1))
            # share of emitted tokens the draft proposed (the rest are
            # first tokens and verify corrections or bonuses); counts the
            # emitted ones, since a burst cut by a budget accepts more
            m["draft_share"] = (m["emitted_draft_tokens"]
                                / max(m["tokens_generated"], 1))
        m["buckets"] = list(self.buckets)
        m["prefill_chunk"] = self.prefill_chunk or 0
        m["paged"] = self.paged
        if self.paged:
            pool = self.pool
            m["page_size"] = self.page_size
            m["pages_total"] = self.n_pages - 1      # minus the trash page
            m["pages_in_use"] = pool.pages_in_use()
            m["pages_peak"] = pool.in_use_peak
            m["page_bytes"] = self.page_bytes()
            m["peak_cache_bytes"] = pool.in_use_peak * self.page_bytes()
            m["alloc_cache_bytes"] = sum(leaf.numel() * leaf.element_size()
                                         for leaf in self._store.values())
            m["page_allocs"] = pool.alloc_count
            m["cow_copies"] = pool.cow_copies
            m["page_evictions"] = pool.evictions
            m["prefix_index_blocks"] = len(pool.index)
            m["prefix_lookups"] = pool.prefix_lookups
            m["prefix_block_hits"] = pool.prefix_block_hits
        return m

    def page_bytes(self) -> int:
        """Device bytes of one physical KV page (every leaf, all layers);
        0 for a dense engine."""
        if not self.paged:
            return 0
        return sum(leaf.numel() * leaf.element_size() // leaf.shape[1]
                   for leaf in self._store.values())
