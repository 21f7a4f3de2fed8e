"""Bucketed continuous-batching engine over FAQ-quantized weights.

Slot-based continuous batching: bucketed batched prefill, a batched
sampler fused into each decode step (one int32 per slot crosses to the
host per step), and inactive-slot masking so a draining batch can never
advance a dead slot's cache length past ``max_len``.

The engine is a thin orchestrator over three parts: the
:class:`.slots.SlotTable` (host-side slot state), an
:class:`.admission.AdmissionPipeline` (bucketed or single-request
admission) and the :class:`.stepper.DenseStepper` (model calls and the
device cache).

**Chunked prefill** (``prefill_chunk``, default ``"auto"``): a prompt
longer than the chunk is admitted as its first chunk through one
bucket-sized batched prefill; the remainder teacher-forces through the
batched decode step, one token per step, interleaved with every other
slot's decoding.  ``"auto"`` picks the second-largest bucket; ``0`` /
``None`` restores monolithic prefill.  Greedy outputs are token-for-token
identical either way.

The weights are the *packed* QuantizedTensor representation — every
quantized matmul runs through the dequant-matmul kernel on the card.

``clock=`` injects the deadline clock (default ``time.time``).  The
paged cache, speculative decoding, tensor parallelism, SLO admission,
fault injection and tracing arrive in later slices; their constructor
arguments raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import inspect
import time
from typing import List

import numpy as np
import torch

from repro_torch.device import resolve_device
from .admission import AdmissionPipeline, ServeRun
from .buckets import bucket_for, default_buckets
from .slots import Request, empty_tokens
from .stepper import DenseStepper

__all__ = ["Request", "ServeEngine"]

_LATER = ("paged", "spec", "mesh", "slo", "faults", "tracer")


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
                 paged: bool = False, spec=None, mesh=None, slo=None,
                 faults=None, tracer=None):
        given = dict(paged=paged, spec=spec, mesh=mesh, slo=slo,
                     faults=faults, tracer=tracer)
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

        self._stepper = DenseStepper(self)
        self._admission = AdmissionPipeline(self)
        self._m = dict(tokens_generated=0, decode_steps=0, prefill_batches=0,
                       admitted=0, completed=0, expired=0, truncated=0,
                       fill_steps=0, chunked_admissions=0, serve_time_s=0.0)

    def _check_prompt(self, req: Request) -> int:
        n = int(np.asarray(req.prompt).shape[0])
        if n < 1:
            raise ValueError(f"req {req.rid}: empty prompt")
        limit = self.buckets[-1] if self._supports_plen else self.max_len
        if n > limit:
            raise ValueError(
                f"req {req.rid}: prompt length {n} exceeds {limit}")
        return n

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
        cutoff is strict ``>``)."""
        if req.deadline is not None and self.clock() > req.deadline:
            self._settle(req, results, empty_tokens(), "expired")
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
        run.st.bind(req, s)
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
        mid-decode is truncated at the tokens produced so far.
        """
        t0 = self.clock()
        for r in requests:
            self._check_prompt(r)
        run = ServeRun(self, requests)
        st = run.st
        self._stepper.begin()
        while True:
            if run.queue and st.free():
                self._admission.fill_slots(run)
            if not st.any_active():
                if run.queue:
                    continue        # immediates drained; re-admit
                break
            self._plain_step(run)
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
            self._emit(req, int(toks[s]))
            self._finish_checks(run, req, s, now)

    # -- observability -------------------------------------------------------
    def metrics(self) -> dict:
        """Counter snapshot (a plain dict) plus the engine's settings."""
        m = dict(self._m)
        m["buckets"] = list(self.buckets)
        m["prefill_chunk"] = self.prefill_chunk or 0
        return m
