"""Speculative decoding: draft K, verify in one pass, accept, roll back.

One speculative *cycle* replaces one decode step of the engine loop:

1. **Draft** — the draft source (:mod:`.draft`) runs K sequential decode
   steps, proposing ``d_1..d_K`` per slot under each slot's own sampling
   policy.  The self-draft writes its speculative K/V straight into the
   target's cache or pages (overwritten in step 2); an independent draft
   uses its own dense cache plus one alignment step, so its cache stays
   complete when the whole burst is accepted.
2. **Verify** — the target scores all K+1 positions in one forward
   (``verify_step`` / ``verify_step_paged``): each slot's burst starts at
   its own length, so slots at different depths share the batch, and the
   attention of every layer is one T-query launch whose row i gives the
   bits of the decode step at that position.
3. **Accept** — :func:`.sampler.spec_accept` emits ``n_accept + 1``
   tokens per slot; greedy rows reduce to "accept while the draft equals
   the target argmax", so greedy output equals non-speculative decoding.
4. **Rollback** — the stepper truncates the per-slot lengths
   (:func:`.cache_ops.truncate_slot`) and, paged, returns the exclusively
   owned pages past the accepted depth.

The cycle runs eagerly (the reference jits one program per (k, cache
kind)); the engine picks k per iteration from the tightest slot's room.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .buckets import bucket_for
from .cache_ops import write_slot
from .sampler import draw_from_probs, policy_probs, spec_accept


@dataclasses.dataclass
class SpecConfig:
    """Engine-level speculative decoding configuration: ``k`` is the draft
    depth (tokens proposed per cycle; up to ``k + 1`` emitted), ``draft`` a
    draft source (:class:`~repro_torch.serve.draft.SelfDraft` or
    :class:`~repro_torch.serve.draft.ModelDraft`)."""
    k: int = 3
    draft: Any = None


class SpecRunner:
    """Owns the draft's state and runs the speculative cycles."""

    def __init__(self, engine, cfg: SpecConfig):
        if cfg.draft is None:
            raise ValueError("SpecConfig.draft must be a draft source "
                             "(serve.draft.SelfDraft / ModelDraft)")
        if cfg.k < 1:
            raise ValueError(f"spec k must be >= 1, got {cfg.k}")
        self.engine = engine
        self.cfg = cfg
        self.draft = cfg.draft
        self.dmodel = (self.draft.model if self.draft.model is not None
                       else engine.model)
        dv = getattr(self.dmodel.cfg, "vocab_size", None)
        tv = engine.model.cfg.vocab_size
        if dv != tv:
            # fail fast: the accept rule compares the two distributions
            # elementwise, and draft token ids would index the wrong rows
            raise ValueError(f"draft vocab_size {dv} != target vocab_size "
                             f"{tv}; the accept/resample rule compares the "
                             "two distributions elementwise")
        self.shares = bool(getattr(self.draft, "shares_cache", False))
        if engine.mesh is not None:
            # the draft's weights on the engine's mesh, cut along the draft
            # model's own logical axes (its steps run on local heads, as the
            # target's); the caller's draft keeps its whole weights
            self.draft = dataclasses.replace(
                self.draft, params=engine.place(self.draft.params,
                                                self.dmodel))
        self.dcache = None
        if not self.shares:
            self.dcache = engine.new_cache(self.dmodel, engine.n_slots,
                                           engine.max_len)
        self.m = engine.registry.group("spec").init(
            spec_cycles=0, draft_steps=0, proposed_tokens=0,
            accepted_tokens=0, emitted_draft_tokens=0)

    # -- admission and plain-step tracking ------------------------------------
    def admit_slot(self, slot: int, prompt):
        """Prefill the independent draft's cache row for a fresh slot (the
        self-draft shares the target's prefill: nothing to do), padded to
        the engine's bucket grid."""
        if self.shares:
            return
        eng = self.engine
        p = np.asarray(prompt, np.int32)
        tokens = np.zeros((1, bucket_for(eng.buckets, len(p))), np.int32)
        tokens[0, :len(p)] = p
        _, c1 = self.dmodel.prefill(
            self.draft.params, torch.as_tensor(tokens, device=eng.device),
            eng.new_cache(self.dmodel, 1, eng.max_len),
            torch.as_tensor([len(p)], dtype=torch.int32, device=eng.device))
        self.dcache = write_slot(self.dcache, c1, slot)

    def track_step(self, last: torch.Tensor, lens):
        """Advance the independent draft's cache through one *plain* decode
        step of the engine (a near-capacity slot, or a slot teacher-forcing
        its prompt tail), so it holds no holes at those positions.  ``last``
        (B,) is the step's input token, ``lens`` the pre-step per-slot
        lengths (inactive slots already clamped).  The self-draft shares the
        target's cache: nothing to track."""
        if self.shares:
            return
        dc = dict(self.dcache, len=torch.as_tensor(
            np.asarray(lens, np.int32), device=self.engine.device))
        _, self.dcache = self.dmodel.decode_step(self.draft.params, dc,
                                                 last[:, None])
        self.m["draft_steps"] += 1

    # -- the cycle --------------------------------------------------------------
    def _draft_burst(self, step, carry, last, policy, sampling, k):
        """K sequential draft steps; ``step(carry, tok, j)`` advances the
        draft one token and returns ``(logits (B, 1, V), carry)``.  Returns
        (tokens (B, K) int32, their policy distributions (B, K, V) or None
        when every row is greedy, carry)."""
        temps, top_k, top_p = policy
        gen = self.engine.generator
        tok = last
        toks, qs = [], []
        for j in range(k):
            logits, carry = step(carry, tok, j)
            if sampling:
                q = policy_probs(logits[:, 0], temps, top_k, top_p)
                tok = draw_from_probs(q, gen)
                qs.append(q)
            else:
                tok = torch.argmax(logits[:, 0].float(), dim=-1) \
                    .to(torch.int32)
            toks.append(tok)
        return (torch.stack(toks, dim=1),
                torch.stack(qs, dim=1) if sampling else None, carry)

    def _independent_burst(self, last, lens, policy, sampling, k):
        """The independent draft's K steps and its alignment step (if the
        whole burst is accepted the draft must also hold d_K's K/V; the
        proposal that step yields is discarded)."""
        dparams = self.draft.params
        step = lambda c, tok, j: self.dmodel.decode_step(dparams, c,
                                                         tok[:, None])
        d_toks, d_qs, dc = self._draft_burst(
            step, dict(self.dcache, len=lens), last, policy, sampling, k)
        _, self.dcache = self.dmodel.decode_step(dparams, dc,
                                                 d_toks[:, -1:])
        return d_toks, d_qs

    def run_cycle(self, kv, lens, last, active, temps, top_k, top_p, k: int,
                  table=None):
        """One speculative cycle on the dense cache ``kv`` (``table`` None)
        or on the page store ``kv`` behind ``table`` (every page the burst
        writes already exclusively owned).  ``lens`` (B,) are the host
        lengths before the burst (inactive slots clamped so that a burst
        stays inside the cache), ``last`` (B,) the last committed tokens
        (device), ``active`` and the policy rows host arrays.  Returns host
        arrays (out (B, k+1), n_accept (B,), 0 for inactive slots) and
        ``kv``; a dense cache comes back with ``len`` advanced by k+1 (the
        caller truncates it)."""
        eng = self.engine
        policy = eng._stepper.policy_args(temps, top_k, top_p)
        sampling = bool((np.asarray(temps) > 0).any())
        lens = torch.as_tensor(np.asarray(lens, np.int32), device=eng.device)
        if table is not None:
            table = torch.as_tensor(table, dtype=torch.int32,
                                    device=eng.device)
        dparams = self.draft.params
        if not self.shares:
            d_toks, d_qs = self._independent_burst(last, lens, policy,
                                                   sampling, k)
        elif table is None:
            step = lambda c, tok, j: self.dmodel.decode_step(dparams, c,
                                                             tok[:, None])
            d_toks, d_qs, _ = self._draft_burst(
                step, dict(kv, len=lens), last, policy, sampling, k)
        else:
            # the self-draft's K/V goes straight into the target's pages;
            # verify overwrites it
            step = lambda st, tok, j: self.dmodel.decode_step_paged(
                dparams, st, tok[:, None], table, lens + j)
            d_toks, d_qs, _ = self._draft_burst(step, kv, last, policy,
                                                sampling, k)
        vt = torch.cat([last[:, None].to(torch.int32), d_toks], dim=1)
        if table is None:
            vlogits, kv = eng.model.verify_step(eng.params,
                                                dict(kv, len=lens), vt)
        else:
            vlogits, kv = eng.model.verify_step_paged(eng.params, kv, vt,
                                                      table, lens)
        out, n_acc = spec_accept(d_toks, d_qs, vlogits, *policy,
                                 eng.generator)
        n_acc = np.where(active, n_acc.cpu().numpy(), 0)
        self.m["spec_cycles"] += 1
        self.m["draft_steps"] += k + (0 if self.shares else 1)
        self.m["proposed_tokens"] += k * int(np.asarray(active).sum())
        self.m["accepted_tokens"] += int(n_acc.sum())
        return out.cpu().numpy(), n_acc, kv

    def metrics(self) -> dict:
        m = dict(self.m)
        m["spec_k"] = self.cfg.k
        m["draft_kind"] = (f"self-int{getattr(self.draft, 'bits', 8)}"
                           if self.shares else "model")
        return m
