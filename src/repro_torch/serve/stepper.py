"""Decode stepper: the prefill/decode core over one dense cache block.

The stepper owns the *device* half of serving — the model calls and the
persistent ``(n_slots, max_len)`` cache they advance.  The engine's serve
loop drives it through a narrow interface:

* ``begin()`` — allocate a fresh cache for a serve run,
* ``admit_group`` / ``admit_single`` — bucketed batched admission and the
  exact-length fallback for models without ``prompt_len`` prefill,
* ``plain_step`` — one masked decode step (teacher-forcing chunked prompt
  tails from the slot table's ``fill`` lists),
* ``prefill1`` / ``decode`` — the bodies, also used by ``generate``.

The paged stepper arrives with the paged KV cache.
"""
from __future__ import annotations

import numpy as np
import torch

from .cache_ops import merge_slots, write_slot
from .sampler import policy_in_use, sample_tokens
from .slots import SlotTable


class DenseStepper:
    """Serving core over one dense ``(n_slots, max_len)`` cache."""

    def __init__(self, engine):
        self.engine = engine
        self.cache = None

    def begin(self):
        eng = self.engine
        self.cache = eng.model.init_cache(eng.n_slots, eng.max_len,
                                          device=eng.device)

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
        cache = eng.model.init_cache(1, eng.max_len, device=eng.device)
        logits, cache = eng.model.prefill(eng.params, tokens, cache)
        return self._sample(logits[:, 0], policy), cache

    def decode(self, cache, slot_last, active, policy):
        """One decode step with inactive slots masked.

        Inactive slots still flow through the batched matmuls (shape
        stability) but their ``len`` is restored afterwards and their
        in-bounds scratch write lands at a position attention masks out —
        a dead slot's cache length can never pass ``max_len``."""
        eng = self.engine
        old_len = cache["len"]
        safe_len = torch.where(active, old_len,
                               torch.clamp(old_len, max=eng.max_len - 1))
        logits, cache = eng.model.decode_step(eng.params,
                                              dict(cache, len=safe_len),
                                              slot_last[:, None])
        cache = dict(cache, len=torch.where(active, cache["len"], old_len))
        nxt = self._sample(logits[:, 0], policy)
        return torch.where(active, nxt, slot_last), cache

    # -- admission entry points ----------------------------------------------
    def admit_group(self, st: SlotTable, tokens, plen, admit_mask):
        """Batched bucketed prefill into a scratch cache, merged into the
        admitted slots; samples each admitted slot's first token."""
        eng = self.engine
        dev = eng.device
        mask = torch.as_tensor(admit_mask, device=dev)
        scratch = eng.model.init_cache(eng.n_slots, eng.max_len, device=dev)
        logits, new = eng.model.prefill(
            eng.params, torch.as_tensor(tokens, device=dev), scratch,
            torch.as_tensor(plen, device=dev))
        self.cache = merge_slots(self.cache, new, mask)
        first = self._sample(logits[:, 0],
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

    # -- decode-loop entry point ---------------------------------------------
    def plain_step(self, st: SlotTable):
        eng = self.engine
        st.slot_last, self.cache = self.decode(
            self.cache, st.input_tokens(),
            torch.as_tensor(st.active, device=eng.device),
            self.policy_args(st.temps, st.top_k, st.top_p))
