"""Batched token sampling for the serve loop.

One call samples the whole decode batch: greedy, temperature, top-k and
top-p (nucleus) are all per-slot, so mixed-policy batches share one pass
and the decode loop moves one int32 per slot per step to the host.
Random draws come from an explicit ``torch.Generator``; the speculative
accept/resample step arrives with speculative decoding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask all but each row's k highest logits (k=0 disables)."""
    v = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(desc, -1,
                       torch.clamp(top_k.long() - 1, 0, v - 1)[:, None])
    use_topk = (top_k > 0)[:, None]
    return torch.where(use_topk & (logits < kth), -torch.inf, logits)


def _apply_top_p(scaled: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask on already temperature-scaled logits.

    Keeps, per row, the smallest set of highest-probability tokens whose
    cumulative probability reaches ``top_p`` (the top-1 token always
    survives).  ``top_p <= 0`` or ``>= 1`` disables the mask for that row.
    """
    probs = torch.softmax(scaled, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True)
    csum = torch.cumsum(sorted_p, dim=-1)
    # token i (sorted) stays while the mass *before* it is < top_p
    keep_sorted = (csum - sorted_p) < top_p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    active = ((top_p > 0.0) & (top_p < 1.0))[:, None]
    return torch.where(active & ~keep, -torch.inf, scaled)


def policy_in_use(top_k, top_p) -> Tuple[bool, bool]:
    """Host-side "does any row use top-k / top-p" predicates (the single
    source of the disable semantics: ``top_k <= 0``, ``top_p <= 0`` or
    ``>= 1``)."""
    tk, tp = np.asarray(top_k), np.asarray(top_p)
    return bool((tk > 0).any()), bool(((tp > 0) & (tp < 1)).any())


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: Optional[torch.Tensor],
                  generator: Optional[torch.Generator],
                  top_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample one token per batch row.

    logits: (B, V) — may carry the -1e30 padded-vocab mask; masked columns
    have probability zero and are never the argmax.
    temperature: (B,) f32 — ``<= 0`` means greedy for that row.
    top_k: (B,) int32 — ``0`` disables top-k for that row (``None``: no
    row uses it).  top_p: optional (B,) f32 nucleus threshold.
    generator: the draws' ``torch.Generator`` (unused when every row is
    greedy, so greedy serving makes no random draws).

    Returns (B,) int32.
    """
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    do_sample = temperature > 0
    if not bool(do_sample.any()):
        return greedy
    masked = logits if top_k is None else _apply_top_k(logits, top_k)
    scaled = masked / torch.clamp(temperature, min=1e-6)[:, None]
    if top_p is not None:
        scaled = _apply_top_p(scaled, top_p)
    # greedy rows skip the (potentially inf-scaled) division result
    scaled = torch.where(do_sample[:, None], scaled, 0.0)
    # Gumbel-max: argmax(logits + Gumbel noise) is a categorical draw
    u = torch.rand(scaled.shape, generator=generator,
                   device=scaled.device).clamp(min=1e-20)   # in (0, 1)
    gumbel = -torch.log(-torch.log(u))
    drawn = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(do_sample, drawn, greedy)
