"""Batched token sampling for the serve loop.

One call samples the whole decode batch: greedy, temperature, top-k and
top-p (nucleus) are all per-slot, so mixed-policy batches share one pass
and the decode loop moves one int32 per slot per step to the host.
Random draws come from an explicit ``torch.Generator`` (the port does not
reproduce ``jax.random`` streams).  :func:`policy_probs`,
:func:`draw_from_probs` and :func:`spec_accept` are the speculative
decoder's explicit-distribution form of the same policy.
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


def policy_probs(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: Optional[torch.Tensor] = None,
                 top_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-row sampling policy as an explicit (B, V) distribution:
    softmax of the temperature-scaled, top-k/top-p-masked logits for
    sampling rows, and an exact one-hot at the argmax for greedy rows
    (``temperature <= 0``) — the distribution :func:`sample_tokens` draws
    from, materialized so the speculative accept rule can take p(x)/q(x).
    ``top_k``/``top_p`` may be ``None`` when no row uses them."""
    logits = logits.float()
    onehot = torch.zeros_like(logits).scatter_(
        -1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    masked = logits if top_k is None else _apply_top_k(logits, top_k)
    scaled = masked / torch.clamp(temperature, min=1e-6)[:, None]
    if top_p is not None:
        scaled = _apply_top_p(scaled, top_p)
    probs = torch.softmax(scaled, dim=-1)
    return torch.where((temperature > 0)[:, None], probs, onehot)


def draw_from_probs(probs: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of ``probs`` (last axis), int32.
    Zero-probability entries are excluded exactly (``log 0 = -inf``), so a
    one-hot row draws its hot index."""
    u = torch.rand(probs.shape, generator=generator,
                   device=probs.device).clamp(min=1e-20)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(torch.log(probs) + gumbel, dim=-1).to(torch.int32)


def spec_accept(draft_tokens: torch.Tensor,
                draft_probs: Optional[torch.Tensor],
                target_logits: torch.Tensor, temperature: torch.Tensor,
                top_k: Optional[torch.Tensor], top_p: Optional[torch.Tensor],
                generator: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leftover-probability rejection sampling over one speculative burst.

    draft_tokens (B, K) int32: the proposals d_1..d_K; draft_probs (B, K,
    V): the draft policy each was drawn from (``None`` when every row is
    greedy); target_logits (B, K+1, V): verify logits, position i the
    target's next-token distribution after the last committed token and
    d_1..d_i; temperature/top_k/top_p (B,): the per-slot policy.

    Returns ``(out (B, K+1), n_accept (B,))``, both int32: d_{i+1} is
    accepted with probability ``min(1, p_i(d)/q_i(d))``; the first rejected
    position resamples from ``norm(max(p - q, 0))``; if all K are accepted
    a bonus token is drawn from the target's last position.  The emitted
    burst is ``out[:, :n_accept + 1]``.  A greedy row (one-hot p and q)
    accepts while the draft equals the target argmax and then emits the
    target argmax, so greedy output equals non-speculative decoding; a
    batch of greedy rows takes that rule directly, with no random draws.
    """
    b, k = draft_tokens.shape
    draft_tokens = draft_tokens.to(torch.int32)
    idx = torch.arange(k + 1, device=draft_tokens.device)[None, :]
    padded = torch.cat([draft_tokens, torch.zeros(
        (b, 1), dtype=torch.int32, device=draft_tokens.device)], dim=1)
    if not bool((temperature > 0).any()):
        target = torch.argmax(target_logits.float(), dim=-1).to(torch.int32)
        hit = (draft_tokens == target[:, :k]).to(torch.int32)
        n_accept = torch.cumprod(hit, dim=1).sum(dim=1).to(torch.int32)
        out = torch.where(idx < n_accept[:, None], padded, target)
        return out, n_accept
    v = target_logits.shape[-1]
    rep = lambda a: None if a is None else a.repeat_interleave(k + 1)
    p = policy_probs(target_logits.reshape(b * (k + 1), v),
                     rep(temperature), rep(top_k), rep(top_p)) \
        .reshape(b, k + 1, v)
    d = draft_tokens.long()[..., None]
    px = p[:, :k].gather(-1, d)[..., 0]                        # (B, K)
    qx = draft_probs.gather(-1, d)[..., 0]                     # (B, K)
    u = torch.rand((b, k), generator=generator, device=p.device)
    # accept iff u < p/q  <=>  u*q < p (q(x) > 0 since x ~ q); a greedy row
    # has one-hot q, so this is exactly "draft == target argmax"
    accept = (u * qx) < px
    n_accept = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1) \
        .to(torch.int32)
    # leftover distribution per position; empty when p == q, and then only
    # read if rejected, which p == q cannot be — guard the division anyway
    res = torch.clamp(p[:, :k] - draft_probs, min=0.0)
    norm = res.sum(dim=-1, keepdim=True)
    res = torch.where(norm > 0, res / torch.clamp(norm, min=1e-30), p[:, :k])
    resampled = draw_from_probs(res.reshape(b * k, v), generator) \
        .reshape(b, k)
    bonus = draw_from_probs(p[:, k], generator)
    corrections = torch.cat([resampled, bonus[:, None]], dim=1)
    out = torch.where(idx < n_accept[:, None], padded, corrections)
    return out.to(torch.int32), n_accept
