"""Cache-admission ops for the serve engine.

Cache trees share one batch convention: the ``len`` leaf is ``(B,)`` and
every other leaf is ``(L, B, ...)`` — batch on axis 1.  Both ops rely only
on that convention.  They update the batched cache in place (the
reference's functional updates return a copy of the whole cache).
"""
from __future__ import annotations

import torch


def _batch_axis(leaf: torch.Tensor) -> int:
    return 0 if leaf.dim() == 1 else 1


def write_slot(batched_cache: dict, single_cache: dict, slot: int) -> dict:
    """Write a batch-1 cache into slot ``slot`` of the batched cache
    (in place); returns ``batched_cache``."""
    for key, b in batched_cache.items():
        s = single_cache[key]
        if _batch_axis(b) == 0:
            b[slot] = s[0].to(b.dtype)
        else:
            b[:, slot] = s[:, 0].to(b.dtype)
    return batched_cache


def merge_slots(cache: dict, new_cache: dict, admit_mask: torch.Tensor) -> dict:
    """Per-slot select between two same-shape caches, in place.

    Rows where ``admit_mask`` (B,) bool is True are copied from
    ``new_cache`` (the freshly prefilled scratch) into ``cache``; the
    other rows (live slots) are untouched.  Returns ``cache``."""
    rows = torch.nonzero(admit_mask).reshape(-1)
    for key, old in cache.items():
        new = new_cache[key]
        if _batch_axis(old) == 0:
            old[rows] = new[rows].to(old.dtype)
        else:
            old[:, rows] = new[:, rows].to(old.dtype)
    return cache
