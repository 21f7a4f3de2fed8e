"""Cache-admission ops for the serve engine.

Dense cache trees share one batch convention: the ``len`` leaf is
``(B,)`` and every other leaf is ``(L, B, ...)`` — batch on axis 1;
:func:`write_slot` and :func:`merge_slots` rely only on that.  Page stores
have leaves ``(L, P, KH, ps, d)``; :func:`scatter_prefill_pages` and
:func:`copy_page` move whole pages.  Every op updates its target in place
(the reference's functional updates return a copy of the whole cache).
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


def scatter_prefill_pages(store: dict, scratch: dict, slots,
                          phys_ids) -> dict:
    """Copy the prefilled rows of one admission group from the dense
    scratch cache into their freshly allocated physical pages, in place.

    ``store`` leaves are (L, P, KH, ps, d); ``scratch`` leaves (L, B, KH,
    S, d) with S a multiple of ps, plus a ``len`` leaf the store does not
    carry.  ``slots`` (G,) are the scratch rows, ``phys_ids`` (G, S // ps)
    their pages; entries past a prompt's last page point at the trash page,
    which absorbs the padded tail.  One indexed copy per leaf."""
    for key, st in store.items():
        sc = scratch[key]
        n_layers, _, kh, s, d = sc.shape
        ps = st.shape[3]
        ids = torch.as_tensor(phys_ids, dtype=torch.long,
                              device=st.device).reshape(-1)
        rows = sc[:, torch.as_tensor(slots, dtype=torch.long,
                                     device=sc.device)]  # (L, G, KH, S, d)
        blocks = rows.reshape(n_layers, -1, kh, s // ps, ps, d) \
            .permute(0, 1, 3, 2, 4, 5).reshape(n_layers, -1, kh, ps, d)
        st[:, ids] = blocks.to(st.dtype)
    return store


def copy_page(store: dict, src: int, dst: int) -> dict:
    """Copy-on-write: duplicate physical page ``src`` into ``dst`` across
    every leaf of the page store, in place."""
    for st in store.values():
        st[:, dst] = st[:, src]
    return store


def truncate_slot(cache: dict, new_lens) -> dict:
    """Roll per-slot cache lengths back to ``new_lens`` (B,).

    The speculative verify writes K+1 fresh entries per slot and advances
    ``len`` by K+1; after the accept step the engine truncates each slot to
    its accepted depth.  Entries past ``len`` are invisible to the
    length-masked attention, so the rejected suffix needs no scrubbing (the
    next burst overwrites it).  Only ``len`` changes; the returned dict
    shares every other leaf with ``cache``."""
    dev = cache["len"].device
    return dict(cache, len=torch.as_tensor(new_lens, dtype=torch.int32,
                                           device=dev).reshape(-1))
