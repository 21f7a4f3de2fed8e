"""Calibration pass: collect per-site activation statistics.

FAQ (like AWQ, unlike GPTQ) needs only full-precision activations, so a
single forward pass over the calibration set yields the statistics for
*every* block at once — including the future-layer statistics FAQ previews.
After this pass, quantization of each layer is independent.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from .stats import merge_stats


@torch.no_grad()
def run_calibration(apply_fn: Callable, params, batches: Iterable) -> dict:
    """Run ``apply_fn(params, batch, collect_stats=True)`` over batches.

    ``apply_fn`` must return ``(logits, aux)`` with ``aux["stats"]`` mapping
    ``site_key -> {"mean_abs": (L, d), "mean_sq": (L, d), "sample": (L, K, d)}``.
    Batches may hold numpy arrays; they are moved to the device of
    ``params["embed"]``.

    Returns the token-weighted average of the stats across batches.
    """
    device = params["embed"].device
    acc = None
    acc_tokens = 0.0
    for i, batch in enumerate(batches):
        batch = {k: torch.as_tensor(np.asarray(v), device=device)
                 for k, v in batch.items()}
        stats = apply_fn(params, batch, collect_stats=True)[1]["stats"]
        tokens = float(_batch_tokens(batch))
        if acc is None:
            acc, acc_tokens = stats, tokens
        else:
            acc = merge_stats(acc, stats, acc_tokens, tokens, batch_index=i)
            acc_tokens += tokens
    if acc is None:
        raise ValueError("empty calibration set")
    return acc


def _batch_tokens(batch) -> int:
    leaf = batch.get("tokens", next(iter(batch.values())))
    n = 1
    for s in leaf.shape[:2]:
        n *= s
    return n
