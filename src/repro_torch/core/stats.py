"""Per-site activation statistics collected during the calibration pass.

Models call :func:`site_stat` on the input activation of every quantizable
linear site.  The layer loop stacks the per-layer dicts, so per-layer
stats come back ``(L, d)``.
"""
from __future__ import annotations

import torch

# Number of token rows kept per site for the exact ("sample") search loss.
SAMPLE_ROWS = 64


def site_stat(x: torch.Tensor, sample_rows: int = SAMPLE_ROWS) -> dict:
    """Statistics of one site's input activation ``x`` of shape (..., d).

    mean_abs/mean_sq are per-channel over all leading dims; ``sample`` keeps
    the first ``sample_rows`` token rows (deterministic) for the exact loss.
    """
    d = x.shape[-1]
    flat = x.reshape(-1, d).float()
    rows = min(sample_rows, flat.shape[0])
    return {
        "mean_abs": flat.abs().mean(dim=0),
        "mean_sq": (flat * flat).mean(dim=0),
        "sample": flat[:rows].clone(),
    }


def merge_stats(acc: dict, new: dict, acc_weight: float, new_weight: float,
                batch_index: int | None = None) -> dict:
    """Weighted running merge of two stat trees (same structure).

    The moment statistics are exact weighted averages.  The ``(K, d)``
    ``sample`` rows are filled round-robin across calibration batches:
    merging batch ``t`` (the ``t``-th batch after the first, so ``t >= 1``)
    replaces the rows at indices ``i % (t + 1) == t`` with batch ``t``'s
    rows — systematic reservoir filling that leaves each of the ``t + 1``
    batches seen so far holding roughly ``K / (t + 1)`` rows.

    ``batch_index`` is the 1-based merge step; when ``None`` it is
    inferred from the weight ratio (exact for equal-sized batches).
    """
    tot = acc_weight + new_weight
    wa, wb = acc_weight / tot, new_weight / tot
    t = batch_index if batch_index is not None else max(
        1, int(round(acc_weight / new_weight)))

    def merge_site(a, b):
        k = a["sample"].shape[-2]
        take_new = (torch.arange(k, device=a["sample"].device) % (t + 1)) == t
        return {
            "mean_abs": wa * a["mean_abs"] + wb * b["mean_abs"],
            "mean_sq": wa * a["mean_sq"] + wb * b["mean_sq"],
            "sample": torch.where(take_new[:, None], b["sample"],
                                  a["sample"]),
        }

    return {k: merge_site(acc[k], new[k]) for k in acc}
