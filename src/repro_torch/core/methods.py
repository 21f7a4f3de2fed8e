"""RTN / AWQ / FAQ quantization methods.

All three share the group-wise quantizer (:mod:`.quantizer`); they differ
only in how the per-input-channel smoothing scale ``s`` is chosen:

* RTN  — no smoothing (``s = 1``).
* AWQ  — ``s = normalize(ā_l ** α)`` with ``ā_l`` the *current layer's*
  mean-|activation| per channel, α grid-searched to minimize the layer's
  quantized-output error.
* FAQ  — identical search, but the statistic is the *future-fused*
  ``ã_l = γ·ā_l + (1-γ)·mean(ā_{l+1..l+j})`` (window-wise preview,
  paper Eq. 4-5).  Pre-searched γ=0.85, j=3 by default.

Loss for the α search (paper Eq. 7): output-MSE of the quantized linear on
calibration activations, either ``"sample"`` (exact MSE on a stored token
subsample) or ``"diag"`` (``Σ E[a_c²]·ΔW_c,·²`` from per-channel second
moments only).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .quantizer import QuantSpec, quant_dequant

# linspace(0, 1, 21) rounded to float32, written out so the grid is the
# reference's exactly.
DEFAULT_ALPHA_GRID = (
    0.0, 0.05000000074505806, 0.10000000149011612, 0.15000000596046448,
    0.20000000298023224, 0.25, 0.30000001192092896, 0.3499999940395355,
    0.4000000059604645, 0.45000001788139343, 0.5, 0.550000011920929,
    0.6000000238418579, 0.6500000357627869, 0.699999988079071, 0.75,
    0.800000011920929, 0.8500000238418579, 0.9000000357627869,
    0.949999988079071, 1.0)
PRESEARCHED_GAMMA = 0.85   # paper §3.1
PRESEARCHED_WINDOW = 3     # paper §3.1


# ---------------------------------------------------------------------------
# Scale candidates and search losses
# ---------------------------------------------------------------------------

def normalize_scale(s: torch.Tensor) -> torch.Tensor:
    """Geometric-mean-normalize a positive per-channel scale vector.

    Keeps the search scale-invariant (multiplying every channel by a
    constant must not change the quantization) and bounds dynamic range.
    """
    s = torch.clamp(s, min=1e-4)
    s = s / torch.exp(torch.mean(torch.log(s)))
    return torch.clamp(s, 1e-3, 1e3)


def candidate_scale(a_stat: torch.Tensor, alpha) -> torch.Tensor:
    """AWQ-style smoothing scale ``normalize(ā ** α)``."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=a_stat.device)
    return normalize_scale(torch.pow(torch.clamp(a_stat, min=1e-6), alpha))


def quant_error(w: torch.Tensor, spec: QuantSpec,
                act_scale: Optional[torch.Tensor],
                mean_sq: Optional[torch.Tensor] = None,
                sample: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Output-MSE proxy for quantizing ``w`` with smoothing ``act_scale``."""
    w32 = w.float()
    w_hat = quant_dequant(w32, spec, act_scale=act_scale)
    dw = w_hat - w32
    if sample is not None:
        err = sample.float() @ dw
        return torch.mean(err * err)
    if mean_sq is None:
        raise ValueError("need mean_sq for the diag loss")
    return torch.sum(mean_sq[:, None] * dw * dw) / dw.shape[1]


class SearchResult(NamedTuple):
    act_scale: torch.Tensor   # (n_in,) chosen smoothing scale
    alpha: torch.Tensor       # () chosen exponent
    loss: torch.Tensor        # () loss at the chosen scale
    rtn_loss: torch.Tensor    # () loss without smoothing (for reporting)


@torch.no_grad()
def search_alpha(w: torch.Tensor, a_stat: torch.Tensor, spec: QuantSpec,
                 alpha_grid: tuple = DEFAULT_ALPHA_GRID,
                 mean_sq: Optional[torch.Tensor] = None,
                 sample: Optional[torch.Tensor] = None) -> SearchResult:
    """Grid-search α minimizing the quantized-output error for one site.

    Sequential over the grid so peak memory stays at one weight copy
    regardless of grid size.  Ties resolve to the first grid point, as
    ``argmin`` does in the reference.
    """
    grid = torch.tensor(alpha_grid, dtype=torch.float32, device=w.device)
    losses = torch.stack([
        quant_error(w, spec, candidate_scale(a_stat, grid[i]),
                    mean_sq=mean_sq, sample=sample)
        for i in range(grid.shape[0])])
    idx = torch.argmin(losses)
    best_alpha = grid[idx]
    best_scale = candidate_scale(a_stat, best_alpha)
    rtn_loss = quant_error(w, spec, None, mean_sq=mean_sq, sample=sample)
    return SearchResult(act_scale=best_scale, alpha=best_alpha,
                        loss=losses[idx], rtn_loss=rtn_loss)


# ---------------------------------------------------------------------------
# FAQ: window-wise future preview (paper Eq. 4-5)
# ---------------------------------------------------------------------------

def window_preview(stats: torch.Tensor, window: int) -> torch.Tensor:
    """``pvw[l] = mean(stats[l+1 .. min(l+window, L-1)])`` along axis 0.

    ``stats`` is (L, d): the same linear site across the L blocks of a
    stack.  The window clamps at the last block; the last block itself has
    no future and returns its own statistic (the γ fusion then degenerates
    to plain AWQ there).
    """
    L = stats.shape[0]
    l = torch.arange(L, device=stats.device)
    hi = torch.clamp(l + window, max=L - 1)        # inclusive upper index
    count = (hi - l).to(stats.dtype)               # 0 for the last block
    # Direct shift-and-mask sum over the (small) window — a cumsum
    # difference loses bits to cancellation, pushing the "mean" outside
    # the window's [min, max]; this form is exact for window=1.
    window_sum = torch.zeros_like(stats)
    for j in range(1, window + 1):
        shifted = torch.roll(stats, -j, dims=0)    # row l holds stats[l+j]
        in_window = (l + j <= hi)[:, None]
        window_sum = window_sum + torch.where(in_window, shifted, 0.0)
    safe = torch.clamp(count, min=1.0)[:, None]
    pvw = window_sum / safe
    return torch.where(count[:, None] > 0, pvw, stats)


def fuse_stats(stats: torch.Tensor, gamma: float, window: int) -> torch.Tensor:
    """Paper Eq. 5: ``ã = γ·ā + (1-γ)·ā_pvw`` per layer (axis 0 = layer)."""
    pvw = window_preview(stats, window)
    return gamma * stats + (1.0 - gamma) * pvw


def site_stat_for_method(method: str, mean_abs: torch.Tensor,
                         gamma: float = PRESEARCHED_GAMMA,
                         window: int = PRESEARCHED_WINDOW
                         ) -> Optional[torch.Tensor]:
    """The (L, d) statistic each method feeds to the α search.

    Returns None for RTN (no smoothing search at all).
    """
    if method == "rtn":
        return None
    if method == "awq":
        return mean_abs
    if method == "faq":
        return fuse_stats(mean_abs, gamma=gamma, window=window)
    raise ValueError(f"unknown method {method!r}")
