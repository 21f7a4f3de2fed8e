"""Numeric verification of the paper's Theorem 1 (FAQ error < AWQ error),
the reference's ``repro/core/theory.py`` on the port.

Theorem 1 (paper §2.3) asserts that, under (i) a dominant activation
channel in the current layer plus persistently-important weight positions
in subsequent layers, and (ii) AWQ's scale rule ``s = a^c``, the fused
future-aware scale ``Σ_l γ^l (a_l)^c`` yields a smaller quantized-output
error than the current-layer-only scale.  :func:`theorem1_check` builds
that scenario — persistent lognormal channel importances with one strong
outlier channel, per-layer jitter, a tiny calibration sample per layer —
and scores the α each scale picks on the calibration sample by its error
on the true activation distribution.  Across seeds δ_FAQ < δ_AWQ in a
large majority of draws (tests/test_torch_theory.py).

The draws come from an explicit ``torch.Generator`` (the reference's
come from a JAX key; the port does not reproduce ``jax.random`` streams).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .methods import candidate_scale, fuse_stats
from .quantizer import QuantSpec, quant_dequant


class Theorem1Result(NamedTuple):
    delta_awq: torch.Tensor
    delta_faq: torch.Tensor


ALPHAS = (0.0, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9)


def _true_error(a_true: torch.Tensor, w: torch.Tensor, stat: torch.Tensor,
                calib_sample: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """α chosen on the (noisy) calibration loss; error scored on truth."""
    best_loss = torch.tensor(float("inf"))
    best_true = torch.tensor(float("inf"))
    for alpha in ALPHAS:
        s = candidate_scale(stat, alpha)
        w_hat = quant_dequant(w, spec, act_scale=s)
        dw = w_hat - w
        cal_loss = torch.linalg.norm(calib_sample @ dw)
        true_err = torch.linalg.norm(a_true @ dw)
        pick = cal_loss < best_loss
        best_loss = torch.where(pick, cal_loss, best_loss)
        best_true = torch.where(pick, true_err, best_true)
    return best_true


def theorem1_check(gen: torch.Generator, n: int = 256, n_out: int = 256,
                   n_future: int = 3, t_calib: int = 8,
                   gamma: float = 0.85,
                   spec: QuantSpec = QuantSpec(bits=3, group_size=128),
                   ) -> Theorem1Result:
    """One draw of the scenario from ``gen`` (a CPU generator)."""
    def normal(*shape):
        return torch.randn(shape, generator=gen)

    # persistent channel importances + one dominant outlier channel (thm (i))
    chan = torch.exp(normal(n) * 1.2)
    chan[0] *= 20.0
    w = normal(n, n_out) * 0.1
    a_true = normal(2048, n) * chan

    # per-layer noisy calibration statistics (current + futures)
    stats = []
    for _ in range(1 + n_future):
        jitter = torch.exp(normal(n) * 0.4)
        a_l = normal(t_calib, n) * (chan * jitter)
        stats.append(torch.mean(torch.abs(a_l), dim=0))
    stats = torch.stack(stats)
    calib_sample = normal(t_calib, n) * stats[0]

    s_faq_stat = fuse_stats(stats, gamma=gamma, window=n_future)[0]
    return Theorem1Result(
        delta_awq=_true_error(a_true, w, stats[0], calib_sample, spec),
        delta_faq=_true_error(a_true, w, s_faq_stat, calib_sample, spec))


def theorem1_win_rate(n_seeds: int = 16, **kw) -> float:
    """Fraction of seeds where δ_FAQ < δ_AWQ."""
    wins = 0
    for seed in range(n_seeds):
        r = theorem1_check(torch.Generator().manual_seed(seed), **kw)
        wins += bool(r.delta_faq < r.delta_awq)
    return wins / n_seeds
