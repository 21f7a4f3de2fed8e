"""Model-level quantization: apply RTN / AWQ / FAQ to a full parameter tree.

Models expose ``quant_site_map() -> {param_path: site_key}`` where each
mapped leaf has shape ``(L, n_in, n_out)`` (layer-stacked), or ``(L, E,
n_in, n_out)`` for MoE experts, and ``stats[site_key]["mean_abs"]`` is
``(L, n_in)``: a layer's experts share its statistic and each gets its own
α (one search per (layer, expert)).

Two output modes, as in the reference:

* ``"packed"``: quantized leaves become :class:`QuantizedTensor` (packed
  uint8 codes + group scales + act_scale, layer-stacked); the model's
  linear dispatch routes these through the dequant-matmul kernel (serving
  path).
* ``"fake"``: each leaf is replaced by its dequantized reconstruction
  ``deq(Q(W * s)) / s`` in the leaf's dtype (:func:`quant_dequant`), so the
  unchanged model runs it as plain matmuls (the speculative self-draft,
  evaluation).

The reference vmaps over the layer (and expert) axes; here each leaf is
quantized one layer at a time, so at full width peak memory holds one
layer's float32 copy of one leaf (``(4096, 14336)`` for llama3-8b's MLP;
a layer's expert stack, ``(64, 2048, 1408)`` for qwen2-moe, whose α
searches run batched over the experts), not the whole stack.  The float
leaves of ``params`` are left in place: the caller owns them and frees
them by dropping ``params``.
"""
from __future__ import annotations

import torch

from .methods import (DEFAULT_ALPHA_GRID, PRESEARCHED_GAMMA,
                      PRESEARCHED_WINDOW, search_alpha, search_alpha_experts,
                      site_stat_for_method)
from .quantizer import (QuantSpec, QuantizedTensor, quant_dequant,
                        quantize_groupwise)


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_path(tree, path, value):
    out = dict(tree)
    if len(path) == 1:
        out[path[0]] = value
    else:
        out[path[0]] = _set_path(tree[path[0]], path[1:], value)
    return out


def _stack_qt(per_layer: list) -> QuantizedTensor:
    first = per_layer[0]
    act = (None if first.act_scale is None
           else torch.stack([q.act_scale for q in per_layer]))
    return QuantizedTensor(
        codes=torch.stack([q.codes for q in per_layer]),
        scale=torch.stack([q.scale for q in per_layer]),
        zero=torch.stack([q.zero for q in per_layer]),
        spec=first.spec, n_in=first.n_in, packed=first.packed,
        act_scale=act)


@torch.no_grad()
def _quantize_leaf(w, stat, spec, alpha_grid, loss, stats_site, mode):
    """Quantize one (L, n_in, n_out) or (L, E, n_in, n_out) leaf, layer by
    layer (a layer's experts together).

    ``stat`` is the (L, n_in) method statistic or None (RTN).
    Returns (new_leaf, report_dict); the report's fields are (L,) or
    (L, E).
    """
    if w.dim() not in (3, 4):
        raise ValueError(f"expected a layer-stacked (L, [E,] n_in, n_out) "
                         f"leaf, got shape {tuple(w.shape)}")
    n_layers = w.shape[0]
    search = search_alpha if w.dim() == 3 else search_alpha_experts
    act_scales, alphas, losses, rtn_losses = [], [], [], []
    for l in range(n_layers):
        if stat is None:  # RTN
            act_scales.append(None)
            continue
        mean_sq = stats_site["mean_sq"][l] if loss == "diag" else None
        sample = stats_site["sample"][l] if loss == "sample" else None
        res = search(w[l], stat[l], spec, alpha_grid, mean_sq=mean_sq,
                     sample=sample)
        act_scales.append(res.act_scale)
        alphas.append(res.alpha)
        losses.append(res.loss)
        rtn_losses.append(res.rtn_loss)
    report = {} if stat is None else {
        "alpha": torch.stack(alphas), "loss": torch.stack(losses),
        "rtn_loss": torch.stack(rtn_losses)}

    if mode == "fake":
        # written layer by layer into one stack: no second copy of the leaf
        new_leaf = torch.empty_like(w)
        for l in range(n_layers):
            new_leaf[l] = quant_dequant(w[l], spec, act_scale=act_scales[l])
        return new_leaf, report
    new_leaf = _stack_qt([
        quantize_groupwise(w[l], spec, act_scale=act_scales[l], pack=True)
        for l in range(n_layers)])
    return new_leaf, report


def quantize_model(params: dict, site_map: dict, stats: dict, *,
                   method: str = "faq",
                   spec: QuantSpec = QuantSpec(),
                   gamma: float = PRESEARCHED_GAMMA,
                   window: int = PRESEARCHED_WINDOW,
                   loss: str = "sample",
                   mode: str = "packed",
                   alpha_grid: tuple = DEFAULT_ALPHA_GRID):
    """Quantize every site-mapped leaf of ``params``.

    Returns ``(new_params, report)`` with ``report[path_str]`` holding the
    per-layer chosen α and losses (empty for RTN).  ``mode`` is
    ``"packed"`` (QuantizedTensor leaves, the serving format) or
    ``"fake"`` (dequantized float leaves).
    """
    if mode not in ("packed", "fake"):
        raise ValueError(f"unknown mode {mode!r}")
    new_params = params
    report = {}
    for path, site_key in site_map.items():
        w = _get_path(params, path)
        stats_site = stats[site_key] if stats is not None else None
        if method == "rtn":
            stat = None
        else:
            stat = site_stat_for_method(method, stats_site["mean_abs"],
                                        gamma=gamma, window=window)
        new_leaf, rep = _quantize_leaf(w, stat, spec, alpha_grid, loss,
                                       stats_site, mode)
        new_params = _set_path(new_params, path, new_leaf)
        report["/".join(path)] = rep
    return new_params, report


def report_summary(report: dict) -> dict:
    """Aggregate per-site report into scalars for logging/benchmarks."""
    out = {}
    for path, rep in report.items():
        if not rep:
            continue
        loss = float(torch.mean(rep["loss"]))
        rtn = float(torch.mean(rep["rtn_loss"]))
        out[path] = {
            "mean_alpha": float(torch.mean(rep["alpha"])),
            "mean_loss": loss,
            "mean_rtn_loss": rtn,
            "improvement_vs_rtn": (rtn - loss) / max(rtn, 1e-30),
        }
    return out
