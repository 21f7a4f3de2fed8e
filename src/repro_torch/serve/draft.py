"""Draft sources for speculative decoding.

A *draft* proposes K cheap tokens per engine step; the target model
verifies them in one batched forward (:mod:`.spec`).  Two sources:

* :class:`SelfDraft` — the FAQ int8 quantization of the *served* model's
  own weights.  FAQ-calibrated quantized weights track the full-precision
  model's future activations, which is what a draft needs for high
  acceptance; and the draft shares the target's architecture and cache
  layout, so it writes its speculative K/V straight into the target's
  cache or pages and the verify pass overwrites those positions: no extra
  KV memory.  The int8 reconstruction is materialized dense (``mode=
  "fake"``), so its decode steps are plain bf16 matmuls, as in the
  reference, where they run outside any kernel.

* :class:`ModelDraft` — any registry model as an independent draft with
  its own dense KV cache.  Acceptance depends on how well it tracks the
  target; correctness never does: the accept rule emits an exact sample of
  the target's policy even for a random draft.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.core.apply import _get_path, _set_path
from repro_torch.core.quantizer import QuantizedTensor, dequantize_groupwise
from repro_torch.models.registry import build_model


@dataclasses.dataclass
class SelfDraft:
    """The target model running int8-FAQ'd target weights.

    ``model`` stays ``None``: the runner resolves it to the engine's
    target, and the draft shares the target's dense cache or page store.
    """
    params: Any
    bits: int = 8
    shares_cache = True
    model = None


@dataclasses.dataclass
class ModelDraft:
    """Independent draft model with its own dense KV cache."""
    model: Any
    params: Any
    shares_cache = False


def _materialize(qt: QuantizedTensor, dtype: torch.dtype) -> torch.Tensor:
    """Dense original-domain reconstruction of one stacked QuantizedTensor
    leaf (leading axes: layers, and experts for MoE), ``deq(codes) /
    act_scale[..., None]``: the exact weight the serving dequant-matmul
    realizes (``(x / s) @ deq(codes) == x @ (deq(codes) / s[:, None])``),
    in ``dtype``, built one layer at a time."""
    lead = qt.codes.shape[:-2]
    out = torch.empty(lead + (qt.n_in, qt.scale.shape[-1]), dtype=dtype,
                      device=qt.codes.device)
    for l in range(out.shape[0]):
        sub = QuantizedTensor(codes=qt.codes[l], scale=qt.scale[l],
                              zero=qt.zero[l], spec=qt.spec, n_in=qt.n_in,
                              packed=qt.packed, act_scale=None)
        w = dequantize_groupwise(sub)
        if qt.act_scale is not None:
            w = w / qt.act_scale[l][..., None].float()
        out[l] = w
    return out


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def self_int8_draft(model, params, stats=None, *, bits: int = 8,
                    group_size: int = 64) -> SelfDraft:
    """Build the FAQ int8 self-draft from the target's weights.

    ``params`` may be the float weights or the packed serving tree: packed
    leaves are first materialized to the exact weights the serving
    dequant-matmul realizes, so the draft is the int8 quantization of the
    model being served.  ``stats`` are the calibration statistics that
    quantized the serving weights (FAQ's future-activation preview);
    without them the draft is plain RTN int8.  Leaves that are not
    quantized (embedding, norms, head) are shared with ``params``.
    """
    dtype = model.dtype
    spec = QuantSpec(bits=bits, group_size=group_size)
    method = "faq" if stats is not None else "rtn"
    # site by site: one leaf is materialized at a time, so the float copy
    # of the packed tree never exists whole (30 GB at qwen2-moe's width)
    qp = params
    for path, site in model.quant_site_map().items():
        leaf = _get_path(params, path)
        if isinstance(leaf, QuantizedTensor):
            leaf = _materialize(leaf, dtype)
        one = leaf
        for key in reversed(path):
            one = {key: one}
        one, _ = quantize_model(one, {path: site}, stats, method=method,
                                spec=spec, mode="fake")
        qp = _set_path(qp, path, _get_path(one, path))
        del leaf, one
    qp = _map_tree(qp, lambda x: _materialize(x, dtype)
                   if isinstance(x, QuantizedTensor) else x)
    return SelfDraft(params=qp, bits=bits)


def registry_draft(arch: str, *, tiny: bool = True, seed: int = 0,
                   params: Optional[Any] = None,
                   device="cuda") -> ModelDraft:
    """An independent draft from a registry architecture name.

    With ``params=None`` the draft is randomly initialized from ``seed``:
    plumbing (greedy output is still exactly the target's; acceptance is
    poor); a deployment passes trained or distilled weights.
    """
    model = build_model(ARCHS[arch].tiny() if tiny else ARCHS[arch])
    if params is None:
        params = model.init(seed, device=device)
    return ModelDraft(model=model, params=params)
