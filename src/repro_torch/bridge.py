"""Turn a ``repro`` parameter tree, given as numpy arrays, into the
port's parameters.

The input is what ``jax.tree_util.tree_map(np.asarray, params)`` gives
for a ``repro`` tree: nested dicts whose leaves are numpy arrays (bf16
ones included, as ml_dtypes gives them)
(layer-stacked ``(L, ...)`` leaves stay stacked) or quantized-tensor
objects carrying ``codes``, ``scale``, ``zero``, ``act_scale`` arrays and
``spec`` (with ``bits``, ``group_size``, ``symmetric``), ``n_in`` and
``packed``.  Those are duck-typed, so this module imports nothing of
``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantizer import QuantSpec, QuantizedTensor
from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":    # ml_dtypes' bf16, which torch cannot read
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.as_tensor(a, device=device)


def _is_quantized(obj) -> bool:
    return all(hasattr(obj, a) for a in ("codes", "scale", "zero", "spec",
                                         "n_in", "packed"))


def from_numpy_tree(tree, device="cuda"):
    """Nested dict of numpy arrays / quantized tensors -> the same tree of
    torch tensors / :class:`QuantizedTensor` on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, dev) for k, v in tree.items()}
    if _is_quantized(tree):
        spec = tree.spec
        act = tree.act_scale
        return QuantizedTensor(
            codes=_tensor(tree.codes, dev), scale=_tensor(tree.scale, dev),
            zero=_tensor(tree.zero, dev),
            spec=QuantSpec(bits=int(spec.bits),
                           group_size=int(spec.group_size),
                           symmetric=bool(spec.symmetric)),
            n_in=int(tree.n_in), packed=bool(tree.packed),
            act_scale=None if act is None else _tensor(act, dev))
    return _tensor(tree, dev)


def tree_to(tree, device):
    """Move a port parameter tree (nested dicts of tensors /
    :class:`QuantizedTensor`) to ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(
            codes=tree.codes.to(dev), scale=tree.scale.to(dev),
            zero=tree.zero.to(dev), spec=tree.spec, n_in=tree.n_in,
            packed=tree.packed,
            act_scale=None if tree.act_scale is None
            else tree.act_scale.to(dev))
    return tree.to(dev)
