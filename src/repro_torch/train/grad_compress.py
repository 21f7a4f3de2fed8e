"""Int8 error-feedback gradient compression (the reference's
``repro/train/grad_compress.py``).

Each gradient tensor is quantized to int8 with a per-tensor scale before
the optimizer consumes it; the quantization residual is kept in an
error-feedback buffer and added back next step.  The compress ->
decompress round trip is what an int8 all-reduce on the data-parallel
axis would deliver.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.dist._tree import leaves_with_keys, map_with_keys, tree_map


class EFState(NamedTuple):
    error: dict  # residual buffer, same structure as grads (f32)


def ef_init(params) -> EFState:
    return EFState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _compress_one(g: torch.Tensor, err: torch.Tensor):
    g32 = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g32 - deq


@torch.no_grad()
def compress_grads(grads, ef: EFState):
    """Returns (decompressed grads as the wire would deliver, new EF
    state)."""
    errs = dict(leaves_with_keys(ef.error))
    out = {key: _compress_one(g, errs[key])
           for key, g in leaves_with_keys(grads)}
    deq = map_with_keys(lambda key, _: out[key][0], grads)
    err = map_with_keys(lambda key, _: out[key][1], grads)
    return deq, EFState(error=err)
