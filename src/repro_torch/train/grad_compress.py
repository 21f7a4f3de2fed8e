"""Int8 error-feedback gradient compression (the reference's
``repro/train/grad_compress.py``).

Each gradient tensor is quantized to int8 with a per-tensor scale before
the optimizer consumes it; the quantization residual is kept in an
error-feedback buffer and added back next step.  The compress ->
decompress round trip is what an int8 all-reduce on the data-parallel
axis would deliver.

On a mesh the gradients are this rank's shards of the reduced gradient,
and the EF buffer is per shard: each scale is the logical tensor's, its
``max|g|`` all-reduced (max) over the mesh, so a shard rounds as the whole
tensor would.  No reduction runs in int8 (the reference has none).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.dist._tree import leaves_with_keys, map_with_keys, tree_map
from repro_torch.dist.collectives import all_reduce
from repro_torch.dist.sharding import axis_rules


class EFState(NamedTuple):
    error: dict  # residual buffer, same structure as grads (f32)


def ef_init(params) -> EFState:
    return EFState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _compress_one(g32: torch.Tensor, amax: torch.Tensor):
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g32 - deq


@torch.no_grad()
def compress_grads(grads, ef: EFState, *, mesh=None):
    """Returns (decompressed grads as the wire would deliver, new EF
    state).  On a ``mesh``: every leaf's ``max|g|`` over the mesh, in one
    all_reduce."""
    errs = dict(leaves_with_keys(ef.error))
    g32 = {key: g.float() + errs[key] for key, g in leaves_with_keys(grads)}
    amax = [torch.max(torch.abs(g)) for g in g32.values()]
    if mesh is not None:
        with axis_rules(mesh):
            amax = list(all_reduce(torch.stack(amax), None, op="max"))
    out = {key: _compress_one(g, a) for (key, g), a in zip(g32.items(),
                                                           amax)}
    deq = map_with_keys(lambda key, _: out[key][0], grads)
    err = map_with_keys(lambda key, _: out[key][1], grads)
    return deq, EFState(error=err)
