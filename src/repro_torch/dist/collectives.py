"""The collectives of tensor-parallel serving, over one mesh axis.

The port's counterparts of what GSPMD and ``shard_map`` insert in the
reference: :func:`all_reduce` (row-parallel partial sums, the vocab-sharded
embedding lookup), :func:`all_gather` (the logits' vocab columns, a step's
rows over ``data``), :func:`all_to_all` (the MoE expert exchange) and
:func:`broadcast` (rank 0's clock).  Each runs over the process group of
one axis of the active mesh (:func:`repro_torch.dist.sharding.axis_rules`)
and returns a new tensor.

Gloo carries CUDA tensors through host memory: on a ``gloo`` mesh a CUDA
tensor is copied to the host, reduced or exchanged there, and copied back,
for every kind, by rule.  NCCL takes CUDA tensors as they are.

:data:`COUNTS` keeps, per kind, the calls and the elements moved (the
input's for all_reduce / all_to_all / broadcast, the gathered output's for
all_gather), the most one call moved, and the last call's output shape:
the decode-step collective invariant and ``chip_smoke.py`` read it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .sharding import active_mesh

KINDS = ("all_reduce", "all_gather", "all_to_all", "broadcast")
COUNTS = {k: {"calls": 0, "elements": 0, "max_elements": 0,
             "last_shape": None} for k in KINDS}


def reset_counts():
    for c in COUNTS.values():
        c.update(calls=0, elements=0, max_elements=0, last_shape=None)


def counts() -> dict:
    """A copy of :data:`COUNTS`."""
    return {k: dict(c) for k, c in COUNTS.items()}


def _count(kind: str, elements: int, shape):
    c = COUNTS[kind]
    c["calls"] += 1
    c["elements"] += elements
    c["max_elements"] = max(c["max_elements"], elements)
    c["last_shape"] = tuple(shape)


def _mesh():
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("a collective needs an active mesh "
                           "(repro_torch.dist.sharding.axis_rules)")
    return mesh


def _staged(x: torch.Tensor, mesh) -> torch.Tensor:
    """The buffer a collective works on: a host copy of a CUDA tensor on a
    gloo mesh, else a contiguous copy on x's device."""
    if mesh.backend == "gloo" and x.is_cuda:
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone(memory_format=torch.contiguous_format)


def all_reduce(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``."""
    mesh = _mesh()
    buf = _staged(x, mesh)
    dist.all_reduce(buf, group=mesh.group(axis))
    _count("all_reduce", x.numel(), x.shape)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, axis: str = "model",
               dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in rank
    order."""
    mesh = _mesh()
    buf = _staged(x, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    out = torch.cat(parts, dim=dim).to(x.device)
    _count("all_gather", out.numel(), out.shape)
    return out


def all_to_all(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Block j of ``x``'s leading axis (cut in ``axis``-size equal blocks)
    goes to rank j; block j of the result came from rank j."""
    mesh = _mesh()
    n = mesh.size(axis)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} does not "
                         f"split in {n}")
    buf = _staged(x, mesh)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group(axis))
    _count("all_to_all", x.numel(), x.shape)
    return out.to(x.device)


def broadcast(x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
    """Rank 0's ``x`` (of ``axis``'s group; ``None``: of the whole mesh) on
    every rank."""
    mesh = _mesh()
    group = mesh.group(axis)
    buf = _staged(x, mesh)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(buf, src=src, group=group)
    _count("broadcast", x.numel(), x.shape)
    return buf.to(x.device)
