"""The collectives of the port's meshes, over one mesh axis.

The port's counterparts of what GSPMD and ``shard_map`` insert in the
reference: :func:`all_reduce` (row-parallel partial sums, the vocab-sharded
embedding lookup, a training step's norms and metrics), :func:`all_gather`
(the logits' vocab columns, a step's rows over ``data``, a layer's FSDP
weights), :func:`reduce_scatter` (the FSDP gradients), :func:`all_to_all`
(the MoE expert exchange) and :func:`broadcast` (rank 0's clock).  Each runs
over the process group of one axis of the active mesh
(:func:`repro_torch.dist.sharding.axis_rules`; ``axis=None`` is the whole
mesh) and returns a new tensor.

Under autograd (grad enabled and an input that requires it) four of them
carry gradients, each backward the adjoint collective over the same group:
:func:`all_reduce` (sum) passes its output gradient through;
:func:`all_gather` hands each rank its own block of the gradient, or, with
``reduce_grad`` (a weight shard gathered for ranks that see different
rows), sums the gradient over the axis first (a reduce_scatter);
:func:`copy_to` (the identity, placed where a column-parallel product reads
a replicated input, or where a replicated weight meets this rank's part of
the work) sums its gradient over the axis; :func:`all_to_all` sends each
block of the gradient back to the rank its rows came from (the inverse
exchange, itself an all_to_all).  The backward takes
the mesh it saw in the forward: autograd may run it in another thread,
which has no active mesh.  Without grad every collective is the same call
as ever.

Gloo carries CUDA tensors through host memory: on a ``gloo`` mesh a CUDA
tensor is copied to the host, reduced or exchanged there, and copied back,
for every kind and in both directions, by rule.  NCCL takes CUDA tensors as
they are.

:data:`COUNTS` keeps, per kind, the calls and the elements moved (the
input's for all_reduce / reduce_scatter / all_to_all / broadcast, the
gathered output's for all_gather), the most one call moved, and the last
call's output shape: the decode-step collective invariant, the training
step's per-step counts and ``chip_smoke.py`` read it.  A backward's
collectives count like any other.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .sharding import active_mesh

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "broadcast")
COUNTS = {k: {"calls": 0, "elements": 0, "max_elements": 0,
             "last_shape": None} for k in KINDS}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def step_totals(per_microbatch: dict, mesh_shape, *, microbatches: int = 1,
                grad_compress: bool = False) -> dict:
    """Collective calls per kind of one train step on a ``(data, model)``
    mesh of ``mesh_shape`` from those of one microbatch's forward and
    backward: ``microbatches`` of them, and once per step the all_reduces
    of the data sums of the leaves whole across ``data`` and of the metrics
    (one each where ``data`` has more than one rank), of the clip norm
    (one) and of the compression scales (one with ``grad_compress``)."""
    d = int(mesh_shape[0] > 1)
    out = {k: microbatches * per_microbatch.get(k, 0) for k in KINDS}
    out["all_reduce"] += 2 * d + 1 + int(grad_compress)
    return out


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


def _size(mesh, axis: Optional[str]) -> int:
    return mesh.n_ranks if axis is None else mesh.size(axis)


def _grad_wanted(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# -- the calls themselves (no autograd) ---------------------------------------

def _all_reduce(x, mesh, axis, op="sum"):
    buf = _staged(x, mesh)
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group(axis))
    _count("all_reduce", x.numel(), x.shape)
    return buf.to(x.device)


def _all_gather(x, mesh, axis, dim):
    buf = _staged(x, mesh)
    parts = [torch.empty_like(buf) for _ in range(_size(mesh, axis))]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    out = torch.cat(parts, dim=dim).to(x.device)
    _count("all_gather", out.numel(), out.shape)
    return out


def _reduce_scatter(x, mesh, axis, dim):
    n = _size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split in {n}")
    buf = _staged(x.movedim(dim, 0), mesh)
    out = buf.new_empty((buf.shape[0] // n,) + tuple(buf.shape[1:]))
    dist.reduce_scatter_tensor(out, buf, group=mesh.group(axis))
    _count("reduce_scatter", x.numel(), x.shape)
    return out.movedim(0, dim).contiguous().to(x.device)


def _all_to_all(x, mesh, axis):
    n = mesh.size(axis)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} does not "
                         f"split in {n}")
    buf = _staged(x, mesh)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group(axis))
    _count("all_to_all", x.numel(), x.shape)
    return out.to(x.device)


def _block(x, mesh, axis, dim):
    """This rank's block of ``x`` cut in equal parts along ``dim``."""
    n = x.shape[dim] // _size(mesh, axis)
    return x.narrow(dim, mesh.index(axis) * n, n).contiguous()


# -- autograd -----------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    """Sum over the axis; the gradient of every rank's partial is the
    output's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllGather(torch.autograd.Function):
    """Concatenation over the axis; backward: this rank's block of the
    gradient, summed over the axis first with ``reduce_grad``."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, reduce_grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.reduce_grad = (mesh, axis, dim,
                                                       reduce_grad)
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            g = _reduce_scatter(grad, ctx.mesh, ctx.axis, ctx.dim)
        else:
            g = _block(grad, ctx.mesh, ctx.axis, ctx.dim)
        return g, None, None, None, None


class _AllToAll(torch.autograd.Function):
    """Block j to rank j; backward: the inverse exchange of the gradient
    (block j, the rows rank j sent, goes back to rank j)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.mesh, ctx.axis), None, None


class _CopyTo(torch.autograd.Function):
    """The identity; backward: the gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


# -- the public calls ---------------------------------------------------------

def all_reduce(x: torch.Tensor, axis: Optional[str] = "model",
               op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``x`` over the ranks of
    ``axis`` (``None``: every rank of the mesh).  A sum under autograd
    passes its output's gradient to ``x``."""
    mesh = _mesh()
    if op == "sum" and _grad_wanted(x):
        return _AllReduce.apply(x, mesh, axis)
    return _all_reduce(x, mesh, axis, op)


def all_gather(x: torch.Tensor, axis: str = "model", dim: int = -1,
               reduce_grad: bool = False) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in rank
    order.  Under autograd the gradient of ``x`` is this rank's block of
    the output's gradient; with ``reduce_grad`` that gradient is summed
    over ``axis`` first (a reduce_scatter): the FSDP gather of a weight
    shard, whose consumers on the axis's ranks see different rows."""
    mesh = _mesh()
    dim = dim % x.dim()
    if _grad_wanted(x):
        return _AllGather.apply(x, mesh, axis, dim, reduce_grad)
    return _all_gather(x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, axis: str = "data",
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, cut in equal blocks
    along ``dim``: this rank's block (block i on the axis's rank i)."""
    mesh = _mesh()
    return _reduce_scatter(x, mesh, axis, dim % x.dim())


def copy_to(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` (a replicated input about to meet this rank's columns of a
    weight): the identity, whose gradient under autograd is summed over
    ``axis`` (one all_reduce in the backward)."""
    if not _grad_wanted(x):
        return x
    return _CopyTo.apply(x, _mesh(), axis)


def all_to_all(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Block j of ``x``'s leading axis (cut in ``axis``-size equal blocks)
    goes to rank j; block j of the result came from rank j.  Under
    autograd the gradient takes the inverse exchange (one all_to_all in
    the backward)."""
    mesh = _mesh()
    if _grad_wanted(x):
        return _AllToAll.apply(x, mesh, axis)
    return _all_to_all(x, mesh, axis)


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
