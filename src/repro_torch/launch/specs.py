"""Meta-tensor stand-ins and per-rank shardings for every (arch x shape)
cell.

The port's counterpart of ``repro.launch.specs``, function for function.
Everything here is allocation-free: where the reference runs
``jax.eval_shape`` over the real init, forward and quantize functions, the
port builds the same trees on the meta device (shapes and dtypes, no
storage): ``model.init(device="meta")``, a meta forward, ``model.
init_cache(..., device="meta")``.

Where the reference returns ``NamedSharding`` trees, the port returns
trees of :class:`Sharding` leaves on a mesh (a
:class:`~repro_torch.dist.sharding.MeshShape` for the dry-run, or a live
:class:`~repro_torch.launch.mesh.Mesh`): each leaf's spec tuple
(:func:`~repro_torch.dist.sharding.logical_to_spec`; a dimension annotated
as parts is a :class:`~repro_torch.dist.sharding.Parts` entry) and rank
0's block shape (:func:`~repro_torch.dist.sharding.local_shape`).  No
process group is touched.

:func:`quantized_param_shardings` is the reference's function as it
runs, leaf for leaf: every child of a QuantizedTensor takes the weight's
logical axes, cut to the child's rank (``codes (..., n_in // 2, n_out)``
and ``scale`` / ``zero (..., n_in // g, n_out)`` as the weight, each
dimension's divisibility checked again; ``act_scale (..., n_in)`` the
leading ones).  The reference's docstring says that the group scales keep
only the output dimension's cut and that ``act_scale`` is replicated, but
its code tells a child by a path entry's ``idx``, and the children's
entries (``FlattenedIndexKey``) carry ``key``: under the pinned jax no
child is told apart.  A serving engine holds the same blocks wherever a
weight's input split falls on whole groups; where it falls inside one
group the engine keeps that group's one row of ``scale`` / ``zero``, and
where it falls on neither the engine refuses the mesh
(:func:`~repro_torch.dist.sharding.shard_tree`), which the dry-run
records (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.quantizer import (QuantizedTensor, QuantSpec,
                                        effective_group_size)
from repro_torch.dist._tree import map_with_keys
from repro_torch.dist.sharding import leaf_spec, local_shape, map_tree

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's placement on a mesh: its per-dimension mesh axes and the
    shape of rank 0's block."""
    spec: tuple
    local_shape: tuple


def _sharding(shape, axes, mesh, rules) -> Sharding:
    """The :class:`Sharding` of a leaf of ``shape`` annotated ``axes``
    (padded / truncated with ``None`` to its rank; ``None``: replicated)."""
    shape = tuple(shape)
    ann = [None] * len(shape) if axes is None else list(axes)[:len(shape)]
    ann += [None] * (len(shape) - len(ann))
    return Sharding(leaf_spec(ann, shape, mesh, rules),
                    local_shape(shape, ann, mesh, rules))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Meta tensors of the model inputs of one cell: int32 tokens (and
    labels for a train cell; one token per row for decode), bf16 frame
    embeddings for audio and patch embeddings for vlm outside decode."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        batch = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
    elif cell.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
    else:  # decode
        batch = {"tokens": _meta((b, 1), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = _meta((b, cfg.encoder_len, cfg.d_model),
                                torch.bfloat16)
    if cfg.family == "vlm" and cell.kind != "decode":
        batch["patches"] = _meta((b, cfg.patch_len, cfg.d_model),
                                 torch.bfloat16)
    return batch


def batch_shardings(mesh, batch: dict, rules: Optional[dict] = None) -> dict:
    """Each input's :class:`Sharding`: rows on ``batch``, the rest whole."""
    return {k: _sharding(v.shape, ["batch"], mesh, rules)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Params / optimizer / cache specs
# ---------------------------------------------------------------------------

def param_specs(model) -> dict:
    """``model.init``'s tree on the meta device."""
    return model.init(device="meta")


def param_shardings(mesh, model, specs=None, rules: Optional[dict] = None):
    """:class:`Sharding` of every leaf of :func:`param_specs` under
    ``model.param_axes()`` (``rules``: default the active table)."""
    specs = param_specs(model) if specs is None else specs
    return map_tree(specs, model.param_axes(),
                    lambda leaf, ax, _: _sharding(leaf.shape, ax, mesh,
                                                  rules))


def stats_specs(model, cfg: ModelConfig) -> dict:
    """The per-site calibration statistics of a 2 x 32-token batch, as meta
    tensors (a meta forward with ``collect_stats``)."""
    dtype = getattr(torch, cfg.dtype)
    batch = {"tokens": _meta((2, 32), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = _meta((2, cfg.encoder_len, cfg.d_model), dtype)
    if cfg.family == "vlm":
        batch["patches"] = _meta((2, cfg.patch_len, cfg.d_model), dtype)
    with torch.no_grad():
        _, aux = model.forward(param_specs(model), batch, collect_stats=True)
    return aux["stats"]


def _packed(w: torch.Tensor, spec: QuantSpec) -> QuantizedTensor:
    """The packed QuantizedTensor of a ``(..., n_in, n_out)`` weight, as
    meta tensors: ``codes (..., n_in // 2, n_out)`` uint8, ``scale`` /
    ``zero (..., n_in // g, n_out)`` and ``act_scale (..., n_in)`` f32."""
    if spec.bits != 4:
        raise ValueError(f"packed codes are 4-bit, got {spec.bits} bits")
    *lead, n_in, n_out = w.shape
    groups = n_in // effective_group_size(n_in, spec.group_size)
    return QuantizedTensor(
        codes=_meta((*lead, n_in // 2, n_out), torch.uint8),
        scale=_meta((*lead, groups, n_out), torch.float32),
        zero=_meta((*lead, groups, n_out), torch.float32),
        spec=spec, n_in=n_in, packed=True,
        act_scale=_meta((*lead, n_in), torch.float32))


def quantized_param_specs(model, cfg: ModelConfig,
                          spec: QuantSpec = QuantSpec(bits=4)) -> dict:
    """The packed serving tree (``quantize_model(..., mode="packed")``'s) as
    meta tensors: each quant site a :class:`QuantizedTensor` of meta
    children.  No alpha search runs: the shapes do not depend on alpha."""
    del cfg     # the reference's signature; the sites are the model's
    tree = param_specs(model)
    for path in model.quant_site_map():
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = _packed(node[path[-1]], spec)
    return tree


def quantized_param_shardings(mesh, model, qspecs,
                              rules: Optional[dict] = None):
    """:class:`Sharding` of every leaf of a quantized tree, the reference's
    function as it runs (see the module docstring): float leaves follow
    ``param_axes``; each child of a QuantizedTensor takes the weight's
    axes, cut to the child's rank."""
    def one(leaf, ax, _):
        if not isinstance(leaf, QuantizedTensor):
            return _sharding(leaf.shape, ax, mesh, rules)
        return map_with_keys(
            lambda _, child: _sharding(child.shape, ax, mesh, rules), leaf)

    return map_tree(qspecs, model.param_axes(), one)


def cache_specs(model, batch: int, max_len: int) -> dict:
    """``model.init_cache(batch, max_len)`` on the meta device."""
    return model.init_cache(batch, max_len, device="meta")


def cache_shardings(mesh, model, cspecs, rules: Optional[dict] = None):
    """:class:`Sharding` of every cache leaf under ``model.cache_axes()``."""
    return map_tree(cspecs, model.cache_axes(),
                    lambda leaf, ax, _: _sharding(leaf.shape, ax, mesh,
                                                  rules))
