"""Logical-axis sharding rules, and each rank's shard of a tree.

Models name tensor dimensions with *logical* axes ("batch", "heads",
"ff", ...); a rule table maps each logical name to zero or more *mesh*
axes.  The three tables are the reference's (``repro.dist.sharding``):

* :data:`DEFAULT_RULES`        — training / calibration: batch and FSDP
  over ``(pod, data)``, tensor-parallel weights over ``model``.
* :data:`SERVE_PREFILL_RULES`  — prefill also sequence-shards activations
  over ``model``.
* :data:`SERVE_DECODE_RULES`   — decode: ``qin`` replicated (the
  reference's opt-in marker for its packed-domain transfer constraint).

:func:`logical_to_spec` resolves names to mesh axes best-effort, as the
reference does: a mesh axis absent from the mesh is dropped; each mesh
axis is used at most once per tensor (earlier dimensions win); a dimension
that the surviving axes' product does not divide is replicated, with a
warning once per site.  It returns a plain tuple with one entry per
dimension (``None``, a mesh axis, or a tuple of them) where the reference
returns a ``PartitionSpec``.

Where the reference hands GSPMD a ``NamedSharding`` per leaf
(``tree_shardings`` / ``tree_hint``), the port cuts each rank's shard
itself: :func:`shard_tree` returns the tree with every leaf replaced by
this rank's block of it, a contiguous copy made once.  A
:class:`~repro_torch.core.quantizer.QuantizedTensor` is cut as one
weight: a split of its output dimension cuts ``codes``, ``scale`` and
``zero`` on ``n_out``; a split of its input dimension cuts ``codes`` on
packed rows, ``scale`` / ``zero`` on groups and ``act_scale`` on
``n_in``.  An input split falls on whole groups, or inside one group,
whose scale and zero row each of its shards then copies (a sub-group:
the same dequantized weights).

An annotation entry may also be a tuple of logical names: that dimension
is ``len(entry)`` equal parts laid end to end, and part ``i`` is cut as if
annotated ``entry[i]`` (the rank's shard is its block of every part,
concatenated in order).  A projection whose output the model splits, such
as Mamba's ``in_proj`` (``u | z``), is annotated ``("ff", "ff")``, so that
each rank gets matching columns of both halves; ``(None, "ff")`` keeps the
first part whole and cuts the second.  :func:`logical_to_spec` (one spec
per leaf) refuses such an entry; :func:`shard_leaf` and :func:`local_shape`
cut it part by part, and :func:`tree_specs` records that dimension as a
:class:`Parts` entry (each part's own entry), which :func:`cut_tensor`,
:func:`spec_axes` and the checkpoints' gather read part by part.

Serving places weights with :func:`serving_rules` (whole across
``data``), training with :func:`training_rules` (:data:`DEFAULT_RULES`:
weights, AdamW moments and the EF buffer FSDP-cut over ``data``).  A shard
alone does not say which of its dimensions were cut (a dimension the mesh
does not divide stays whole), so :func:`tree_specs` records, from the
logical shapes, each cut leaf's spec under its checkpoint key: the
trainer's gradient reduction and clip norm, and the checkpoints' gather
and restore, read it.

The active ``(mesh, rules)`` context (:func:`axis_rules`) is what the
models read to run their collectives (:mod:`.collectives`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Optional, Sequence

import torch

from repro_torch.core.quantizer import QuantizedTensor

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Rule tables (the reference's, entry for entry)
# ---------------------------------------------------------------------------

DEFAULT_RULES = {
    # data / activation axes
    "batch":    ("pod", "data"),
    "seq":      None,
    "embed":    None,
    # weight / head axes (tensor parallel)
    "heads":    "model",
    "kv_heads": "model",
    "kv_seq":   "model",     # fallback when the head count doesn't divide
    "ff":       "model",
    "vocab":    "model",
    "expert":   "model",
    "experts":  "model",     # stacked expert dim in MoE param trees
    "fsdp":     ("pod", "data"),
    # QuantizedTensor children
    "qin":      ("pod", "data"),
    "qout":     "model",
    "qgroups":  None,
}

SERVE_PREFILL_RULES = dict(DEFAULT_RULES, seq="model")

SERVE_DECODE_RULES = dict(DEFAULT_RULES, qin=None)


# ---------------------------------------------------------------------------
# Active-context machinery
# ---------------------------------------------------------------------------

_CTX = threading.local()


def _stack():
    if not hasattr(_CTX, "stack"):
        _CTX.stack = []
    return _CTX.stack


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[dict] = None):
    """Activate ``(mesh, rules)`` in this thread.  Nestable; inner wins."""
    _stack().append((mesh, DEFAULT_RULES if rules is None else rules))
    try:
        yield mesh
    finally:
        _stack().pop()


def active_mesh():
    """The mesh of the innermost :func:`axis_rules` context (or None)."""
    s = _stack()
    return s[-1][0] if s else None


def active_rules() -> dict:
    s = _stack()
    return s[-1][1] if s else DEFAULT_RULES


def active_rule(name: str):
    """The mesh-axis mapping the active rule table gives ``name``."""
    return active_rules().get(name)


@contextlib.contextmanager
def row_parallel():
    """Mark a row-parallel region (weight split on its input dimension):
    under a ``qin: None`` table it rebinds ``qin`` to ``model``, as the
    reference does; a no-op without an active mesh or when ``qin`` is
    already bound."""
    mesh = active_mesh()
    if mesh is None or active_rule("qin") is not None:
        yield
        return
    with axis_rules(mesh, dict(active_rules(), qin="model")):
        yield


def axis_size(axis: str) -> int:
    """Ranks along ``axis`` of the active mesh (1 without one)."""
    mesh = active_mesh()
    return 1 if mesh is None else mesh.size(axis)


def axis_index(axis: str) -> int:
    """This rank's coordinate on ``axis`` of the active mesh (0 without
    one)."""
    mesh = active_mesh()
    return 0 if mesh is None else mesh.index(axis)


# ---------------------------------------------------------------------------
# Logical axes -> per-dimension mesh axes
# ---------------------------------------------------------------------------

def _mesh_axis_sizes(mesh) -> dict:
    return dict(mesh.shape)


# divisibility fallbacks already warned about, keyed on (axes, shape, dim,
# logical name, dropped mesh axes): a site that silently replicates shows
# up in the log once; two sites that drop a different logical name are two
# warnings
_WARNED_DROPS: set = set()


def _warn_dropped(axes, shape, dim, name, cand, total):
    if shape[dim] == 1:
        return  # replicating a singleton dim loses nothing
    key = (tuple(axes), tuple(shape), dim, name, cand)
    if key in _WARNED_DROPS:
        return
    _WARNED_DROPS.add(key)
    logger.warning(
        "logical_to_spec: replicating dim %d (logical %r, size %d) of "
        "shape %s — mesh axes %s have total size %d which does not divide "
        "it; tensor stays correct but this site is NOT sharded",
        dim, name, shape[dim], tuple(shape), cand, total)


def logical_to_spec(axes: Sequence[Optional[str]], *, shape: Sequence[int],
                    mesh, rules: Optional[dict] = None) -> tuple:
    """Per-dimension mesh axes for a tensor of ``shape`` whose dimensions
    carry the logical names ``axes`` (``None`` replicates).  A rule names
    one mesh axis or a tuple of them (sharded over their product).
    Fallbacks, in order: mesh axes absent from ``mesh`` are dropped; mesh
    axes claimed by an earlier dimension are dropped; if the survivors'
    product does not divide ``shape[i]``, dimension i replicates."""
    rules = active_rules() if rules is None else rules
    sizes = _mesh_axis_sizes(mesh)
    used: set = set()
    entries = []
    for dim, name in enumerate(axes):
        if isinstance(name, tuple):
            raise ValueError(f"dim {dim} is annotated as parts {name}: one "
                             f"spec cannot describe it (shard_leaf and "
                             f"local_shape cut it part by part)")
        rule = rules.get(name) if name is not None else None
        if rule is None:
            entries.append(None)
            continue
        cand = (rule,) if isinstance(rule, str) else tuple(rule)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        if not cand:
            entries.append(None)
            continue
        total = 1
        for a in cand:
            total *= sizes[a]
        if shape[dim] % total != 0:
            _warn_dropped(axes, shape, dim, name, cand, total)
            entries.append(None)
            continue
        used.update(cand)
        entries.append(cand[0] if len(cand) == 1 else cand)
    return tuple(entries)


class Parts(tuple):
    """A spec entry of a dimension laid out as ``len(self)`` equal parts
    end to end, part ``i`` cut as ``self[i]`` (a mesh axis, a tuple of
    them, or None): the spec of a dimension annotated as parts."""


def _parts(entry, mesh):
    """(number of shards, this rank's shard index) of a spec entry: the
    product of its axes' sizes, and the rank's coordinates on them read
    row-major in the entry's order."""
    if entry is None:
        return 1, 0
    n, idx = 1, 0
    for a in (entry,) if isinstance(entry, str) else entry:
        n *= mesh.size(a)
        idx = idx * mesh.size(a) + mesh.index(a)
    return n, idx


def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def _annotation(axes, ndim: int):
    ax = list(axes)[:ndim]
    return ax + [None] * (ndim - len(ax))


def _parts_entry(ann):
    """(dim, names) of the entry of ``ann`` that annotates parts (a tuple
    of names), or None."""
    for dim, name in enumerate(ann):
        if isinstance(name, tuple):
            return dim, name
    return None


def _part_annotations(ann, dim, names):
    return [ann[:dim] + [name] + ann[dim + 1:] for name in names]


def local_shape(shape, axes, mesh, rules: Optional[dict] = None) -> tuple:
    """This rank's block shape of a tensor of ``shape`` annotated ``axes``
    (padded / truncated with ``None`` to the rank)."""
    shape = tuple(shape)
    ann = _annotation(axes, len(shape))
    found = _parts_entry(ann)
    if found is not None:
        dim, names = found
        part = shape[:dim] + (shape[dim] // len(names),) + shape[dim + 1:]
        blocks = [local_shape(part, a, mesh, rules)
                  for a in _part_annotations(ann, dim, names)]
        return blocks[0][:dim] + (sum(b[dim] for b in blocks),) \
            + blocks[0][dim + 1:]
    spec = logical_to_spec(ann, shape=shape, mesh=mesh, rules=rules)
    return tuple(s // _parts(e, mesh)[0] for s, e in zip(shape, spec))


def _cut_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    out, cut = x, False
    for dim, entry in enumerate(spec):
        if isinstance(entry, Parts):
            part = [None] * len(spec)
            out = torch.cat([_cut_tensor(p, tuple(part[:dim]) + (e,)
                                         + tuple(part[dim + 1:]), mesh)
                             for p, e in zip(out.chunk(len(entry), dim),
                                             entry)], dim=dim)
            cut = True
            continue
        n, i = _parts(entry, mesh)
        if n > 1:
            out, cut = _block(out, dim, n, i), True
    # a copy of its own: a view would keep the whole leaf alive and hand a
    # strided operand to the kernels
    return out.clone(memory_format=torch.contiguous_format) if cut else x


def _cut_quantized(qt: QuantizedTensor, axes, mesh, rules) -> QuantizedTensor:
    """One QuantizedTensor cut as the weight ``(..., n_in, n_out)`` it
    stores (see the module docstring)."""
    lead = tuple(qt.codes.shape[:-2])
    n_out = qt.codes.shape[-1]
    shape = lead + (qt.n_in, n_out)
    spec = logical_to_spec(_annotation(axes, len(shape)), shape=shape,
                           mesh=mesh, rules=rules)
    if all(e is None for e in spec):
        return qt
    n_in_parts, i_in = _parts(spec[-2], mesh)
    n_groups = qt.scale.shape[-2]
    g = qt.n_in // n_groups
    rows = qt.n_in // n_in_parts
    if n_in_parts > 1 and (rows % 2 if qt.packed else False):
        raise ValueError(f"an input split of {qt.n_in} rows in {n_in_parts} "
                         f"leaves {rows} rows, not whole packed bytes")
    if n_in_parts > 1 and rows % g and g % rows:
        raise ValueError(f"an input split of {qt.n_in} rows in {n_in_parts} "
                         f"leaves {rows} rows per rank, which fall neither "
                         f"on whole groups of {g} nor inside one group")
    lead_spec = spec[:-2]
    out_spec = spec[-1]
    codes = _cut_tensor(qt.codes, lead_spec + (spec[-2], out_spec), mesh)
    if n_in_parts > 1 and rows < g:
        # a sub-group: this shard's rows lie inside group (i * rows) // g,
        # whose scale and zero row it copies
        grp = (i_in * rows) // g
        meta = [_cut_tensor(t.narrow(-2, grp, 1), lead_spec + (None, out_spec),
                            mesh).clone(memory_format=torch.contiguous_format)
                for t in (qt.scale, qt.zero)]
    else:
        meta = [_cut_tensor(t, lead_spec + (spec[-2], out_spec), mesh)
                for t in (qt.scale, qt.zero)]
    act = None if qt.act_scale is None else _cut_tensor(
        qt.act_scale, lead_spec + (spec[-2],), mesh)
    return QuantizedTensor(codes=codes, scale=meta[0], zero=meta[1],
                           spec=qt.spec, n_in=rows, packed=qt.packed,
                           act_scale=act)


def _split_parts(leaf, dim: int, n: int) -> list:
    """``leaf`` cut in ``n`` equal parts along ``dim`` (a QuantizedTensor
    along its output dimension only)."""
    if isinstance(leaf, QuantizedTensor):
        if dim != leaf.codes.dim() - 1:
            raise ValueError("a QuantizedTensor splits into parts along its "
                             "output dimension only")
        w = leaf.codes.shape[-1] // n
        return [dataclasses.replace(
            leaf, codes=leaf.codes[..., i * w:(i + 1) * w],
            scale=leaf.scale[..., i * w:(i + 1) * w],
            zero=leaf.zero[..., i * w:(i + 1) * w]) for i in range(n)]
    return list(leaf.chunk(n, dim=dim))


def _join_parts(parts: list, dim: int):
    if isinstance(parts[0], QuantizedTensor):
        return dataclasses.replace(
            parts[0], **{k: torch.cat([getattr(p, k) for p in parts], dim=-1)
                         for k in ("codes", "scale", "zero")})
    return torch.cat(parts, dim=dim)


def shard_leaf(leaf, axes, mesh, rules: Optional[dict] = None):
    """This rank's shard of one tensor or QuantizedTensor leaf annotated
    ``axes`` (``None``: the leaf itself, replicated)."""
    if axes is None or leaf is None:
        return leaf
    ndim = (leaf.codes if isinstance(leaf, QuantizedTensor) else leaf).dim()
    ann = _annotation(axes, ndim)
    found = _parts_entry(ann)
    if found is not None:
        dim, names = found
        return _join_parts(
            [shard_leaf(part, a, mesh, rules) for part, a in zip(
                _split_parts(leaf, dim, len(names)),
                _part_annotations(ann, dim, names))], dim)
    if isinstance(leaf, QuantizedTensor):
        return _cut_quantized(leaf, axes, mesh, rules)
    spec = logical_to_spec(_annotation(axes, leaf.dim()), shape=leaf.shape,
                           mesh=mesh, rules=rules)
    return _cut_tensor(leaf, spec, mesh)


def map_tree(tree, axes_tree, fn, path: str = ""):
    """``tree`` (nested dicts and lists of leaves) with every leaf replaced
    by ``fn(leaf, annotation, key string)``.  ``axes_tree`` mirrors it: a
    dict node is read key by key, a list node of ``tree`` beside a list of
    the same length element by element; otherwise the first tuple (or
    list) met on a path annotates everything below it (one annotation per
    stacked site), and a path it lacks, or annotates ``None``, passes
    ``None``."""
    if isinstance(tree, dict):
        if isinstance(axes_tree, dict):
            return {k: map_tree(v, axes_tree.get(k), fn, f"{path}[{k!r}]")
                    for k, v in tree.items()}
        return {k: map_tree(v, axes_tree, fn, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, list):
        per = (axes_tree if isinstance(axes_tree, list)
               and len(axes_tree) == len(tree) else [axes_tree] * len(tree))
        return [map_tree(v, a, fn, f"{path}[{i}]")
                for i, (v, a) in enumerate(zip(tree, per))]
    if isinstance(axes_tree, dict):
        axes_tree = None
    return fn(tree, axes_tree, path)


def shard_tree(tree, axes_tree, mesh, rules: Optional[dict] = None):
    """``tree`` (nested dicts of tensors / QuantizedTensors) with every leaf
    replaced by this rank's shard, ``axes_tree`` read as :func:`map_tree`
    reads it.  Annotations shorter or longer than a leaf's rank are padded
    / truncated with ``None``.  A leaf that cannot be cut (an input split
    that falls neither on whole groups nor inside one) raises a
    ``ValueError`` naming it, before anything is placed."""
    def cut(leaf, axes, path):
        try:
            return shard_leaf(leaf, axes, mesh, rules)
        except ValueError as err:
            raise ValueError(f"{path} on a mesh of {dict(mesh.shape)}: "
                             f"{err}") from None

    return map_tree(tree, axes_tree, cut)


def tree_specs(tree, axes_tree, mesh, rules: Optional[dict] = None) -> dict:
    """``{key: spec}`` for every tensor leaf of ``tree`` (nested dicts of
    logical-shape tensors; meta tensors will do) that :func:`shard_tree`
    cuts, with ``axes_tree`` read as :func:`map_tree` reads it: ``key``
    the leaf's key string in a checkpoint manifest (``['blocks']['wq']``),
    ``spec`` its per-dimension mesh axes (:func:`logical_to_spec`).  A
    leaf the table leaves whole has no entry."""
    out = {}

    def visit(leaf, axes, path):
        if axes is not None and isinstance(leaf, torch.Tensor):
            spec = _leaf_spec(_annotation(axes, leaf.dim()), leaf.shape,
                              mesh, rules)
            if spec_axes(spec, mesh):
                out[path] = spec
        return leaf

    map_tree(tree, axes_tree, visit)
    return out


def _leaf_spec(ann, shape, mesh, rules) -> tuple:
    """:func:`logical_to_spec` of a leaf annotated ``ann``, with a dimension
    annotated as parts given as a :class:`Parts` entry (the parts must
    agree on every other dimension)."""
    found = _parts_entry(ann)
    if found is None:
        return logical_to_spec(ann, shape=shape, mesh=mesh, rules=rules)
    dim, names = found
    part = tuple(shape[:dim]) + (shape[dim] // len(names),) \
        + tuple(shape[dim + 1:])
    specs = [logical_to_spec(a, shape=part, mesh=mesh, rules=rules)
             for a in _part_annotations(ann, dim, names)]
    if any(s[:dim] + s[dim + 1:] != specs[0][:dim] + specs[0][dim + 1:]
           for s in specs):
        raise ValueError(f"the parts of {tuple(ann)} cut the other "
                         f"dimensions differently")
    return specs[0][:dim] + (Parts(s[dim] for s in specs),) \
        + specs[0][dim + 1:]


def spec_axes(spec, mesh) -> tuple:
    """The mesh axes of more than one rank that cut a leaf of ``spec``
    (None: a whole leaf), in dimension order (a :class:`Parts` entry: the
    axes of any of its parts, once each)."""
    out = []
    for entry in spec or ():
        parts = entry if isinstance(entry, Parts) else (entry,)
        for part in parts:
            for a in (part,) if isinstance(part, str) else (part or ()):
                if mesh.size(a) > 1 and a not in out:
                    out.append(a)
    return tuple(out)


def cut_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the logical-shape ``x`` under ``spec`` (None:
    ``x`` itself)."""
    return x if spec is None else _cut_tensor(x, spec, mesh)


class MeshShape:
    """A ``(data, model)`` mesh's sizes as the rule tables read a mesh
    (every coordinate 0): what a collectives formula cuts by."""

    def __init__(self, mesh_shape):
        self.shape = dict(zip(("data", "model"), mesh_shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return 0


def training_rules(cfg, mesh) -> dict:
    """The table training places weights, AdamW moments and the EF buffer
    with: :data:`DEFAULT_RULES` (FSDP over ``data``, heads / ff / vocab /
    experts over ``model``), with the head splits of :func:`serving_rules`:
    attention replicated where the head counts do not divide ``model``
    (every rank then runs every head), and for the ssm family (xLSTM),
    whose mLSTM heads are ``ff``'s column blocks, ``heads`` and ``ff`` cut
    together where ``n_heads`` divides ``model`` and neither otherwise."""
    return _head_splits(cfg, mesh, dict(DEFAULT_RULES))


def _head_splits(cfg, mesh, rules: dict) -> dict:
    m = mesh.size("model")
    if cfg.family == "ssm":
        # the mLSTM's heads are its d_inner columns' blocks: "ff" cuts
        # whole heads where H divides, else neither is cut
        if not (m > 1 and cfg.n_heads % m == 0):
            rules.update(heads=None, ff=None)
    elif not attention_splits(cfg, m):
        rules.update(heads=None, kv_heads=None)
    return rules


def serving_rules(cfg, mesh, base: Optional[dict] = None) -> dict:
    """The table a serving engine places weights and caches with: ``base``
    (default :data:`SERVE_DECODE_RULES`) with the weights whole across
    ``data`` (no FSDP split of their input dimension while serving), no
    sequence-sharded cache, and attention replicated where the head counts
    do not divide ``model`` (the reference's shard_map guard).  The ssm
    family (xLSTM) has no attention: its mLSTM heads are ``ff``'s column
    blocks, so ``heads`` and ``ff`` are cut together where ``n_heads``
    divides ``model`` and both replicate otherwise."""
    return _head_splits(cfg, mesh, dict(
        SERVE_DECODE_RULES if base is None else base, fsdp=None,
        kv_seq=None))


def attention_splits(cfg, m: int) -> bool:
    """Whether attention runs on ``H / m`` query and ``KH / m`` KV heads per
    rank: both head counts must divide ``m`` (otherwise every rank runs
    every head)."""
    return m > 1 and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
