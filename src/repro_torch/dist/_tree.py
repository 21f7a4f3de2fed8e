"""Key paths of the port's parameter trees, in the reference's spelling.

The port's trees are nested dicts, lists and tuples, NamedTuples (the
optimizer states), :class:`~repro_torch.core.quantizer.QuantizedTensor`
and ``None``, with tensors at the leaves.  :func:`leaves_with_keys` walks
one in the order ``jax.tree_util.tree_flatten_with_path`` walks the same
tree in the reference (dict keys sorted) and names each leaf by the string
``jax.tree_util.keystr`` gives there: ``['params']['blocks']['wq']`` for
dicts, ``[0]`` for sequences, ``.step`` / ``.m['w']`` for NamedTuple
fields, and ``[<flat index i>]`` for a QuantizedTensor's children (codes,
scale, zero, act_scale; a ``None`` act_scale is no leaf).  Those strings
are the keys of a checkpoint manifest (:mod:`repro_torch.dist.checkpoint`),
so a tree saved by either package restores in the other.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

from repro_torch.core.quantizer import QuantizedTensor

# a QuantizedTensor's children in the reference's tree_flatten order
QT_CHILDREN = ("codes", "scale", "zero", "act_scale")


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_keys(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """``[(keystr, leaf), ...]`` in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaves_with_keys(tree[key], f"{prefix}[{key!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += leaves_with_keys(getattr(tree, name), f"{prefix}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, child in enumerate(tree):
            out += leaves_with_keys(child, f"{prefix}[{i}]")
        return out
    if isinstance(tree, QuantizedTensor):
        out = []
        for i, name in enumerate(QT_CHILDREN):
            out += leaves_with_keys(getattr(tree, name),
                                    f"{prefix}[<flat index {i}>]")
        return out
    return [(prefix, tree)]


def map_with_keys(fn: Callable[[str, object], object], tree, prefix: str = ""):
    """The tree with every leaf replaced by ``fn(keystr, leaf)``; dicts keep
    their key order, NamedTuples, QuantizedTensors and ``None`` re-form."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_keys(fn, getattr(tree, n),
                                          f"{prefix}.{n}")
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_keys(fn, c, f"{prefix}[{i}]")
                          for i, c in enumerate(tree))
    if isinstance(tree, QuantizedTensor):
        kids = {n: map_with_keys(fn, getattr(tree, n),
                                 f"{prefix}[<flat index {i}>]")
                for i, n in enumerate(QT_CHILDREN)}
        return QuantizedTensor(spec=tree.spec, n_in=tree.n_in,
                               packed=tree.packed, **kids)
    return fn(prefix, tree)


def tree_map(fn: Callable, tree):
    """The tree with every leaf replaced by ``fn(leaf)``."""
    return map_with_keys(lambda _, leaf: fn(leaf), tree)


def leaves(tree) -> list:
    """The leaves, in the reference's flatten order."""
    return [leaf for _, leaf in leaves_with_keys(tree)]
