"""AdamW + gradient clipping + LR schedule on tensor trees, the
reference's (``repro/train/optimizer.py``) step for step.

Not ``torch.optim.AdamW``: the details are the reference's, so a step
gives its numbers.  b2 is 0.95; weight decay is decoupled and applies only
to leaves with ``ndim >= 2`` (not norms); gradients are clipped by their
global f32 norm; the update is computed in f32 and cast back to the
parameter's dtype; the moments are kept in ``moment_dtype`` (f32 by
default).  State and update are functional: ``update`` returns new
parameter tensors and a new :class:`AdamWState`.

On a mesh every leaf of the parameters, gradients and moments is this
rank's shard: the update is elementwise on the shards, and weight decay
keys on ``ndim`` as before (a shard keeps its rank's ``ndim``).  The clip
norm is the logical gradient's (:func:`global_norm` with ``mesh=``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.dist._tree import (leaves, leaves_with_keys, map_with_keys,
                                    tree_map)
from repro_torch.dist.collectives import all_reduce
from repro_torch.dist.sharding import axis_rules, spec_axes


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.moment_dtype)
        first = leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                             device=p.device), params),
            v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                             device=p.device), params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr: torch.Tensor, *,
               mesh=None, specs: Optional[dict] = None):
        """(new_params, new_state, grad_norm): one AdamW step on trees of
        the same structure.  The clipped f32 gradients are held for every
        leaf (as the reference's are); the update's other f32 temporaries
        for one leaf at a time.  On a ``mesh`` the trees hold this rank's
        shards, cut as ``specs`` says (:func:`global_norm`)."""
        g_leaves = [g.float() for g in leaves(grads)]
        gnorm = global_norm(grads, mesh=mesh, specs=specs)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            g_leaves = [g * scale for g in g_leaves]
        step = state.step + 1
        step32 = step.float()
        b1, b2 = (torch.tensor(b, device=step.device)
                  for b in (self.b1, self.b2))
        bc1 = 1.0 - torch.pow(b1, step32)
        bc2 = 1.0 - torch.pow(b2, step32)
        dt = getattr(torch, self.moment_dtype)

        def upd(p, g, m, v):
            m32 = self.b1 * m.float() + (1 - self.b1) * g
            v32 = self.b2 * v.float() + (1 - self.b2) * g * g
            mh = m32 / bc1
            vh = v32 / bc2
            delta = mh / (torch.sqrt(vh) + self.eps)
            if self.weight_decay and p.dim() >= 2:  # no decay on norms
                delta = delta + self.weight_decay * p.float()
            new_p = p.float() - lr * delta
            return new_p.to(p.dtype), m32.to(dt), v32.to(dt)

        out = {key: upd(p, g, m, v) for (key, p), g, m, v in zip(
            leaves_with_keys(params), g_leaves, leaves(state.m),
            leaves(state.v))}
        new_params, new_m, new_v = (
            map_with_keys(lambda key, _: out[key][i], params)
            for i in range(3))
        return new_params, AdamWState(step=step, m=new_m, v=new_v), gnorm


def global_norm(tree, *, mesh=None, specs: Optional[dict] = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf^2), in f32.

    On a ``mesh`` the leaves are this rank's shards and the result is the
    norm of the logical tree: a leaf's squares are summed on its shard, and
    a leaf whole across an axis (``specs``: ``{key: spec}`` of the cut
    leaves, :func:`repro_torch.dist.sharding.tree_specs`) counts once, on
    the ranks at coordinate 0 of each axis that does not cut it; then one
    all_reduce over the mesh."""
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves(tree)[0].device)
    for key, leaf in leaves_with_keys(tree):
        if mesh is not None:
            cut = spec_axes((specs or {}).get(key), mesh)
            if any(mesh.index(a) for a in mesh.shape if a not in cut):
                continue
        total = total + torch.sum(torch.square(leaf.float()))
    if mesh is not None:
        with axis_rules(mesh):
            total = all_reduce(total, None)
    return torch.sqrt(total)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    """lr(step): linear warmup to ``base_lr`` over ``warmup`` steps, then
    cosine decay to ``min_ratio * base_lr`` at ``total``; f32, as the
    reference computes it."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                               * frac))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr
