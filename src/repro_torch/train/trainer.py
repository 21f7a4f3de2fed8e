"""Train-step factory: loss, microbatch accumulation, optional int8
gradient compression (the reference's ``repro/train/trainer.py``), on one
device or on a ``(data, model)`` mesh.

``make_train_step(model, tcfg[, mesh])`` returns ``(train_step, opt)``
with ``train_step(params, opt_state, batch[, ef_state]) -> (params,
opt_state[, ef_state], metrics)``.  Gradients come from
``torch.autograd.grad`` on leaf copies of the parameters (views of the
same storage with ``requires_grad``); the update runs under
``torch.no_grad()`` and returns new tensors.  On the card the forward and
backward run the flash-attention and rms_norm kernels (their autograd
Functions).

On a mesh (the reference's training under ``DEFAULT_RULES``; every
family) every rank holds its shards of the parameters, both AdamW moments
and the EF buffer (:func:`shard_params`, cut by
:func:`~repro_torch.dist.sharding.training_rules`: FSDP over ``data``,
heads / ff / vocab / experts over ``model``) and takes its ``data``
coordinate's share of the global batch.  The forward gathers each layer's
FSDP shards over ``data`` and runs tensor parallelism over ``model`` (the
models' own layers: :mod:`repro_torch.models.dense` and the families);
the collectives carry the gradients back, so an FSDP leaf's gradient
arrives summed over ``data`` and cut to the shard (a reduce_scatter), and
a leaf whole across ``model`` that meets only a rank's part of the work
(MoE's router on the rank's tokens, Mamba's ``dt_proj`` on its channels)
arrives summed over ``model`` (the models pass it through ``copy_to``).
The step scales the data sums by ``1 / data``, all-reduces the leaves
whole across ``data`` (the norms) once, and so holds the gradient of the
global mean loss; the metrics are global means, the same on every rank
(MoE's aux loss is each rank's mean over ``model``, whose mean over
``data`` the step takes with the loss's); the clip norm and the
compression scales are the logical tensors'.  Each model's
``train_collectives(mesh_shape, ...)`` is the collectives per step of
that run (:data:`~repro_torch.dist.collectives.COUNTS`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ARCHS
from repro_torch.dist._tree import (leaves, leaves_with_keys, map_with_keys,
                                    tree_map)
from repro_torch.dist.collectives import all_reduce
from repro_torch.dist.sharding import (axis_rules, shard_tree, spec_axes,
                                       training_rules, tree_specs)
from repro_torch.models.dense import DenseLM
from .grad_compress import compress_grads
from .optimizer import AdamW, cosine_schedule

METRICS = ("loss", "ce", "moe_aux")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in f32.  Padded-vocab logits carry a -1e30
    mask already (the models guarantee it), so the softmax is exact."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moe_aux_coef: float = 0.01
    microbatches: int = 1          # gradient accumulation
    moment_dtype: str = "float32"
    grad_compress: bool = False    # int8 EF compression


def make_loss_fn(model, aux_coef: float):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        labels = batch["labels"]
        loss = cross_entropy(logits[:, :-1], labels[:, 1:])
        total = loss + aux_coef * aux["moe_aux"]
        return total, {"ce": loss, "moe_aux": aux["moe_aux"]}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``((loss, aux), grads)`` of ``loss_fn(params, batch)``, grads a tree
    like ``params``."""
    keyed = leaves_with_keys(params)
    live = {key: p.detach().requires_grad_() for key, p in keyed}
    with torch.enable_grad():
        total, aux = loss_fn(map_with_keys(lambda key, _: live[key], params),
                             batch)
        grads = dict(zip(live, torch.autograd.grad(total,
                                                   list(live.values()))))
    return ((total.detach(), {k: v.detach() for k, v in aux.items()}),
            map_with_keys(lambda key, _: grads[key], params))


def step_collectives(n_layers: int, mesh_shape, *, remat: bool = False,
                     microbatches: int = 1,
                     grad_compress: bool = False) -> dict:
    """Collective calls per kind (:data:`~repro_torch.dist.collectives.
    COUNTS`) of one dense train step of ``n_layers`` layers on a ``(data,
    model)`` mesh: :meth:`DenseLM.train_collectives` of llama3-8b's widths
    at that depth, where every cut divides the mesh.  ``d`` / ``m`` below
    are 1 where that axis has more than one rank, else 0.  Per microbatch:

    - all_gather: the FSDP gathers of each layer's 7 weights, the
      embedding and the head (``d``; under ``remat`` the recompute gathers
      the 7 again), and the logits' vocab columns (``m``);
    - reduce_scatter: the FSDP gathers' backward (``d``);
    - all_reduce (``m``): the embedding's, ``wo``'s and ``w_down``'s
      forward sums and the backward sums of the 2 L + 1 column inputs;
      under ``remat`` the recompute's ``wo`` sum again (torch's
      non-reentrant checkpoint stops before ``w_down``'s, whose output the
      backward does not need).

    Per step, all_reduce: the data sums of the leaves whole across
    ``data`` and of the metrics (``d``, one each), the clip norm's (one),
    and the compression scales' (one with ``grad_compress``)."""
    model = DenseLM(ARCHS["llama3-8b"].scaled(n_layers=n_layers))
    return model.train_collectives(mesh_shape, remat=remat,
                                   microbatches=microbatches,
                                   grad_compress=grad_compress)


def param_specs(model, mesh) -> dict:
    """``{key: spec}`` of the parameter leaves a mesh cuts (keys as in a
    checkpoint manifest, :func:`~repro_torch.dist.sharding.tree_specs`),
    from the model's shapes (its meta-device init) under
    :func:`~repro_torch.dist.sharding.training_rules`."""
    return tree_specs(model.init(device="meta"), model.param_axes(), mesh,
                      training_rules(model.cfg, mesh))


def state_specs(model, mesh) -> dict:
    """``specs`` of the checkpointed train state ``{"params": params,
    "opt": AdamWState}`` (both moments cut as the parameters)."""
    specs = {}
    for key, spec in param_specs(model, mesh).items():
        for prefix in ("['params']", "['opt'].m", "['opt'].v"):
            specs[prefix + key] = spec
    return specs


def shard_params(model, params, mesh):
    """This rank's shards of whole ``params`` (the moments and the EF
    buffer are made from them, so they come cut alike)."""
    return shard_tree(params, model.param_axes(), mesh,
                      training_rules(model.cfg, mesh))


def make_grad_fn(model, tcfg: TrainConfig, mesh=None):
    """``grad_fn(params, batch) -> (grads, metrics)``: a step's gradient
    before the update (microbatches accumulated; on a ``mesh`` this rank's
    shards of the global mean loss's gradient and the global metrics;
    ``batch`` as :func:`make_train_step` takes it, already on the
    parameters' device)."""
    loss_fn = make_loss_fn(model, tcfg.moe_aux_coef)
    mb = tcfg.microbatches
    specs = None if mesh is None else param_specs(model, mesh)

    def grads_and_metrics(params, batch):
        if mb > 1:
            n = next(iter(batch.values())).shape[0] // mb
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = {"loss": 0.0, "ce": 0.0, "moe_aux": 0.0}
            for i in range(mb):
                sub = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                (loss, metr), g = value_and_grad(loss_fn, params, sub)
                flat = dict(leaves_with_keys(g))
                grads = map_with_keys(
                    lambda key, a: a + flat[key].float() / mb, grads)
                metrics = {k: metrics[k] + x / mb
                           for k, x in {"loss": loss, **metr}.items()}
        else:
            (loss, metr), grads = value_and_grad(loss_fn, params, batch)
            metrics = {"loss": loss, **metr}
        return grads, metrics

    if mesh is None:
        return grads_and_metrics

    def grad_fn(params, batch):
        with axis_rules(mesh, training_rules(model.cfg, mesh)):
            grads, metrics = grads_and_metrics(params, batch)
            return _over_data(grads, metrics, mesh, specs)

    return grad_fn


def make_train_step(model, tcfg: TrainConfig, mesh=None):
    """``(train_step, opt)``; with a ``mesh``, the step on this rank's
    shards (see the module docstring) and its ``data`` coordinate's rows
    (``batch`` is this rank's share: ``SyntheticLM.batch(step, B // data,
    T, host=mesh.index("data"), n_hosts=data)``).  ``mesh=None`` is the
    single-device step."""
    if mesh is not None:
        if mesh.size("pod") > 1:
            raise NotImplementedError("training on a mesh takes (data, "
                                      "model) meshes; a pod axis is not "
                                      "ported")
    opt = AdamW(weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
                moment_dtype=tcfg.moment_dtype)
    lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    grad_fn = make_grad_fn(model, tcfg, mesh)
    specs = None if mesh is None else param_specs(model, mesh)

    def train_step(params, opt_state, batch, ef_state=None):
        dev = leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        grads, metrics = grad_fn(params, batch)
        if tcfg.grad_compress:
            grads, ef_state = compress_grads(grads, ef_state, mesh=mesh)
        # the schedule is indexed from 1 (warmup step 0 would be a zero-lr
        # no-op)
        lr = lr_fn(opt_state.step + 1)
        params, opt_state, gnorm = opt.update(grads, opt_state, params, lr,
                                              mesh=mesh, specs=specs)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        if tcfg.grad_compress:
            return params, opt_state, ef_state, metrics
        return params, opt_state, metrics

    return train_step, opt


def _over_data(grads, metrics, mesh, specs):
    """Each rank's gradients and metrics of its own rows -> those of the
    global batch (every data rank holds the same number of rows): FSDP
    leaves arrive summed over ``data`` and are scaled by ``1 / data``;
    leaves whole across ``data`` and the metrics are summed in one
    all_reduce each (in f32) and scaled alike.  Each gradient keeps its
    dtype."""
    d = mesh.size("data")
    if d == 1:
        return grads, metrics
    keyed = leaves_with_keys(grads)
    whole = [key for key, _ in keyed
             if "data" not in spec_axes(specs.get(key), mesh)]
    out = {key: g.float() / d for key, g in keyed}
    if whole:
        flat = all_reduce(torch.cat([out[key].reshape(-1) for key in whole]),
                          "data")
        for key, part in zip(whole, torch.split(
                flat, [out[key].numel() for key in whole])):
            out[key] = part.reshape(out[key].shape)
    out = {key: out[key].to(g.dtype) for key, g in keyed}
    dev = keyed[0][1].device
    summed = all_reduce(torch.stack([torch.as_tensor(
        metrics[k], dtype=torch.float32, device=dev) for k in METRICS]),
        "data") / d
    metrics = dict(metrics, **dict(zip(METRICS, summed.unbind())))
    return map_with_keys(lambda key, _: out[key], grads), metrics
