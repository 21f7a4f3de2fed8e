"""Train-step factory: loss, microbatch accumulation, optional int8
gradient compression (the reference's ``repro/train/trainer.py``).

``make_train_step(model, tcfg)`` returns ``(train_step, opt)`` with
``train_step(params, opt_state, batch[, ef_state]) -> (params, opt_state[,
ef_state], metrics)``.  Gradients come from ``torch.autograd.grad`` on
leaf copies of the parameters (views of the same storage with
``requires_grad``); the update runs under ``torch.no_grad()`` and returns
new tensors.  On the card the forward and backward run the
flash-attention and rms_norm kernels (their autograd Functions).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist._tree import (leaves, leaves_with_keys, map_with_keys,
                                    tree_map)
from .grad_compress import compress_grads
from .optimizer import AdamW, cosine_schedule


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


def make_train_step(model, tcfg: TrainConfig):
    opt = AdamW(weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
                moment_dtype=tcfg.moment_dtype)
    lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    loss_fn = make_loss_fn(model, tcfg.moe_aux_coef)
    mb = tcfg.microbatches

    def train_step(params, opt_state, batch, ef_state=None):
        dev = leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
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

        if tcfg.grad_compress:
            grads, ef_state = compress_grads(grads, ef_state)

        # the schedule is indexed from 1 (warmup step 0 would be a zero-lr
        # no-op)
        lr = lr_fn(opt_state.step + 1)
        params, opt_state, gnorm = opt.update(grads, opt_state, params, lr)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        if tcfg.grad_compress:
            return params, opt_state, ef_state, metrics
        return params, opt_state, metrics

    return train_step, opt
