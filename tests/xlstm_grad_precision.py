#!/usr/bin/env python3
"""How far xlstm-350m's bf16 train gradients lie from its f32 ones, in
the port and in the reference, and why (CPU only, tiny width).

    JAX_PLATFORMS=cpu python3 tests/xlstm_grad_precision.py

A parity study beside the tests (pytest does not collect it): it
imports the JAX reference (``src/repro``) and the port, as the tests
do.  The tiny xlstm-350m
(4 layers: 3 mLSTM, then the sLSTM) takes the port's seed-0 weights
rounded to bf16 and the families test's global batches 0 and 1 (4 x 32
tokens).  For each batch it prints, per gradient leaf, the relative
norm ``||a - b|| / ||b||`` of four pairs: the port's bf16 gradient
against the reference's bf16 one, the two f32 gradients, and each
package's bf16 gradient against its own f32 one.  Then the port's f32
gradient's move when every f32 weight is scaled by ``1 + eps * N(0,
1)``, against the loss's move: a gradient continuous in the weights
moves about ``eps``; the mLSTM's normaliser ``max(|q . n|, 1)`` has a
kink, across which the gradient jumps.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as R_ARCHS  # noqa: E402
from repro.models.registry import build_model as r_build  # noqa: E402
from repro.train import trainer as r_trainer  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.dist._tree import leaves_with_keys, tree_map  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train.trainer import make_loss_fn, value_and_grad  # noqa: E402
from test_torch_mesh_train_families import _batch  # noqa: E402

CFG = ARCHS["xlstm-350m"].tiny().scaled(n_layers=4)
AUX = 0.01


def port_grads(params, batch, dtype):
    model = build_model(CFG.scaled(dtype=dtype))
    p = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
    (loss, _), g = value_and_grad(make_loss_fn(model, AUX), p,
                                  {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
    return float(loss), {k: v.float().numpy()
                         for k, v in leaves_with_keys(g)}


def ref_grads(params, batch, dtype):
    model = r_build(R_ARCHS["xlstm-350m"].tiny().scaled(
        n_layers=CFG.n_layers, dtype=dtype))

    def to_jax(tree):
        if isinstance(tree, dict):
            return {k: to_jax(v) for k, v in tree.items()}
        return jnp.asarray(tree.float().numpy()).astype(jnp.dtype(dtype))

    (loss, _), g = jax.jit(jax.value_and_grad(
        r_trainer.make_loss_fn(model, AUX), has_aux=True))(
            to_jax(params), {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                         for k, v in jax.tree_util.tree_flatten_with_path(
                             g)[0]}


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main():
    params = build_model(CFG.scaled(dtype="bfloat16")).init(0, device="cpu")
    pairs = (("port bf16", "ref bf16"), ("port f32", "ref f32"),
             ("port bf16", "port f32"), ("ref bf16", "ref f32"))
    for step in (0, 1):
        batch = _batch(CFG, step)
        runs = {}
        for dtype, short in (("bfloat16", "bf16"), ("float32", "f32")):
            runs[f"port {short}"] = port_grads(params, batch, dtype)
            runs[f"ref {short}"] = ref_grads(params, batch, dtype)
        print(f"batch {step}: losses "
              f"{ {k: round(v[0], 6) for k, v in runs.items()} }")
        print("  leaf".ljust(40) + "".join(f"{a} - {b}".rjust(22)
                                           for a, b in pairs))
        for key in sorted(runs["ref f32"][1]):
            print(f"  {key}".ljust(40) + "".join(
                f"{rel(runs[a][1][key], runs[b][1][key]):22.3e}"
                for a, b in pairs))

    batch = _batch(CFG, 0)
    p32 = tree_map(lambda t: t.float(), params)
    l0, g0 = port_grads(p32, batch, "float32")
    for eps in (1e-6, 1e-4, 4e-3):
        gen = torch.Generator().manual_seed(1)
        moved = tree_map(lambda t: t * (1 + eps * torch.randn(
            t.shape, generator=gen)), p32)
        l1, g1 = port_grads(moved, batch, "float32")
        worst = max(g0, key=lambda k: rel(g1[k], g0[k]))
        print(f"f32 weights moved by {eps:g}: loss {abs(l1 - l0) / l0:.2e} "
              f"relative; worst gradient leaf {rel(g1[worst], g0[worst]):.3e}"
              f" ({worst})")


if __name__ == "__main__":
    main()
