"""Training entry point (the reference's ``repro/launch/train.py``): init,
then the checkpointed training loop with automatic resume, on one device
or on a ``(data, model)`` mesh of ranks that this command starts.

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \\
        --steps 40 --ckpt-every 10 --ckpt-dir /tmp/lt
    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \\
        --mesh 2,2 --steps 40 --ckpt-every 10 --ckpt-dir /tmp/lt

Resumes from the newest complete step in ``--ckpt-dir``; saves
``{"params", "opt"}`` asynchronously every ``--ckpt-every`` steps and once
more at the end, each labelled with the number of steps it holds, in the
reference's checkpoint format (``repro_torch.launch.serve --ckpt-dir``
serves the result).  On the card the forward and backward run the
flash-attention and rms_norm kernels.

``--mesh DATA,MODEL`` trains on ``DATA * MODEL`` ranks (FSDP over
``data``, tensor parallelism over ``model``, MoE's experts over ``model``;
:mod:`repro_torch.train.trainer`), every architecture the CLI takes
(whisper, whose batches need frame embeddings, is not one of them: its
``--arch`` is refused before any rank starts).  ``--batch`` is the global batch: data
rank ``d`` draws ``batch // DATA`` rows as host ``d`` of ``DATA``, whose
rows interleave into the same global sample stream at any mesh
(``dist.elastic.resume_batch_indices``), so a checkpoint of one mesh
resumes on another (or on one device) where it stopped.  Rank 0 finds the
step to resume from, writes the checkpoints (every rank gathers) and
prints.  ``--shape`` takes batch and sequence length from a production
shape cell.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import torch

from repro_torch.configs import ARCHS, SHAPE_CELLS
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.collectives import broadcast
from repro_torch.dist.sharding import axis_rules
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import (RANK_TIMEOUT_S, TOKEN_ARCHS, data_for,
                                      parse_mesh)
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import (TrainConfig, make_train_step,
                                       shard_params, state_specs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=TOKEN_ARCHS)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPE_CELLS),
                    help="take --batch and --seq from a production shape "
                         "cell")
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (split over the mesh's data ranks)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="reports/launch_train_torch")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    metavar="DATA,MODEL",
                    help="train on a (data, model) mesh of DATA*MODEL ranks "
                         "that this command starts, e.g. --mesh 2,2")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend of --mesh (default: nccl "
                         "with --device cuda, gloo with --device cpu)")
    args = ap.parse_args(argv)
    if args.shape is not None:
        cell = SHAPE_CELLS[args.shape]
        args.batch, args.seq = cell.global_batch, cell.seq_len

    device = resolve_device(args.device)
    if args.mesh is None:
        return train_main(args, device)
    data = args.mesh[0]
    if args.batch % data:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{data} data ranks")
    backend = args.backend or ("gloo" if device.type == "cpu" else "nccl")
    store = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        n = args.mesh[0] * args.mesh[1]
        threads = (max(1, (os.cpu_count() or 1) // n)
                   if device.type == "cpu" else None)
        return spawn(_train_rank, args.mesh, backend, store, args,
                     device=device.type, timeout=RANK_TIMEOUT_S,
                     threads=threads)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _train_rank(mesh, args):
    return train_main(args, mesh.device, mesh)


def train_main(args, device, mesh=None):
    """The CLI's run on one process: the whole state, or this rank's shards
    of it (rank 0 prints).  Returns (params, opt_state, metrics, losses);
    on a mesh (None, None, metrics as floats, losses)."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = ARCHS[args.arch].tiny() if args.tiny else ARCHS[args.arch]
    model = build_model(cfg)
    data = data_for(cfg)
    n_data = 1 if mesh is None else mesh.size("data")
    host = 0 if mesh is None else mesh.index("data")
    say(f"{cfg.name}: global batch {args.batch} x seq {args.seq}"
        + ("" if mesh is None else
           f" on mesh data={n_data} model={mesh.size('model')} "
           f"({mesh.n_ranks} {device.type} ranks, {mesh.backend})"))
    train_step, opt = make_train_step(model, TrainConfig(
        lr=3e-3, warmup=20, total_steps=args.steps), mesh=mesh)
    params = model.init(args.seed, device=device)
    specs = None
    if mesh is not None:
        params = shard_params(model, params, mesh)
        specs = state_specs(model, mesh)
    opt_state = opt.init(params)

    start = 0
    last = ckpt.latest_step(args.ckpt_dir) if lead else None
    if mesh is not None:
        with axis_rules(mesh):
            last = int(broadcast(torch.tensor(-1 if last is None else last,
                                              device=device)))
        last = None if last < 0 else last
    if last is not None:
        restored = ckpt.restore(args.ckpt_dir, last,
                                {"params": params, "opt": opt_state},
                                mesh=mesh, specs=specs)
        params, opt_state, start = restored["params"], restored["opt"], last
        where = ("local" if mesh is None else "mesh " + "x".join(
            str(s) for s in mesh.shape.values()))
        say(f"resumed from step {last} ({where})")

    t0 = time.time()
    metrics, losses = {}, []
    for step in range(start, args.steps):
        batch = data.batch(step, args.batch // n_data, args.seq, host=host,
                           n_hosts=n_data)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % 20 == 0:
            say(f"step {step:5d} loss {losses[-1]:.3f}", flush=True)
        # a checkpoint's label is the number of steps it holds, so a
        # resume starts at the first step it lacks (the reference labels
        # the state after step s as s and runs step s again on resume)
        done = step + 1
        if done % args.ckpt_every == 0 and done < args.steps:
            ckpt.save_async(args.ckpt_dir, done,
                            {"params": params, "opt": opt_state},
                            mesh=mesh, specs=specs)
    ckpt.wait_pending()
    ckpt.save(args.ckpt_dir, args.steps, {"params": params, "opt": opt_state},
              mesh=mesh, specs=specs)
    dt = time.time() - t0
    say(f"done {args.steps - start} steps in {dt:.1f}s; final loss "
        f"{float(metrics.get('loss', float('nan'))):.3f}")
    if mesh is not None:      # rank 0's numbers travel as floats
        return None, None, {k: float(v) for k, v in metrics.items()}, losses
    return params, opt_state, metrics, losses


if __name__ == "__main__":
    main()
