"""Training entry point on one device (the reference's
``repro/launch/train.py`` without its mesh): init, then the checkpointed
training loop with automatic resume.

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
        --steps 40 --ckpt-every 10 --ckpt-dir /tmp/lt

Resumes from the newest complete step in ``--ckpt-dir``; saves
``{"params", "opt"}`` asynchronously every ``--ckpt-every`` steps and once
more at the end, each labelled with the number of steps it holds, in the
reference's checkpoint format (``repro_torch.launch.serve --ckpt-dir``
serves the result).  On the card the forward and backward run the
flash-attention and rms_norm kernels.  ``--shape`` and a device mesh
arrive with the distributed slice.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch.serve import data_for
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import TrainConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None,
                    help="a production shape cell (needs a device mesh)")
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="reports/launch_train_torch")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)
    if args.shape is not None:
        raise NotImplementedError("--shape needs a device mesh, which "
                                  "arrives with the distributed slice")

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].tiny() if args.tiny else ARCHS[args.arch]
    model = build_model(cfg)
    data = data_for(cfg)
    train_step, opt = make_train_step(model, TrainConfig(
        lr=3e-3, warmup=20, total_steps=args.steps))
    params = model.init(args.seed, device=device)
    opt_state = opt.init(params)

    start = 0
    last = ckpt.latest_step(args.ckpt_dir)
    if last is not None:
        restored = ckpt.restore(args.ckpt_dir, last,
                                {"params": params, "opt": opt_state})
        params, opt_state, start = restored["params"], restored["opt"], last
        print(f"resumed from step {last} (local)")

    t0 = time.time()
    metrics = {}
    for step in range(start, args.steps):
        params, opt_state, metrics = train_step(
            params, opt_state, data.batch(step, args.batch, args.seq))
        if step % 20 == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.3f}",
                  flush=True)
        # a checkpoint's label is the number of steps it holds, so a
        # resume starts at the first step it lacks (the reference labels
        # the state after step s as s and runs step s again on resume)
        done = step + 1
        if done % args.ckpt_every == 0 and done < args.steps:
            ckpt.save_async(args.ckpt_dir, done,
                            {"params": params, "opt": opt_state})
    ckpt.wait_pending()
    ckpt.save(args.ckpt_dir, args.steps, {"params": params, "opt": opt_state})
    dt = time.time() - t0
    print(f"done {args.steps - start} steps in {dt:.1f}s; final loss "
          f"{float(metrics.get('loss', float('nan'))):.3f}")
    return params, opt_state, metrics


if __name__ == "__main__":
    main()
