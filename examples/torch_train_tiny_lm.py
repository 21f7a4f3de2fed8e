"""Train a small LM on the synthetic pipeline with the PyTorch port, with
checkpointing and restart, then FAQ-quantize the trained weights.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py --device cpu \
        --steps 100
    # stop it at any time; a rerun resumes from the last checkpoint

On the card (the default device) the forward and backward run the
flash-attention and rms_norm kernels.  The checkpoints are in the
reference's format, so ``repro_torch.launch.serve --ckpt-dir`` (or the
reference's serve) can serve them.
"""
import argparse
import math
import time

from repro_torch.configs import ARCHS
from repro_torch.core import (QuantSpec, quantize_model, report_summary,
                              run_calibration)
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                        calibration_batches)
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.models.registry import build_model
from repro_torch.train.grad_compress import ef_init
from repro_torch.train.trainer import TrainConfig, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--device", default="cuda",
                    help="'cpu' runs every kernel's plain PyTorch version")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="reports/train_tiny_torch")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compress", action="store_true")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].tiny()
    model = build_model(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    train_step, opt = make_train_step(model, TrainConfig(
        lr=args.lr, warmup=30, total_steps=args.steps,
        grad_compress=args.grad_compress))

    params = model.init(0, device=device)
    opt_state = opt.init(params)
    ef = ef_init(params) if args.grad_compress else None
    start = ckpt.latest_step(args.ckpt_dir) or 0
    if start:
        restored = ckpt.restore(args.ckpt_dir, start,
                                {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        print(f"resumed from step {start}")

    t0 = time.time()
    metrics = {}
    for step in range(start, args.steps):
        batch = data.batch(step, args.batch, args.seq)
        if args.grad_compress:
            params, opt_state, ef, metrics = train_step(params, opt_state,
                                                        batch, ef)
        else:
            params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % 20 == 0:
            tok_s = args.batch * args.seq * (step - start + 1) / (time.time()
                                                                   - t0)
            print(f"step {step:5d} loss {float(metrics['loss']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {tok_s:,.0f} tok/s",
                  flush=True)
        # labelled with the number of steps the state holds
        if (step + 1) % args.ckpt_every == 0 and step + 1 < args.steps:
            ckpt.save_async(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state})
    ckpt.wait_pending()
    ckpt.save(args.ckpt_dir, args.steps, {"params": params, "opt": opt_state})
    if metrics:
        print(f"done: final loss {float(metrics['loss']):.3f} (true-process "
              f"floor ~{math.log(data.perplexity_upper_bound()):.2f})")

    # FAQ on the trained weights against RTN
    stats = run_calibration(model.forward, params,
                            calibration_batches(data, 8, 64))
    _, report = quantize_model(params, model.quant_site_map(), stats,
                               method="faq",
                               spec=QuantSpec(bits=3, group_size=64))
    for site, s in report_summary(report).items():
        print(f"  {site:22s} alpha={s['mean_alpha']:.2f} "
              f"(+{100 * s['improvement_vs_rtn']:.1f}% vs RTN)")


if __name__ == "__main__":
    main()
