"""Quickstart on the PyTorch port: FAQ-quantize a model and compare its
logits with the float model's.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py          # on the card
"""
import argparse

import torch

from repro_torch.configs import ARCHS
from repro_torch.core import (QuantSpec, quantize_model, report_summary,
                              run_calibration)
from repro_torch.models.registry import build_model

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="'cpu' runs every kernel's plain PyTorch version")
args = ap.parse_args()

# 1. any ported architecture; .tiny() shrinks it for the CPU
cfg = ARCHS["llama3-8b"].tiny()
model = build_model(cfg)
params = model.init(0, device=args.device)

# 2. one calibration pass collects every layer's activation statistics,
#    the future layers FAQ previews included
gen = torch.Generator().manual_seed(0)
calib = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 64), generator=gen)}
         for _ in range(4)]
stats = run_calibration(model.forward, params, calib)

# 3. quantize: the paper's presearched FAQ (gamma 0.85, window 3), 3-bit
qparams, report = quantize_model(
    params, model.quant_site_map(), stats,
    method="faq", spec=QuantSpec(bits=3, group_size=64), mode="fake")

# 4. the quantized tree is a drop-in replacement
batch = {"tokens": calib[0]["tokens"].to(args.device)}
with torch.no_grad():
    logits_fp, _ = model.forward(params, batch)
    logits_q, _ = model.forward(qparams, batch)
rmse = float(torch.sqrt(torch.mean((logits_q.float() - logits_fp.float()) ** 2)))
print("logit rmse:", rmse)
for site, s in report_summary(report).items():
    print(f"  {site:22s} alpha={s['mean_alpha']:.2f} "
          f"loss={s['mean_loss']:.5f} (+{100 * s['improvement_vs_rtn']:.1f}% "
          f"vs RTN)")
