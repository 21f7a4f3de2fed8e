"""PTQ driver: calibrate once, quantize by work unit, save the packed tree
(the reference's ``repro/launch/quantize.py`` on the port).

FAQ needs only full-precision activation statistics, collected in one
forward pass for every layer at once; after it each (site, layer) weight
quantizes independently.  The work units — one per mapped parameter
path, sorted by joined path — are split round-robin over processes
(``units[process_index::process_count]``); each process quantizes its
share, and the union of the shares is the whole model.  ``--out`` saves
``{"qparams": ...}`` through the port's checkpoint (the reference's
format), which ``repro_torch.launch.serve`` and the reference both read.

    PYTHONPATH=src python -m repro_torch.launch.quantize --tiny \
        --device cpu --out /tmp/q
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, report_summary, run_calibration
from repro_torch.core.apply import _get_path, _quantize_leaf, _set_path
from repro_torch.core.methods import DEFAULT_ALPHA_GRID, site_stat_for_method
from repro_torch.data.synthetic import calibration_batches
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch.serve import data_for, load_params
from repro_torch.models.registry import build_model


def work_units(site_map: dict) -> list:
    """One unit per mapped parameter path, sorted by joined path."""
    return sorted(site_map.items(), key=lambda kv: "/".join(kv[0]))


def quantize_distributed(model, params, stats, *, method="faq",
                         spec=QuantSpec(), loss="sample", mode="packed",
                         process_index: int = 0, process_count: int = 1):
    """Quantize this process's share of the work units.

    Returns (partial_params, report, owned paths): ``partial_params`` holds
    only the units this process owns quantized (every other leaf as it
    was); merging is a union of the processes' checkpoints."""
    units = work_units(model.quant_site_map())
    own = units[process_index::process_count]
    new_params = params
    report = {}
    for path, site_key in own:
        w = _get_path(params, path)
        stats_site = stats[site_key]
        stat = None if method == "rtn" else site_stat_for_method(
            method, stats_site["mean_abs"])
        leaf, rep = _quantize_leaf(w, stat, spec, DEFAULT_ALPHA_GRID, loss,
                                   stats_site, mode)
        new_params = _set_path(new_params, path, leaf)
        report["/".join(path)] = rep
    return new_params, report, ["/".join(p) for p, _ in own]


def save_packed(out: str, qparams) -> str:
    """Write the packed tree as step 0 of ``out`` (``{"qparams": ...}``, the
    reference's layout); returns the checkpoint's path."""
    return ckpt.save(out, 0, {"qparams": qparams})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--method", default="faq")
    ap.add_argument("--calib-n", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="quantize the {'params'} of this training "
                         "checkpoint's latest step instead of random "
                         "weights")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].tiny() if args.tiny else ARCHS[args.arch]
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    if args.ckpt_dir:
        params = load_params(args.ckpt_dir, params)
    data = data_for(cfg)

    t0 = time.time()
    stats = run_calibration(model.forward, params,
                            calibration_batches(data, args.calib_n, 64))
    t_cal = time.time() - t0

    t0 = time.time()
    qparams, report, owned = quantize_distributed(
        model, params, stats, method=args.method,
        spec=QuantSpec(bits=args.bits, group_size=64))
    t_q = time.time() - t0
    print(f"process 0/1: calibrated in {t_cal:.1f}s, quantized {len(owned)} "
          f"units in {t_q:.1f}s: {owned}")
    for site, s in report_summary(report).items():
        print(f"  {site:24s} alpha={s['mean_alpha']:.2f} "
              f"(+{100 * s['improvement_vs_rtn']:.1f}% vs RTN)")
    if args.out:
        save_packed(args.out, qparams)
        print("saved to", args.out)
    return qparams, report


if __name__ == "__main__":
    main()
