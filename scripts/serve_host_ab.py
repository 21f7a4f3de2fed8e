#!/usr/bin/env python3
"""Serving wall time of the port at full width, to compare two trees of
the repository on one card.

    python3 scripts/serve_host_ab.py --layers 8
    PYTHONPATH=<other tree>/src python3 scripts/serve_host_ab.py --layers 8

llama3-8b at full width and ``--layers`` deep, random bf16 weights from
seed 0, RTN int4 (g 64, so no calibration), a 4-slot dense engine serving
``chip_smoke.py``'s 8 requests (12..700 prompt tokens, 32 new each), once
to warm up and then ``--reps`` times.  At this size a serve is bound by
the host launching each step's operations, so the serve's wall time over
its decode steps is the host's cost per step.  Prints the card's name and
power limit, then one JSON line: the ``repro_torch`` tree it ran, each
rep's serve seconds, the decode steps of one serve and the median ms per
decode step.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT / "src"))      # after PYTHONPATH: it may name another tree
sys.path.append(str(ROOT))

import chip_smoke as cs  # noqa: E402  (the smoke's requests, nvidia-smi)
import repro_torch  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import QuantSpec, quantize_model  # noqa: E402
from repro_torch.launch.serve import data_for  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_host_ab: needs a CUDA card")
    print(cs.nvidia_smi(), flush=True)
    cfg = ARCHS["llama3-8b"].scaled(n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    qparams, _ = quantize_model(params, model.quant_site_map(), None,
                                method="rtn", spec=QuantSpec(4, 64),
                                mode="packed")
    del params
    data = data_for(cfg)
    reqs = [Request(rid=i, prompt=data.sequence(40_000_000 + i, n),
                    max_new_tokens=cs.NEW_TOKENS)
            for i, n in enumerate(cs.PROMPT_LENS)]
    eng = ServeEngine(model, qparams, n_slots=4, max_len=1024, device="cuda")
    eng.serve(cs.fresh(reqs))
    seconds = []
    for _ in range(args.reps):
        before = eng.metrics()["decode_steps"]
        t0 = time.perf_counter()
        eng.serve(cs.fresh(reqs))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        steps = eng.metrics()["decode_steps"] - before
    print(json.dumps({
        "tree": str(Path(repro_torch.__file__).resolve().parents[2]),
        "layers": args.layers, "serve_s": seconds, "decode_steps": steps,
        "ms_per_step": 1e3 * statistics.median(seconds) / steps}))


if __name__ == "__main__":
    main()
