#!/usr/bin/env python3
"""Where one decode step's time goes, for any registered architecture at
full width on one card.

    python3 scripts/decode_step_profile.py --arch hymba-1.5b qwen2-vl-2b

Each architecture at full width and depth, random bf16 weights from seed
0, RTN int4 (g 64, so no calibration), a dense cache of 4 slots x 1024:
warm-up steps, then the wall time of ``--reps`` decode steps ending in a
synchronize, then one step under ``torch.profiler`` (CPU and CUDA): its
CUDA kernel launches, its device time and the host operations that take
the most time; and the wall time of a 256-token batch-1 prefill.  Prints
the card's name and power limit first and one JSON line per
architecture.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT / "src"))
sys.path.append(str(ROOT))

import chip_smoke as cs  # noqa: E402  (nvidia-smi)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import QuantSpec, quantize_model  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402


def wall_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["hymba-1.5b"],
                    choices=sorted(ARCHS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("decode_step_profile: needs a CUDA card")
    print(cs.nvidia_smi(), flush=True)
    _build.build()          # every kernel, before anything is timed
    dev = torch.device("cuda")
    for name in args.arch:
        model = build_model(ARCHS[name])
        params = model.init(0, device=dev)
        qparams, _ = quantize_model(params, model.quant_site_map(), None,
                                    method="rtn", spec=QuantSpec(4, 64),
                                    mode="packed")
        del params
        cache = model.init_cache(4, 1024, device=dev)
        token = torch.randint(0, 4000, (4, 1), device=dev, dtype=torch.int32)

        def step():
            nonlocal cache
            _, cache = model.decode_step(qparams, cache, token)

        for _ in range(3):
            step()
        step_ms = wall_ms(step, args.reps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        launches = sum(e.count for e in events
                       if e.key == "cudaLaunchKernel")
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
        prompt = torch.randint(0, 4000, (1, 256), device=dev,
                               dtype=torch.int32)
        prefill_ms = wall_ms(lambda: model.prefill(
            qparams, prompt, model.init_cache(1, 1024, device=dev)), 2)
        print(json.dumps({
            "arch": name, "layers": model.cfg.n_layers,
            "decode_step_ms": step_ms, "launches_per_step": launches,
            "device_ms_per_step": device_ms,
            "top_host_ops_ms": {e.key: e.self_cpu_time_total / 1e3
                                for e in top},
            "prefill_256_ms": prefill_ms}), flush=True)
        del qparams, cache
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
