#!/usr/bin/env python3
"""Device time of each launch inside the two training backward kernels,
at the train path's shapes, to see which pass holds them back.

    python3 scripts/bwd_profile.py
    PYTHONPATH=<other tree>/src python3 scripts/bwd_profile.py

flash_attention_bwd (bf16, causal, GQA 4) at q (32, 4, 512, 128), the
2-layer train path's attention, and at q (8, 4, 4096, 128), the
reference's training length; rms_norm_bwd (bf16) at (2048, 4096).  Each
is timed as ``chip_smoke.py`` times it (CUDA events), then 10 calls run
under ``torch.profiler``, whose device time per kernel name is printed per
call.  Inputs are random from seed 0.  Prints the card's name and power
limit, then one JSON line.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT / "src"))      # after PYTHONPATH: it may name another tree
sys.path.append(str(ROOT))

import chip_smoke as cs  # noqa: E402  (time_ms, nvidia-smi)
import repro_torch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rms_norm as rn  # noqa: E402

CALLS = 10


def per_kernel_ms(fn):
    """{kernel name: device ms per call} over CALLS calls of fn."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0]: e.self_device_time_total / 1e3 / CALLS
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main():
    if not torch.cuda.is_available():
        sys.exit("bwd_profile: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    out = {"tree": str(Path(repro_torch.__file__).parent)}
    for bkh, t in ((32, 512), (8, 4096)):
        q, do = randn(bkh, 4, t, 128), randn(bkh, 4, t, 128)
        k, v = randn(bkh, t, 128), randn(bkh, t, 128)
        o, lse = fa._forward(q, k, v, True, None, with_lse=True)

        def bwd():
            return fa.flash_attention_bwd(q, k, v, o, lse, do)

        out[f"flash_attention_bwd T {t}"] = {
            "ms": cs.time_ms(lambda i: bwd(), reps=10, inner=3),
            "kernels": per_kernel_ms(bwd)}
    x, dy, w = randn(2048, 4096) * 3, randn(2048, 4096), randn(4096)

    def rms_bwd():
        return rn.rms_norm_bwd(x, w, dy, 1e-5)

    out["rms_norm_bwd (2048, 4096)"] = {
        "ms": cs.time_ms(lambda i: rms_bwd()), "kernels": per_kernel_ms(rms_bwd)}
    for name, r in out.items():
        if name != "tree":
            print(f"{name}: {r['ms']:.4f} ms; " + ", ".join(
                f"{k} {ms:.4f}" for k, ms in r["kernels"].items()), flush=True)
    print(cs.nvidia_smi())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
