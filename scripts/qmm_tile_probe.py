#!/usr/bin/env python3
"""Probe other tiles of the bf16 quant_matmul kernel on the card.

    python3 scripts/qmm_tile_probe.py                 # the shipped and probe tiles
    python3 scripts/qmm_tile_probe.py --wrapper-only  # the shipped tiles only

For each probe tile ``MT,WN`` (16,4: 128 x 128; 16,8: 128 x 256) it builds ``csrc/quant_matmul.cu`` with
``-DQMM_PROBE_MT=MT -DQMM_PROBE_WN=WN``, which adds the tile as config 4:
``TcCfg<MT, WN>``, 8 MT x rows (the wgmma's N) by 32 WN columns.  It prints
ptxas's registers and spills for the tile, then at m = 2048, 4096 -> 14336,
g = 64 (a prefill projection) times it against the shipped prefill tile
(config 3, 64 x rows by 256 columns, built into the same library) and
checks that its rows have config 3's bits.

``--wrapper-only`` times ``quant_matmul`` as the serving path calls it
(m = 4 at the four decode projections, m = 64 and m = 2048 at 4096 ->
14336) for the ``repro_torch`` found first on the path, so that two trees
can be compared in one run:

    PYTHONPATH=<other tree>/src python3 scripts/qmm_tile_probe.py --wrapper-only

Times: CUDA events, median over samples of back-to-back calls on four
weight sets (more than the 50 MB L2), as ``chip_smoke.py`` times them.
The card's name and power limit are printed first, and last one JSON line
of every number.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT / "src"))      # after PYTHONPATH: it may name another tree
sys.path.append(str(ROOT))

import chip_smoke as cs  # noqa: E402  (timing, bounds, ptxas report)
from repro_torch.core import QuantSpec, quantize_groupwise  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402

M, K, N, G = 2048, 4096, 14336, 64
PROBES = [(16, 4), (16, 8)]     # wgmma N = 128, one and two warp groups


def packed(k, n, g, gen):
    qt = quantize_groupwise(torch.randn(k, n, generator=gen, device="cuda"),
                            QuantSpec(bits=4, group_size=g), pack=True)
    return qt.codes, qt.scale, qt.zero


def build_probes(probes):
    """One nvcc per probe tile, all started together: {tile: (lib, log)}."""
    src = _build.CSRC_DIR / "quant_matmul.cu"
    digest = hashlib.sha1(src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_build.CSRC_DIR.glob("*.cuh")))
    ).hexdigest()[:12]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for mt, wn in probes:
        out = _build.BUILD_DIR / f"quant_matmul-probe{mt}x{wn}-{digest}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DQMM_PROBE_MT={mt}",
               f"-DQMM_PROBE_WN={wn}", "-o", str(out), str(src)]
        procs[(mt, wn)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), out)
    built = {}
    for tile, (proc, out) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for tile {tile}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.quant_matmul_launch.argtypes = qm.KERNEL.argtypes
        lib.quant_matmul_launch.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        built[tile] = (lib, log)
    return built


def probe_phase(probes, sets, x):
    results = []
    built = build_probes(probes)
    chunk = qm.chunk_rows(K, G)
    stream = torch.cuda.current_stream().cuda_stream
    want = qm.quant_matmul_ref(x, *sets[0])
    for (mt, wn), (lib, log) in built.items():
        row = dict(tile=f"TcCfg<{mt},{wn}>", x_rows=8 * mt, columns=32 * wn)
        for kernel, report in cs.ptxas_report(log):
            if f"TcCfgILi{mt}ELi{wn}EEELb1E" in kernel:   # the g % 64 == 0 kernel
                row["ptxas"] = report
        print(f"  probe {row['tile']} ({8 * mt} x rows by {32 * wn} columns): "
              f"{row.get('ptxas')}", flush=True)
        outs = {cfg: torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
                for cfg in (3, 4)}

        def run(cfg, i, lib=lib, outs=outs):
            c, s, z = sets[i % len(sets)]
            err = lib.quant_matmul_launch(
                x.data_ptr(), c.data_ptr(), s.data_ptr(), z.data_ptr(),
                outs[cfg].data_ptr(), None, None, M, K, N, G, K // G, chunk,
                cfg, 0, 1, stream)
            if err:
                raise RuntimeError(lib.repro_error_string(err).decode())
            return outs[cfg]

        try:
            run(4, 0)
            torch.cuda.synchronize()
        except RuntimeError as e:     # a tile too large to launch is a finding
            row["launch_error"] = str(e)
            print(f"    does not launch: {e}", flush=True)
            results.append(row)
            continue
        row["same_bits_as_cfg3"] = bool(torch.equal(run(4, 0).clone(),
                                                    run(3, 0)))
        got = run(4, 0).float()
        row["rel_err"] = float((got - want.float()).norm()
                               / want.float().norm())
        times = {3: [], 4: []}
        for cfg in (3, 4, 4, 3):
            times[cfg].append(cs.time_ms(lambda i, c=cfg: run(c, i), reps=5,
                                         inner=3))
        row["ms"] = times[4]
        row["cfg3_ms"] = times[3]
        print(f"    m={M} {K}->{N}: {times[4]} ms; shipped 64 x 256 tile "
              f"{times[3]} ms; bits equal to the shipped tile's: "
              f"{row['same_bits_as_cfg3']}; rel_err {row['rel_err']:.3e}",
              flush=True)
        results.append(row)
    return results


def wrapper_phase(gen):
    """quant_matmul's time at the serving path's shapes, beside its bound."""
    rows = []
    shapes = [(4, 4096, 14336), (4, 4096, 4096), (4, 4096, 1024),
              (4, 14336, 4096), (64, 4096, 14336), (2048, 4096, 14336)]
    for m, k, n in shapes:
        sets = [packed(k, n, G, gen) for _ in range(4)]
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        reps, inner = (5, 3) if m > 64 else (20, 10)
        ms = cs.time_ms(lambda i: qm.quant_matmul(x, *sets[i % 4]),
                        reps=reps, inner=inner)
        nbytes = m * k * 2 + k * n // 2 + 2 * (k // G) * n * 4 + m * n * 2
        b_ms, b_by = cs.bound(nbytes, 2 * m * k * n)
        print(f"  quant_matmul m={m} {k}->{n}: {ms:.4f} ms (bound "
              f"{b_ms:.4f} by {b_by})", flush=True)
        rows.append(dict(m=m, k=k, n=n, ms=ms, bound_ms=b_ms))
        del sets
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wrapper-only", action="store_true")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs a CUDA card")
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    print(f"  repro_torch from {Path(qm.__file__).parent.parent}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": smi, "wrapper": wrapper_phase(gen)}
    if not args.wrapper_only:
        sets = [packed(K, N, G, gen) for _ in range(4)]
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        result["probes"] = probe_phase(PROBES, sets, x)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
