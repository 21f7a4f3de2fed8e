#!/usr/bin/env python3
"""The rms_norm forward of this tree against an earlier tree's, on the card:
bit for bit over a grid of widths, row counts, dtypes and alignments, then
both timed at the main path's shapes beside ``torch.nn.functional.rms_norm``.

    python3 scripts/rms_norm_bits.py --rev <commit>         # in a git checkout
    python3 scripts/rms_norm_bits.py --rev <commit> --export DIR   # no card
    python3 scripts/rms_norm_bits.py --parent-dir DIR       # a copy without git

The earlier tree's ``csrc/rms_norm.cu`` and ``csrc/common.cuh`` come from
``git show <commit>:...`` (``--export`` only writes them to DIR, for a copy
of the repository that has no ``.git``).  They are built with the port's
own nvcc flags into ``src/repro_torch/build/`` under another library name
and launched through ctypes; this tree's forward goes through
``repro_torch.kernels.rms_norm.rms_norm``.

Grid: d 36, 100, 128, 1024, 1536, 1600, 2048, 4096, 5120, 7168, 16384;
1, 4, 16, 333, 2048 and 8192 rows; bf16 and f32; rows starting on 16 bytes and
shifted by one element (scalar loads).  x = randn * 3 * exp(randn / 2)
(magnitudes over a few octaves), w = rand + 0.5, eps 1e-5, all from seed 0
on the card.  Every case must be equal bit for bit: the script exits 1
otherwise.  Timing (CUDA events, ``chip_smoke.time_ms``; inputs rotated
past the 50 MB L2 at 2048 rows and more): earlier, this, this, earlier, then
``F.rms_norm``.  Prints the card's name and power limit, a line per timed
shape, and last one JSON line.
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
sys.path.append(str(ROOT / "src"))
sys.path.append(str(ROOT))

import chip_smoke as cs  # noqa: E402  (time_ms, bound, nvidia-smi, _rotated)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rms_norm as rn  # noqa: E402

SOURCES = ("rms_norm.cu", "common.cuh")
WIDTHS = (36, 100, 128, 1024, 1536, 1600, 2048, 4096, 5120, 7168, 16384)
ROWS = (1, 4, 16, 333, 2048, 8192)
DTYPES = (torch.bfloat16, torch.float32)
EPS = 1e-5
# (rows, d, dtype): the decode step, a verify pass, the families' widths,
# the train step / a prefill batch and calibration at llama3-8b's width
TIMED = ((4, 4096, torch.bfloat16), (16, 4096, torch.bfloat16),
         (2048, 1536, torch.bfloat16), (2048, 1600, torch.bfloat16),
         (2048, 2048, torch.bfloat16), (2048, 1024, torch.float32),
         (2048, 4096, torch.bfloat16), (8192, 4096, torch.bfloat16))


def export(rev: str, out: Path):
    """Write the earlier tree's sources to ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        text = subprocess.run(
            ["git", "show", f"{rev}:src/repro_torch/csrc/{name}"], cwd=ROOT,
            capture_output=True, check=True).stdout
        (out / name).write_bytes(text)


def build_parent(src_dir: Path) -> ctypes.CDLL:
    """Build ``src_dir/rms_norm.cu`` (including its own common.cuh) with
    the port's flags; the library is named by a digest of both sources."""
    text = b"".join((src_dir / n).read_bytes() for n in SOURCES)
    digest = hashlib.sha1(text).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"rms_norm_parent-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(".tmp")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                        str(src_dir), "-o", str(tmp),
                        str(src_dir / "rms_norm.cu")], check=True,
                       capture_output=True)
        tmp.replace(lib)
    cdll = ctypes.CDLL(str(lib))
    cdll.rms_norm_launch.argtypes = rn.KERNEL.argtypes
    cdll.rms_norm_launch.restype = ctypes.c_int
    return cdll


def parent_fwd(cdll, x, w, eps=EPS):
    out = torch.empty_like(x)
    err = cdll.rms_norm_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1],
        x.shape[-1], eps, x.dtype == torch.bfloat16,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier rms_norm_launch: CUDA error {err}")
    return out


def inputs(gen, rows, d, dtype, dev):
    """(aligned x, the same rows shifted by one element, w)."""
    n = rows * d
    x = torch.randn(n, generator=gen, device=dev) * 3 * torch.exp(
        torch.randn(n, generator=gen, device=dev) / 2)
    buf = torch.empty(n + 1, dtype=dtype, device=dev)
    shifted = buf[1:].view(rows, d)
    shifted.copy_(x.view(rows, d))
    w = torch.rand(d, generator=gen, device=dev) + 0.5
    return x.to(dtype).view(rows, d), shifted, w.to(dtype)


def bits(cdll, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    cases, unequal = 0, []
    for d in WIDTHS:
        for rows in ROWS:
            for dtype in DTYPES:
                aligned, shifted, w = inputs(gen, rows, d, dtype, dev)
                cs.check(shifted.data_ptr() % 16 != 0,
                         f"d {d}: the shifted rows start on 16 bytes")
                for name, x in (("aligned", aligned), ("shifted", shifted)):
                    cases += 1
                    got = rn.rms_norm(x, w, EPS)
                    want = parent_fwd(cdll, x, w)
                    if not torch.equal(got, want):
                        diff = int((got != want).sum())
                        unequal.append(f"({rows}, {d}) {str(dtype)[6:]} "
                                       f"{name}: {diff} elements differ")
                del aligned, shifted
            torch.cuda.empty_cache()
        print(f"  d {d}: {cases} cases so far, {len(unequal)} unequal",
              flush=True)
    return cases, unequal


def timings(cdll, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    lib_fn = getattr(torch.nn.functional, "rms_norm", None)
    out = []
    for rows, d, dtype in TIMED:
        size = torch.finfo(dtype).bits // 8
        w = (torch.rand(d, generator=gen, device=dev) + 0.5).to(dtype)

        def make():
            return (torch.randn(rows, d, generator=gen, device=dev)
                    * 3).to(dtype)

        sets = (cs._rotated(make, rows * d * size) if rows >= 2048
                else [make() for _ in range(8)])
        n = len(sets)
        earlier = [cs.time_ms(lambda i: parent_fwd(cdll, sets[i % n], w))]
        this = [cs.time_ms(lambda i: rn.rms_norm(sets[i % n], w, EPS))
                for _ in range(2)]
        earlier.append(cs.time_ms(lambda i: parent_fwd(cdll, sets[i % n], w)))
        lib = None if lib_fn is None else cs.time_ms(
            lambda i: lib_fn(sets[i % n], (d,), w, EPS))
        b_ms, b_by = cs.bound((2 * rows * d + d) * size, 4 * rows * d,
                              cs.F32_FLOPS_PER_S)
        row = dict(rows=rows, d=d, dtype=str(dtype)[6:], earlier_ms=earlier,
                   this_ms=this, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                   sets=n)
        print(f"  ({rows}, {d}) {row['dtype']}: this {this[0]:.4f} / "
              f"{this[1]:.4f} ms, earlier {earlier[0]:.4f} / "
              f"{earlier[1]:.4f} ms, F.rms_norm {lib}, bound {b_ms:.4f} by "
              f"{b_by}", flush=True)
        out.append(row)
        del sets
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rev", help="the earlier tree's commit")
    ap.add_argument("--export", type=Path,
                    help="only write the earlier sources here and stop")
    ap.add_argument("--parent-dir", type=Path,
                    help="the earlier sources (from --export)")
    args = ap.parse_args()
    if args.export:
        if not args.rev:
            ap.error("--export needs --rev")
        export(args.rev, args.export)
        return
    if not torch.cuda.is_available():
        sys.exit("rms_norm_bits: needs a CUDA card")
    if args.parent_dir is None:
        if not args.rev:
            ap.error("give --rev or --parent-dir")
        args.parent_dir = _build.BUILD_DIR / f"parent-src-{args.rev}"
        export(args.rev, args.parent_dir)
    dev = torch.device("cuda", 0)
    print(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{cs.nvidia_smi()}", flush=True)
    cdll = build_parent(args.parent_dir)
    cases, unequal = bits(cdll, dev)
    for u in unequal:
        print(f"  UNEQUAL {u}", flush=True)
    print(f"  {cases} cases, {cases - len(unequal)} equal bit for bit",
          flush=True)
    times = timings(cdll, dev)
    print(json.dumps({"cases": cases, "equal": cases - len(unequal),
                      "unequal": unequal, "times": times}))
    if unequal:
        sys.exit(1)


if __name__ == "__main__":
    main()
