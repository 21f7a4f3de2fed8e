"""Fused quantization error of A candidate smoothing scales.

Wrapper of ``csrc/quant_error.cu``, the port of
``repro/kernels/quant_error.py::quant_error_pallas``: for w (k, n), scales
(A, k) and mean_sq (k,) it returns ``err[a] = sum(mean_sq[:, None] *
(deq(Q(w * s_a)) / s_a - w) ** 2) / n`` (A,) f32 — the diagonal loss the
alpha search evaluates per candidate.  A CPU tensor takes the plain
version :func:`quant_error_ref`; a CUDA tensor launches the kernel or
raises.  :func:`plan` makes the launch's choices in plain Python, so that
the CPU tests can hold them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.quantizer import QuantSpec, effective_group_size
from ._build import FLOAT, INT, PLAIN_DEVICES, PTR, Kernel
from .ref import quant_error_ref

__all__ = ["KERNEL", "quant_error", "quant_error_ref", "plan", "Plan"]

KERNEL = Kernel("quant_error.cu", "quant_error_launch",
                [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, FLOAT,
                 INT, INT, INT, INT, PTR])
# The kernel's geometry; the first launch checks it against the library's.
COLS = 128                      # columns per block, one per thread
REGISTER_GROUPS = (64, 128)     # g with a register-path instantiation
PER_CANDIDATE_ROW = 3           # shared floats: s, 1/s as hi + lo
PER_ROW = 1                     # shared floats: mean_sq
SMEM_LIMIT = 232448             # bytes of shared memory a block can use
MAX_GRID_Y = 65535              # groups per column tile (gridDim.y)
MAX_BITS = 16                   # the kernel's rounding holds for |q| < 2^22


class Plan(NamedTuple):
    path: int                   # 64 / 128: register path of that g; 0: any g
    grid: Tuple[int, int]       # (column tiles, groups)
    smem: int                   # dynamic shared memory per block, bytes
    n_blocks: int               # partials per candidate


def plan(k: int, n: int, g: int, a: int) -> Plan:
    """The launch for w (k, n) in groups of g rows and ``a`` candidates.

    Blocks are COLS columns x one group; each stages s, 1/s as two floats
    and mean_sq for its g rows and all ``a`` candidates, plus each thread's
    error per candidate.  The tiling depends on k, n and g only, so a
    candidate's error does not depend on the others."""
    if k < 1 or n < 1 or g < 1 or k % g:
        raise ValueError(f"quant_error: need k, n >= 1 and g dividing k; got "
                         f"k={k}, n={n}, g={g}")
    if a < 1:
        raise ValueError(f"quant_error: need at least one candidate, got {a}")
    smem = (PER_CANDIDATE_ROW * a * g + PER_ROW * g + COLS * a) * 4
    if smem > SMEM_LIMIT:
        a_max = (SMEM_LIMIT // 4 - PER_ROW * g) // (PER_CANDIDATE_ROW * g
                                                    + COLS)
        raise ValueError(
            f"quant_error: {a} candidates x a group of {g} rows need {smem} "
            f"bytes of shared memory per block, more than the card's "
            f"{SMEM_LIMIT}; at g={g} at most {a_max} candidates fit")
    if k // g > MAX_GRID_Y:
        raise ValueError(f"quant_error: {k // g} groups of {g} rows exceed "
                         f"the grid's {MAX_GRID_Y}")
    grid = (-(-n // COLS), k // g)
    return Plan(g if g in REGISTER_GROUPS else 0, grid, smem,
                grid[0] * grid[1])


_geometry_checked = False


def _check_geometry() -> None:
    """At the first launch: the library was built with the geometry plan()
    assumes (its tile, register paths and shared-memory layout)."""
    global _geometry_checked
    if not _geometry_checked:
        geo = (ctypes.c_int * 5)()
        KERNEL.lib().quant_error_geometry(geo)
        ours = [COLS, *REGISTER_GROUPS, PER_CANDIDATE_ROW, PER_ROW]
        if list(geo) != ours:
            raise RuntimeError(f"quant_error.cu's geometry {list(geo)} is "
                               f"not the wrapper's {ours}")
        _geometry_checked = True


def quant_error(w: torch.Tensor, scales: torch.Tensor, mean_sq: torch.Tensor,
                spec: QuantSpec) -> torch.Tensor:
    """w: (k, n) bf16/f32; scales: (A, k) f32 candidate act_scales;
    mean_sq: (k,) f32.  Returns (A,) f32 errors normalized by n."""
    if w.dim() != 2 or scales.dim() != 2 or scales.shape[1] != w.shape[0] \
            or mean_sq.shape != (w.shape[0],):
        raise ValueError(f"need w (k, n), scales (A, k), mean_sq (k,); got "
                         f"{tuple(w.shape)}, {tuple(scales.shape)}, "
                         f"{tuple(mean_sq.shape)}")
    if w.device.type in PLAIN_DEVICES:
        return quant_error_ref(w, scales, mean_sq, spec)
    if w.device.type != "cuda":
        raise ValueError(f"quant_error runs on cpu, meta or cuda, not "
                         f"{w.device}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_error: w must be f32 or bf16, got {w.dtype}")
    if spec.bits > MAX_BITS:
        raise ValueError(f"quant_error: at most {MAX_BITS} bits, got "
                         f"{spec.bits}")
    k, n = w.shape
    a = scales.shape[0]
    g = effective_group_size(k, spec.group_size)
    p = plan(k, n, g, a)
    _check_geometry()
    w = w.contiguous()
    scales = scales.to(device=w.device, dtype=torch.float32).contiguous()
    mean_sq = mean_sq.to(device=w.device, dtype=torch.float32).contiguous()
    part = torch.empty(a * p.n_blocks, dtype=torch.float32, device=w.device)
    out = torch.empty(a, dtype=torch.float32, device=w.device)
    denom = spec.qmax if spec.symmetric else spec.levels - 1
    KERNEL.launch(w.data_ptr(), scales.data_ptr(), mean_sq.data_ptr(),
                  part.data_ptr(), out.data_ptr(), k, n, g, a,
                  float(spec.qmax), float(denom),
                  int(spec.symmetric), int(w.dtype == torch.bfloat16),
                  p.path, p.smem,
                  torch.cuda.current_stream(w.device).cuda_stream)
    return out
