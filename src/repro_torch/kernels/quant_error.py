"""Fused quantization error of A candidate smoothing scales.

Wrapper of ``csrc/quant_error.cu``, the port of
``repro/kernels/quant_error.py::quant_error_pallas``: for w (k, n), scales
(A, k) and mean_sq (k,) it returns ``err[a] = sum(mean_sq[:, None] *
(deq(Q(w * s_a)) / s_a - w) ** 2) / n`` (A,) f32 — the diagonal loss the
alpha search evaluates per candidate.  A CPU tensor takes the plain
version :func:`quant_error_ref`; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import QuantSpec, effective_group_size
from ._build import FLOAT, INT, PTR, Kernel
from .ref import quant_error_ref

__all__ = ["KERNEL", "quant_error", "quant_error_ref"]

KERNEL = Kernel("quant_error.cu", "quant_error_launch",
                [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, FLOAT,
                 FLOAT, INT, INT, PTR])
COLS = 32                       # columns per block (csrc QE_COLS)
SMEM_LIMIT = 227 * 1024         # bytes of shared memory a block can use


def quant_error(w: torch.Tensor, scales: torch.Tensor, mean_sq: torch.Tensor,
                spec: QuantSpec) -> torch.Tensor:
    """w: (k, n) bf16/f32; scales: (A, k) f32 candidate act_scales;
    mean_sq: (k,) f32.  Returns (A,) f32 errors normalized by n."""
    if w.dim() != 2 or scales.dim() != 2 or scales.shape[1] != w.shape[0] \
            or mean_sq.shape != (w.shape[0],):
        raise ValueError(f"need w (k, n), scales (A, k), mean_sq (k,); got "
                         f"{tuple(w.shape)}, {tuple(scales.shape)}, "
                         f"{tuple(mean_sq.shape)}")
    if w.device.type == "cpu":
        return quant_error_ref(w, scales, mean_sq, spec)
    if w.device.type != "cuda":
        raise ValueError(f"quant_error runs on cpu or cuda, not {w.device}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_error: w must be f32 or bf16, got {w.dtype}")
    k, n = w.shape
    a = scales.shape[0]
    g = effective_group_size(k, spec.group_size)
    smem = (g * COLS + 4 * 8 * COLS + a * 8) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"quant_error: a group of {g} rows x {COLS} columns "
                         f"and {a} candidates need {smem} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    w = w.contiguous()
    scales = scales.to(device=w.device, dtype=torch.float32).contiguous()
    mean_sq = mean_sq.to(device=w.device, dtype=torch.float32).contiguous()
    n_blocks = -(-n // COLS) * (k // g)
    part = torch.empty(a * n_blocks, dtype=torch.float32, device=w.device)
    out = torch.empty(a, dtype=torch.float32, device=w.device)
    denom = spec.qmax if spec.symmetric else spec.levels - 1
    KERNEL.launch(w.data_ptr(), scales.data_ptr(), mean_sq.data_ptr(),
                  part.data_ptr(), out.data_ptr(), k, n, g, a,
                  float(spec.qmin), float(spec.qmax), float(denom),
                  int(spec.symmetric), int(w.dtype == torch.bfloat16),
                  torch.cuda.current_stream(w.device).cuda_stream)
    return out
