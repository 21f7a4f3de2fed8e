"""W4A16 grouped dequant-GEMM: ``x @ ((nibble - zero) * scale)``.

Wrapper of ``csrc/quant_matmul.cu``, the port of
``repro/kernels/quant_matmul.py::quant_matmul_pallas``.  A CPU tensor
takes the plain version :func:`quant_matmul_ref`; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, Kernel
from .ref import dequant_ref, quant_matmul_ref

__all__ = ["KERNEL", "quant_matmul", "quant_matmul_ref", "dequant_ref"]

KERNEL = Kernel("quant_matmul.cu", "quant_matmul_launch",
                [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR])


def _check(x, codes, scale, zero):
    if x.dim() != 2 or codes.dim() != 2:
        raise ValueError(f"x must be (m, k) and codes (k//2, n); got "
                         f"{tuple(x.shape)} and {tuple(codes.shape)}")
    m, k = x.shape
    n = codes.shape[1]
    if codes.shape[0] * 2 != k or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 (k//2, n) for k={k}; got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    n_groups = scale.shape[0]
    if (scale.shape != (n_groups, n) or zero.shape != scale.shape
            or n_groups == 0 or k % n_groups):
        raise ValueError(f"scale/zero must be (k//g, n); got "
                         f"{tuple(scale.shape)} / {tuple(zero.shape)}")
    return m, k, n, k // n_groups


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor) -> torch.Tensor:
    """x: (m, k) bf16/f32; codes: (k//2, n) packed uint8; scale/zero:
    (k//g, n) f32.  Returns (m, n) in x's dtype (f32 accumulation)."""
    m, k, n, g = _check(x, codes, scale, zero)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, codes, scale, zero)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cpu or cuda, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_matmul takes f32 or bf16 x, not {x.dtype}")
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise ValueError("scale and zero must be float32")
    for t in (codes, scale, zero):
        if t.device != x.device:
            raise ValueError("x, codes, scale and zero must share a device")
    x, codes = x.contiguous(), codes.contiguous()
    scale, zero = scale.contiguous(), zero.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = KERNEL.lib()
    partial = None
    if m <= lib.quant_matmul_skinny_max_m():
        kc = lib.quant_matmul_kchunk()
        partial = torch.empty((-(-k // kc)) * m * n, dtype=torch.float32,
                              device=x.device)
    KERNEL.launch(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                  zero.data_ptr(), out.data_ptr(),
                  None if partial is None else partial.data_ptr(),
                  m, k, n, g, 1 if x.dtype == torch.bfloat16 else 0,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out
