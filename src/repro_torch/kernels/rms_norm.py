"""Row RMS normalisation whose bits do not depend on the number of rows.

Wrapper of ``csrc/rms_norm.cu``, a kernel of the port with no TPU
counterpart (the reference's ``rms_norm`` is plain jnp that XLA fuses):
one block per row, the squares summed in an order fixed by the row width
alone.  A CPU tensor takes the plain version :func:`rms_norm_ref`; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ._build import FLOAT, INT, PTR, Kernel
from .ref import rms_norm_ref

__all__ = ["KERNEL", "rms_norm", "rms_norm_ref"]

KERNEL = Kernel("rms_norm.cu", "rms_norm_launch",
                [PTR, PTR, PTR, INT, INT, FLOAT, INT, PTR])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * w`` over the last axis of ``x``
    (any leading shape), in f32, rounded to x's dtype.  ``w`` is (d,)."""
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rms_norm: weight {tuple(w.shape)} does not match "
                         f"rows of width {d}")
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cpu or cuda, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"rms_norm: x and w must share an f32/bf16 dtype; "
                         f"got {x.dtype}, {w.dtype}")
    rows = x.numel() // d if d else 0
    if rows >= 2 ** 31:
        raise ValueError(f"rms_norm: {rows} rows exceed the grid")
    x2 = x.contiguous()
    out = torch.empty_like(x2)
    if rows == 0:
        return out
    KERNEL.launch(x2.data_ptr(), w.contiguous().data_ptr(), out.data_ptr(),
                  rows, d, eps, x.dtype == torch.bfloat16,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out
