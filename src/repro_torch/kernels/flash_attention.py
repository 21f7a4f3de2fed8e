"""Causal flash-attention forward, GQA-grouped.

Wrapper of ``csrc/flash_attention.cu``, the port of
``repro/kernels/flash_attention.py::flash_attention_pallas``.  A CPU
tensor takes the plain version :func:`flash_attention_ref`; a CUDA tensor
launches the kernel or raises: bf16 the tensor-core kernel, f32 the
CUDA-core one.
"""
from __future__ import annotations

import torch

from ._build import FLOAT, INT, PTR, Kernel
from .ref import flash_attention_ref

__all__ = ["KERNEL", "flash_attention", "flash_attention_ref"]

KERNEL = Kernel("flash_attention.cu", "flash_attention_launch",
                [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, INT,
                 PTR])
MAX_HEAD_DIM = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (BKH, G, T, hd) grouped GQA — or (BH, T, hd) for G = 1 —
    against unrepeated k/v (BKH, T, hd), hd <= 128.  Returns q's shape."""
    q4 = q[:, None] if q.dim() == 3 else q
    if q4.dim() != 4 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"need q (BKH, G, T, hd) and equal (BKH, T, hd) "
                         f"k/v; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bkh, g, t, hd = q4.shape
    if k.shape != (bkh, t, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention supports hd <= {MAX_HEAD_DIM}, "
                         f"got {hd}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share an f32/bf16 dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    q4, k, v = q4.contiguous(), k.contiguous(), v.contiguous()
    bf16 = q.dtype == torch.bfloat16
    # the bf16 kernel loads rows by TMA: 16-byte aligned, hd % 8 == 0; pad
    # other rows with zeros (which add nothing to any score or output)
    width = hd
    if bf16 and (hd % 8 or any(x.data_ptr() % 16 for x in (q4, k, v))):
        width = -(-hd // 8) * 8
        q4, k, v = (_zero_padded(x, width) for x in (q4, k, v))
    out = torch.empty_like(q4)
    if t > 0:
        KERNEL.launch(q4.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bkh, g, t, width, int(causal),
                      hd ** -0.5, int(bf16),
                      torch.cuda.current_stream(q.device).cuda_stream)
    if width != hd:
        out = out[..., :hd].contiguous()
    return out[:, 0] if q.dim() == 3 else out


def _zero_padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """A fresh copy of ``x`` with its last dim zero-padded to ``width``."""
    out = x.new_zeros(x.shape[:-1] + (width,))
    out[..., :x.shape[-1]] = x
    return out
