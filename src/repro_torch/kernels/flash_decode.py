"""Split-KV decode attention against a dense ``(B, KH, S, hd)`` cache.

Wrapper of ``csrc/flash_decode.cu``, the port of
``repro/kernels/flash_decode.py::flash_decode_pallas`` (dense variant).
A CPU tensor takes the plain version :func:`decode_attention_ref`; a
CUDA tensor launches the kernel (splits + combine) or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._build import FLOAT, INT, PTR, Kernel
from .ref import decode_attention_ref

__all__ = ["KERNEL", "flash_decode", "decode_attention_ref"]

KERNEL = Kernel("flash_decode.cu", "flash_decode_launch",
                [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                 INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR])
SPLIT = 128     # cache positions per split


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, KH, S, hd) native layout; cache_len:
    (B,) int32.  Returns (B, 1, H, hd) in q's dtype."""
    b, t, h, hd = q.shape
    if t != 1 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need q (B, 1, H, hd) and equal (B, KH, S, hd) "
                         f"caches; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    kh, s = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != hd or h % kh:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda, not {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q and caches must share an f32/bf16 dtype; got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    g = h // kh
    lens = cache_len.to(device=q.device, dtype=torch.int32).reshape(-1)
    lens = lens.expand(b).contiguous()
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), \
        v_cache.contiguous()
    bs = min(SPLIT, s)
    ns = -(-s // bs)
    f32 = dict(dtype=torch.float32, device=q.device)
    po = torch.empty(b * kh * ns * g * hd, **f32)
    pm = torch.empty(b * kh * ns * g, **f32)
    pl = torch.empty(b * kh * ns * g, **f32)
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lens.data_ptr(), po.data_ptr(), pm.data_ptr(),
                  pl.data_ptr(), out.data_ptr(), b, kh, s, hd, g, bs,
                  0 if window is None else int(window), hd ** -0.5,
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
