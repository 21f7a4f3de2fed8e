"""Split-KV decode attention: dense ``(B, KH, S, hd)`` caches or paged
``(P, KH, ps, hd)`` stores, in the model's float type or int8 codes with
per-row f32 scales.

Wrappers of ``csrc/flash_decode.cu``, the port of the four entry points of
``repro/kernels/flash_decode.py``: :func:`flash_decode`
(``flash_decode_pallas``), :func:`flash_decode_q8`
(``flash_decode_q8_pallas``), :func:`flash_decode_paged`
(``flash_decode_paged_pallas``) and :func:`flash_decode_paged_q8`
(``flash_decode_paged_q8_pallas``).  Each has its own launch counter.  A
CPU tensor takes the plain version from :mod:`.ref`; a CUDA tensor
launches the kernel (one launch: splits, and the last split of each
(slot, KV head) combines) or raises.

Every variant splits the *logical* positions of a slot into the same
``SPLIT``-position blocks, so a paged store gives the dense kernel's bits
on the same logical cache (and paged int8 the dense int8 kernel's), and a
slot's bits do not depend on the other slots of the batch.  The combine
counters live in one zeroed buffer per (device, stream) that every launch
leaves zeroed; launches on one stream run in order, so they never share
a counter while it counts.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ._build import FLOAT, INT, PTR, Kernel
from .ref import (decode_attention_q8_ref, decode_attention_ref,
                  paged_decode_attention_q8_ref, paged_decode_attention_ref)

__all__ = ["KERNEL", "KERNEL_Q8", "KERNEL_PAGED", "KERNEL_PAGED_Q8",
           "flash_decode", "flash_decode_q8", "flash_decode_paged",
           "flash_decode_paged_q8", "decode_attention_ref",
           "decode_attention_q8_ref", "paged_decode_attention_ref",
           "paged_decode_attention_q8_ref"]

_TAIL = [INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR]
KERNEL = Kernel("flash_decode.cu", "flash_decode_launch",
                [PTR] * 9 + _TAIL)
KERNEL_Q8 = Kernel("flash_decode.cu", "flash_decode_q8_launch",
                   [PTR] * 11 + _TAIL)
KERNEL_PAGED = Kernel("flash_decode.cu", "flash_decode_paged_launch",
                      [PTR] * 10 + [INT] + _TAIL)
KERNEL_PAGED_Q8 = Kernel("flash_decode.cu", "flash_decode_paged_q8_launch",
                         [PTR] * 12 + [INT] + _TAIL)
# logical cache positions per split, whatever the page size, the batch or
# the cache length (64 measured faster than 32 and 128: PERF.md)
SPLIT = 64
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _check_q(q, kh, hd, name):
    b, t, h, qhd = q.shape
    if t != 1 or qhd != hd or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be (B, 1, H, "
                         f"{hd}) with H a multiple of KH={kh}")
    return b, h


def _on_cuda(q, name):
    """False for a CPU tensor (take the plain version); raises unless q is
    a CUDA tensor of a type the kernel takes."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be f32 or bf16, got {q.dtype}")
    return True


def _check_q8(k_codes, k_scale, v_codes, v_scale, name):
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise ValueError(f"{name}: codes must be int8, got {k_codes.dtype}, "
                         f"{v_codes.dtype}")
    want = k_codes.shape[:-1] + (1,)
    for sc in (k_scale, v_scale):
        if sc.shape != want or sc.dtype != torch.float32:
            raise ValueError(f"{name}: scales must be f32 {tuple(want)}, got "
                             f"{sc.dtype} {tuple(sc.shape)}")
    if k_codes.shape[-1] % 4:
        raise ValueError(f"{name}: the int8 kernel reads rows as 32-bit "
                         f"words and needs hd % 4 == 0, got "
                         f"{k_codes.shape[-1]}")


def _lens(cache_len, b, device):
    lens = cache_len.to(device=device, dtype=torch.int32).reshape(-1)
    return lens.expand(b).contiguous()


def _scratch(q, kh, s_logical, g, hd):
    ns = -(-s_logical // SPLIT)
    b = q.shape[0]
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty(b * kh * ns * g * hd, **f32),
            torch.empty(b * kh * ns * g, **f32),
            torch.empty(b * kh * ns * g, **f32))


def _combine_counters(device, stream, n):
    """The counter buffer of ``stream`` on ``device`` (>= n int32, zero
    between launches)."""
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _launch(kernel, q, caches, extra, lens, shape, window):
    """Allocate scratch and output, launch ``kernel``.  ``caches`` are the
    cache tensors in the C argument order, ``extra`` the pointer arguments
    between them and ``lens`` (the page table), ``shape`` the ints between
    the output and ``bs`` (B, KH, S or NP, [ps], hd, G) with ``s_logical``
    last."""
    *ints, s_logical = shape
    kh, hd, g = ints[1], ints[-2], ints[-1]
    if caches[0].numel() // hd >= 2 ** 31:
        raise ValueError(f"{kernel.symbol}: the kernel indexes rows with "
                         f"int32; {tuple(caches[0].shape)} has too many")
    po, pm, pl = _scratch(q, kh, s_logical, g, hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _combine_counters(q.device, stream, ints[0] * kh)
    out = torch.empty_like(q)
    kernel.launch(*_ptrs(q, *caches, *extra, lens, po, pm, pl, counters, out),
                  *ints, SPLIT, 0 if window is None else int(window),
                  hd ** -0.5, int(q.dtype == torch.bfloat16), stream)
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, KH, S, hd) native layout; cache_len:
    (B,) int32.  Returns (B, 1, H, hd) in q's dtype."""
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need equal (B, KH, S, hd) caches; got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, kh, s, hd = k_cache.shape
    _, h = _check_q(q, kh, hd, "flash_decode")
    if k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not _on_cuda(q, "flash_decode"):
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    window=window)
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q and caches must share an f32/bf16 dtype; got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    return _launch(KERNEL, q.contiguous(),
                   (k_cache.contiguous(), v_cache.contiguous()), (),
                   _lens(cache_len, b, q.device),
                   (b, kh, s, hd, h // kh, s), window)


def flash_decode_q8(q: torch.Tensor, k_codes: torch.Tensor,
                    k_scale: torch.Tensor, v_codes: torch.Tensor,
                    v_scale: torch.Tensor, cache_len: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """int8-KV variant: codes (B, KH, S, hd) int8, scales (B, KH, S, 1)
    f32, folded inside the kernel (codes never dequantize in memory)."""
    if k_codes.dim() != 4 or k_codes.shape != v_codes.shape:
        raise ValueError(f"need equal (B, KH, S, hd) codes; got "
                         f"{tuple(k_codes.shape)}, {tuple(v_codes.shape)}")
    b, kh, s, hd = k_codes.shape
    _, h = _check_q(q, kh, hd, "flash_decode_q8")
    if b != q.shape[0]:
        raise ValueError(f"codes {tuple(k_codes.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not _on_cuda(q, "flash_decode_q8"):
        return decode_attention_q8_ref(q, k_codes, k_scale, v_codes, v_scale,
                                       cache_len, window=window)
    _check_q8(k_codes, k_scale, v_codes, v_scale, "flash_decode_q8")
    caches = tuple(t.contiguous() for t in (k_codes, k_scale, v_codes,
                                            v_scale))
    return _launch(KERNEL_Q8, q.contiguous(), caches, (),
                   _lens(cache_len, b, q.device),
                   (b, kh, s, hd, h // kh, s), window)


def _check_table(page_table, b, name):
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"{name}: page_table must be (B={b}, NP), got "
                         f"{tuple(page_table.shape)}")
    return page_table.shape[1]


def flash_decode_paged(q: torch.Tensor, k_store: torch.Tensor,
                       v_store: torch.Tensor, page_table: torch.Tensor,
                       cache_len: torch.Tensor, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """Paged variant: stores (P, KH, ps, hd); page_table (B, NP) int32
    physical ids (unmapped entries point at the trash page 0, never read
    past ``cache_len``)."""
    if k_store.dim() != 4 or k_store.shape != v_store.shape:
        raise ValueError(f"need equal (P, KH, ps, hd) stores; got "
                         f"{tuple(k_store.shape)}, {tuple(v_store.shape)}")
    _, kh, ps, hd = k_store.shape
    b, h = _check_q(q, kh, hd, "flash_decode_paged")
    n_pages = _check_table(page_table, b, "flash_decode_paged")
    if not _on_cuda(q, "flash_decode_paged"):
        return paged_decode_attention_ref(q, k_store, v_store, page_table,
                                          cache_len, window=window)
    if k_store.dtype != q.dtype or v_store.dtype != q.dtype:
        raise ValueError(f"q and stores must share an f32/bf16 dtype; got "
                         f"{q.dtype}, {k_store.dtype}, {v_store.dtype}")
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    return _launch(KERNEL_PAGED, q.contiguous(),
                   (k_store.contiguous(), v_store.contiguous()), (table,),
                   _lens(cache_len, b, q.device),
                   (b, kh, n_pages, ps, hd, h // kh, n_pages * ps), window)


def flash_decode_paged_q8(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, page_table: torch.Tensor,
                          cache_len: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Paged int8-KV variant: code stores (P, KH, ps, hd) int8 and scale
    stores (P, KH, ps, 1) f32, read through the same page table."""
    if k_codes.dim() != 4 or k_codes.shape != v_codes.shape:
        raise ValueError(f"need equal (P, KH, ps, hd) code stores; got "
                         f"{tuple(k_codes.shape)}, {tuple(v_codes.shape)}")
    _, kh, ps, hd = k_codes.shape
    b, h = _check_q(q, kh, hd, "flash_decode_paged_q8")
    n_pages = _check_table(page_table, b, "flash_decode_paged_q8")
    if not _on_cuda(q, "flash_decode_paged_q8"):
        return paged_decode_attention_q8_ref(q, k_codes, k_scale, v_codes,
                                             v_scale, page_table, cache_len,
                                             window=window)
    _check_q8(k_codes, k_scale, v_codes, v_scale, "flash_decode_paged_q8")
    caches = tuple(t.contiguous() for t in (k_codes, k_scale, v_codes,
                                            v_scale))
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    return _launch(KERNEL_PAGED_Q8, q.contiguous(), caches, (table,),
                   _lens(cache_len, b, q.device),
                   (b, kh, n_pages, ps, hd, h // kh, n_pages * ps), window)
