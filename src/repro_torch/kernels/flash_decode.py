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

The verify variants (:func:`flash_verify`, :func:`flash_verify_q8`,
:func:`flash_verify_paged`, :func:`flash_verify_paged_q8`) score a burst
of T positions per slot in one launch of the same kernel: row t attends the
first ``base_len + t + 1`` entries and runs exactly the T = 1 body at that
length, so it gives the bits of the decode variant called with
``cache_len = base_len + t + 1``.  They replace the reference's T
sequential decode calls of a speculative verify
(``repro/kernels/ops.py::_verify_attention_local``).

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

from ._build import FLOAT, INT, PLAIN_DEVICES, PTR, Kernel
from .ref import (decode_attention_q8_ref, decode_attention_ref,
                  paged_decode_attention_q8_ref, paged_decode_attention_ref,
                  paged_verify_attention_q8_ref, paged_verify_attention_ref,
                  verify_attention_q8_ref, verify_attention_ref)

__all__ = ["KERNEL", "KERNEL_Q8", "KERNEL_PAGED", "KERNEL_PAGED_Q8",
           "flash_decode", "flash_decode_q8", "flash_decode_paged",
           "flash_decode_paged_q8", "decode_attention_ref",
           "decode_attention_q8_ref", "paged_decode_attention_ref",
           "paged_decode_attention_q8_ref", "VERIFY", "VERIFY_Q8",
           "VERIFY_PAGED", "VERIFY_PAGED_Q8", "flash_verify",
           "flash_verify_q8", "flash_verify_paged", "flash_verify_paged_q8",
           "verify_attention_ref", "verify_attention_q8_ref",
           "paged_verify_attention_ref", "paged_verify_attention_q8_ref"]

_TAIL = [INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR]
KERNEL = Kernel("flash_decode.cu", "flash_decode_launch",
                [PTR] * 9 + _TAIL)
KERNEL_Q8 = Kernel("flash_decode.cu", "flash_decode_q8_launch",
                   [PTR] * 11 + _TAIL)
KERNEL_PAGED = Kernel("flash_decode.cu", "flash_decode_paged_launch",
                      [PTR] * 10 + [INT] + _TAIL)
KERNEL_PAGED_Q8 = Kernel("flash_decode.cu", "flash_decode_paged_q8_launch",
                         [PTR] * 12 + [INT] + _TAIL)
# the verify entry points take T after B
VERIFY = Kernel("flash_decode.cu", "flash_verify_launch",
                [PTR] * 9 + [INT] + _TAIL)
VERIFY_Q8 = Kernel("flash_decode.cu", "flash_verify_q8_launch",
                   [PTR] * 11 + [INT] + _TAIL)
VERIFY_PAGED = Kernel("flash_decode.cu", "flash_verify_paged_launch",
                      [PTR] * 10 + [INT, INT] + _TAIL)
VERIFY_PAGED_Q8 = Kernel("flash_decode.cu", "flash_verify_paged_q8_launch",
                         [PTR] * 12 + [INT, INT] + _TAIL)
# logical cache positions per split, whatever the page size, the batch or
# the cache length (64 measured faster than 32 and 128: PERF.md)
SPLIT = 64
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _check_q(q, kh, hd, name, burst=False):
    """(B, H) of q, which must be (B, 1, H, hd) — or (B, T, H, hd) with T
    >= 1 for a verify ``burst`` — with H a multiple of KH."""
    b, t, h, qhd = q.shape
    if (t < 1 if burst else t != 1) or qhd != hd or h % kh:
        rows = "T" if burst else "1"
        raise ValueError(f"{name}: q {tuple(q.shape)} must be (B, {rows}, H, "
                         f"{hd}) with H a multiple of KH={kh}")
    return b, h


def _on_cuda(q, name):
    """False for a CPU or meta tensor (take the plain version); raises
    unless q is a CUDA tensor of a type the kernel takes."""
    if q.device.type in PLAIN_DEVICES:
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu, meta or cuda, not {q.device}")
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
    """Partials of every (slot, burst row, KV head, split)."""
    ns = -(-s_logical // SPLIT)
    rows = q.shape[0] * q.shape[1] * kh
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty(rows * ns * g * hd, **f32),
            torch.empty(rows * ns * g, **f32),
            torch.empty(rows * ns * g, **f32))


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


def _launch(kernel, q, caches, extra, lens, shape, window, burst=False):
    """Allocate scratch and output, launch ``kernel``.  ``caches`` are the
    cache tensors in the C argument order, ``extra`` the pointer arguments
    between them and ``lens`` (the page table), ``shape`` the ints between
    the output and ``bs`` (B, KH, S or NP, [ps], hd, G) with ``s_logical``
    last; a verify ``burst`` passes T = q.shape[1] after B."""
    *ints, s_logical = shape
    kh, hd, g = ints[1], ints[-2], ints[-1]
    if caches[0].numel() // hd >= 2 ** 31:
        raise ValueError(f"{kernel.symbol}: the kernel indexes rows with "
                         f"int32; {tuple(caches[0].shape)} has too many")
    po, pm, pl = _scratch(q, kh, s_logical, g, hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    t = q.shape[1]
    counters = _combine_counters(q.device, stream, ints[0] * t * kh)
    if burst:
        ints = [ints[0], t, *ints[1:]]
    out = torch.empty_like(q)
    route = f"G{g} hd{hd} S{s_logical}" + (f" window {window}" if window
                                           else "")
    kernel.launch(*_ptrs(q, *caches, *extra, lens, po, pm, pl, counters, out),
                  *ints, SPLIT, 0 if window is None else int(window),
                  hd ** -0.5, int(q.dtype == torch.bfloat16), stream,
                  route=route)
    return out


def _dense(kernel, plain, name, q, k_cache, v_cache, lens, window, burst):
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need equal (B, KH, S, hd) caches; got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, kh, s, hd = k_cache.shape
    _, h = _check_q(q, kh, hd, name, burst)
    if b != q.shape[0]:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not _on_cuda(q, name):
        return plain(q, k_cache, v_cache, lens, window=window)
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q and caches must share an f32/bf16 dtype; got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    return _launch(kernel, q.contiguous(),
                   (k_cache.contiguous(), v_cache.contiguous()), (),
                   _lens(lens, b, q.device), (b, kh, s, hd, h // kh, s),
                   window, burst)


def _dense_q8(kernel, plain, name, q, k_codes, k_scale, v_codes, v_scale,
              lens, window, burst):
    if k_codes.dim() != 4 or k_codes.shape != v_codes.shape:
        raise ValueError(f"need equal (B, KH, S, hd) codes; got "
                         f"{tuple(k_codes.shape)}, {tuple(v_codes.shape)}")
    b, kh, s, hd = k_codes.shape
    _, h = _check_q(q, kh, hd, name, burst)
    if b != q.shape[0]:
        raise ValueError(f"codes {tuple(k_codes.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not _on_cuda(q, name):
        return plain(q, k_codes, k_scale, v_codes, v_scale, lens,
                     window=window)
    _check_q8(k_codes, k_scale, v_codes, v_scale, name)
    caches = tuple(t.contiguous() for t in (k_codes, k_scale, v_codes,
                                            v_scale))
    return _launch(kernel, q.contiguous(), caches, (),
                   _lens(lens, b, q.device), (b, kh, s, hd, h // kh, s),
                   window, burst)


def _check_table(page_table, b, name):
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"{name}: page_table must be (B={b}, NP), got "
                         f"{tuple(page_table.shape)}")
    return page_table.shape[1]


def _paged(kernel, plain, name, q, k_store, v_store, page_table, lens,
           window, burst):
    if k_store.dim() != 4 or k_store.shape != v_store.shape:
        raise ValueError(f"need equal (P, KH, ps, hd) stores; got "
                         f"{tuple(k_store.shape)}, {tuple(v_store.shape)}")
    _, kh, ps, hd = k_store.shape
    b, h = _check_q(q, kh, hd, name, burst)
    n_pages = _check_table(page_table, b, name)
    if not _on_cuda(q, name):
        return plain(q, k_store, v_store, page_table, lens, window=window)
    if k_store.dtype != q.dtype or v_store.dtype != q.dtype:
        raise ValueError(f"q and stores must share an f32/bf16 dtype; got "
                         f"{q.dtype}, {k_store.dtype}, {v_store.dtype}")
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    return _launch(kernel, q.contiguous(),
                   (k_store.contiguous(), v_store.contiguous()), (table,),
                   _lens(lens, b, q.device),
                   (b, kh, n_pages, ps, hd, h // kh, n_pages * ps), window,
                   burst)


def _paged_q8(kernel, plain, name, q, k_codes, k_scale, v_codes, v_scale,
              page_table, lens, window, burst):
    if k_codes.dim() != 4 or k_codes.shape != v_codes.shape:
        raise ValueError(f"need equal (P, KH, ps, hd) code stores; got "
                         f"{tuple(k_codes.shape)}, {tuple(v_codes.shape)}")
    _, kh, ps, hd = k_codes.shape
    b, h = _check_q(q, kh, hd, name, burst)
    n_pages = _check_table(page_table, b, name)
    if not _on_cuda(q, name):
        return plain(q, k_codes, k_scale, v_codes, v_scale, page_table, lens,
                     window=window)
    _check_q8(k_codes, k_scale, v_codes, v_scale, name)
    caches = tuple(t.contiguous() for t in (k_codes, k_scale, v_codes,
                                            v_scale))
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    return _launch(kernel, q.contiguous(), caches, (table,),
                   _lens(lens, b, q.device),
                   (b, kh, n_pages, ps, hd, h // kh, n_pages * ps), window,
                   burst)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, KH, S, hd) native layout; cache_len:
    (B,) int32.  Returns (B, 1, H, hd) in q's dtype."""
    return _dense(KERNEL, decode_attention_ref, "flash_decode", q, k_cache,
                  v_cache, cache_len, window, False)


def flash_decode_q8(q: torch.Tensor, k_codes: torch.Tensor,
                    k_scale: torch.Tensor, v_codes: torch.Tensor,
                    v_scale: torch.Tensor, cache_len: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """int8-KV variant: codes (B, KH, S, hd) int8, scales (B, KH, S, 1)
    f32, folded inside the kernel (codes never dequantize in memory)."""
    return _dense_q8(KERNEL_Q8, decode_attention_q8_ref, "flash_decode_q8",
                     q, k_codes, k_scale, v_codes, v_scale, cache_len,
                     window, False)


def flash_decode_paged(q: torch.Tensor, k_store: torch.Tensor,
                       v_store: torch.Tensor, page_table: torch.Tensor,
                       cache_len: torch.Tensor, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """Paged variant: stores (P, KH, ps, hd); page_table (B, NP) int32
    physical ids (unmapped entries point at the trash page 0, never read
    past ``cache_len``)."""
    return _paged(KERNEL_PAGED, paged_decode_attention_ref,
                  "flash_decode_paged", q, k_store, v_store, page_table,
                  cache_len, window, False)


def flash_decode_paged_q8(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, page_table: torch.Tensor,
                          cache_len: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Paged int8-KV variant: code stores (P, KH, ps, hd) int8 and scale
    stores (P, KH, ps, 1) f32, read through the same page table."""
    return _paged_q8(KERNEL_PAGED_Q8, paged_decode_attention_q8_ref,
                     "flash_decode_paged_q8", q, k_codes, k_scale, v_codes,
                     v_scale, page_table, cache_len, window, False)


# ---------------------------------------------------------------------------
# Verify: T positions per slot in one launch (speculative decoding)
# ---------------------------------------------------------------------------

def flash_verify(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, base_len: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q: (B, T, H, hd); caches (B, KH, S, hd) with the burst's T entries
    written; base_len (B,) int32 entries before the burst.  Row t equals
    :func:`flash_decode` at ``cache_len = base_len + t + 1``.  Returns (B,
    T, H, hd) in q's dtype."""
    return _dense(VERIFY, verify_attention_ref, "flash_verify", q, k_cache,
                  v_cache, base_len, window, True)


def flash_verify_q8(q: torch.Tensor, k_codes: torch.Tensor,
                    k_scale: torch.Tensor, v_codes: torch.Tensor,
                    v_scale: torch.Tensor, base_len: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """int8-KV verify: codes (B, KH, S, hd) int8, scales (B, KH, S, 1)
    f32; row t equals :func:`flash_decode_q8` at ``base_len + t + 1``."""
    return _dense_q8(VERIFY_Q8, verify_attention_q8_ref, "flash_verify_q8",
                     q, k_codes, k_scale, v_codes, v_scale, base_len, window,
                     True)


def flash_verify_paged(q: torch.Tensor, k_store: torch.Tensor,
                       v_store: torch.Tensor, page_table: torch.Tensor,
                       base_len: torch.Tensor, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """Paged verify: stores (P, KH, ps, hd), page_table (B, NP); row t
    equals :func:`flash_decode_paged` at ``base_len + t + 1``."""
    return _paged(VERIFY_PAGED, paged_verify_attention_ref,
                  "flash_verify_paged", q, k_store, v_store, page_table,
                  base_len, window, True)


def flash_verify_paged_q8(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, page_table: torch.Tensor,
                          base_len: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Paged int8-KV verify; row t equals :func:`flash_decode_paged_q8` at
    ``base_len + t + 1``."""
    return _paged_q8(VERIFY_PAGED_Q8, paged_verify_attention_q8_ref,
                     "flash_verify_paged_q8", q, k_codes, k_scale, v_codes,
                     v_scale, page_table, base_len, window, True)
