"""Dispatch entry points the models call.

The kernel is chosen by the tensor's device alone: a CPU tensor takes the
plain PyTorch version (so does a meta tensor, shapes alone: the dry-run),
a CUDA tensor the hand-written kernel (see each wrapper), any other device
raises.  There is no environment switch and no fallback.

Under tensor parallelism the attention entry points take this rank's
heads as they are: q with H/m query heads and caches / page stores with
KH/m KV heads (the reference wraps the same bodies in a head-axis
``shard_map``), page tables and lengths whole.  The head counts come from
the shapes, so nothing in a kernel changes, and nothing crosses ranks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizer import QuantizedTensor, dequantize_groupwise
from .flash_decode import (flash_decode, flash_decode_paged,
                           flash_decode_paged_q8, flash_decode_q8,
                           flash_verify, flash_verify_paged,
                           flash_verify_paged_q8, flash_verify_q8)
from .quant_error import quant_error
from .quant_matmul import quant_matmul as _quant_matmul_kernel
from .quant_matmul import quant_matmul_experts as _quant_matmul_experts_kernel


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``(x / act_scale) @ dequant(qt)`` for arbitrary leading x dims, in
    ``out_dtype`` (default x's dtype; float32: the product's f32 sums
    before their rounding, the weight as x's dtype takes it)."""
    if qt.act_scale is not None:
        x = x / qt.act_scale.to(x.dtype)
    if not qt.packed or qt.spec.bits > 4:
        w = dequantize_groupwise(qt, dtype=x.dtype)
        if out_dtype in (None, x.dtype):
            return x @ w
        return x.to(out_dtype) @ w.to(out_dtype)
    lead = x.shape[:-1]
    out = _quant_matmul_kernel(x.reshape(-1, x.shape[-1]), qt.codes,
                               qt.scale, qt.zero, out_dtype)
    return out.reshape(lead + (qt.codes.shape[-1],))


def quant_matmul_experts(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Per-expert dequant matmul: x (E, C, d) against qt with codes (E,
    d[/2], f), ``(x[e] / act_scale[e]) @ dequant(qt[e])``; returns (E, C,
    f).  The division is in x's dtype.  Packed int4 on the card is one
    launch of the quant_matmul kernel for all E (the reference unrolls E
    kernel calls); a CPU tensor takes the plain version per expert."""
    if qt.act_scale is not None:
        x = x / qt.act_scale[:, None, :].to(x.dtype)
    if not qt.packed or qt.spec.bits > 4:
        return torch.stack([x[e] @ dequantize_groupwise(qt[e], dtype=x.dtype)
                            for e in range(x.shape[0])])
    return _quant_matmul_experts_kernel(x, qt.codes, qt.scale, qt.zero)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-position attention: q (B, 1, H, hd) against dense caches in
    their native (B, KH, S, hd) layout, cache_len (B,) int32."""
    return flash_decode(q, k_cache, v_cache, cache_len, window=window)


def decode_attention_q8(q, k_codes, k_scale, v_codes, v_scale, cache_len, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """int8-KV decode attention: codes (B, KH, S, hd) int8 and scales
    (B, KH, S, 1) f32, the scales folded inside the consumer."""
    return flash_decode_q8(q, k_codes, k_scale, v_codes, v_scale, cache_len,
                           window=window)


def paged_decode_attention(q, k_store, v_store, page_table, cache_len, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Decode attention against the shared page stores (P, KH, ps, hd)
    through ``page_table`` (B, NP) int32."""
    return flash_decode_paged(q, k_store, v_store, page_table, cache_len,
                              window=window)


def paged_decode_attention_q8(q, k_codes, k_scale, v_codes, v_scale,
                              page_table, cache_len, *,
                              window: Optional[int] = None) -> torch.Tensor:
    """Paged int8-KV decode attention (scale stores paged beside the
    codes)."""
    return flash_decode_paged_q8(q, k_codes, k_scale, v_codes, v_scale,
                                 page_table, cache_len, window=window)


def verify_attention(q, k_cache, v_cache, base_len, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Multi-position decode attention (speculative verify): q (B, T, H,
    hd) against dense caches in native (B, KH, S, hd) layout, base_len (B,)
    valid entries *before* the burst (its T fresh entries already written).
    Row t is :func:`decode_attention` at ``base_len + t + 1``; one launch
    for the whole burst."""
    return flash_verify(q, k_cache, v_cache, base_len, window=window)


def verify_attention_q8(q, k_codes, k_scale, v_codes, v_scale, base_len, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """int8-KV variant of :func:`verify_attention`."""
    return flash_verify_q8(q, k_codes, k_scale, v_codes, v_scale, base_len,
                           window=window)


def paged_verify_attention(q, k_store, v_store, page_table, base_len, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """:func:`verify_attention` against the shared page stores."""
    return flash_verify_paged(q, k_store, v_store, page_table, base_len,
                              window=window)


def paged_verify_attention_q8(q, k_codes, k_scale, v_codes, v_scale,
                              page_table, base_len, *,
                              window: Optional[int] = None) -> torch.Tensor:
    """Paged int8-KV variant of :func:`verify_attention`."""
    return flash_verify_paged_q8(q, k_codes, k_scale, v_codes, v_scale,
                                 page_table, base_len, window=window)


def quant_error_batch(w: torch.Tensor, scales: torch.Tensor,
                      mean_sq: torch.Tensor, spec) -> torch.Tensor:
    """Fused multi-candidate quant error (the alpha search's diagonal loss
    for every candidate scale in ``scales`` (A, k)); returns (A,) f32."""
    return quant_error(w, scales, mean_sq, spec)
