"""Plain PyTorch versions of the CUDA kernels.

Each is what the matching kernel computes, written with ordinary tensor
ops.  A CPU tensor takes these in the kernel wrappers; on the card they
are the yardstick each kernel is held against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizer import quant_dequant

NEG_INF = -1e30


def dequant_ref(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                n_in: int) -> torch.Tensor:
    """Unpack + dequantize packed 4-bit codes to f32 ``(n_in, n_out)``.

    codes: (n_in//2, n_out) uint8, byte i = code[2i] | code[2i+1] << 4;
    scale/zero: (n_in//g, n_out) f32."""
    lo = (codes & 0x0F).float()
    hi = ((codes >> 4) & 0x0F).float()
    w = torch.stack([lo, hi], dim=1).reshape(n_in, codes.shape[-1])
    g = n_in // scale.shape[0]
    s_full = scale.repeat_interleave(g, dim=0)
    z_full = zero.repeat_interleave(g, dim=0)
    return (w - z_full) * s_full


def quant_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(codes)`` in f32, cast to x's dtype.

    x: (m, k) already divided by any act_scale; returns (m, n)."""
    w = dequant_ref(codes, scale, zero, x.shape[-1])
    return (x.float() @ w).to(x.dtype)


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, in f32, cast
    to x's dtype."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * w.float()).to(x.dtype)


def _attend_core(q, k, v, lens, window, k_fold=None, v_fold=None):
    """Masked attention of T positions per slot, shared by every decode and
    verify plain version.  q: (B, T, H, hd); k/v: (B, KH, S, hd) in any type
    (upcast to f32); lens (B, T): position t of slot b sees the first
    ``lens[b, t]`` cache entries.  ``k_fold``/``v_fold`` (B, KH, S) multiply
    the scores / the probabilities after the softmax sum (the int8 scale
    folds)."""
    b, t, h, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.float().reshape(b, t, kh, g, hd)
    scores = torch.einsum("btkgd,bksd->btkgs", qg, k.float()) * hd ** -0.5
    if k_fold is not None:
        scores = scores * k_fold[:, None, :, None, :]
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, None, :] < lens[..., None]               # (B, T, S)
    if window is not None:
        mask &= kpos[None, None, :] >= (lens[..., None] - window)
    mask5 = mask[:, :, None, None, :]
    scores = torch.where(mask5, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask5, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_fold is not None:
        p = torch.where(mask5, p * v_fold[:, None, :, None, :], 0.0)
    # masked rows are never read by the kernels; zero them here so stale or
    # NaN contents (an unmapped page) cannot leak through 0 * NaN
    live = mask.any(dim=1)                                     # (B, S)
    vf = torch.where(live[:, None, :, None], v.float(), 0.0)
    out = torch.einsum("btkgs,bksd->btkgd", p, vf)
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(b, t, h, hd).to(q.dtype)


def _decode_lens(cache_len, b, device):
    """(B, 1): the single position sees ``cache_len`` entries."""
    return cache_len.to(device=device, dtype=torch.int64).reshape(-1) \
        .expand(b)[:, None]


def _verify_lens(base_len, b, t, device):
    """(B, T): position t of a burst sees ``base_len + t + 1`` entries."""
    base = base_len.to(device=device, dtype=torch.int64).reshape(-1).expand(b)
    return base[:, None] + 1 + torch.arange(t, device=device)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """Single-position attention against a (possibly longer) cache.

    q: (B, 1, H, hd); caches in their native (B, KH, S, hd) layout;
    cache_len: (B,) int32 valid entries per slot (the current token's k/v
    included).  GQA in grouped form: head ``kh * G + g`` reads KV head
    ``kh``.  Masked positions get probability exactly zero, so a slot with
    ``cache_len == 0`` yields 0 — as the split-KV kernel does.
    """
    return _attend_core(q, k_cache, v_cache,
                        _decode_lens(cache_len, q.shape[0], q.device), window)


def decode_attention_q8_ref(q: torch.Tensor, k_codes: torch.Tensor,
                            k_scale: torch.Tensor, v_codes: torch.Tensor,
                            v_scale: torch.Tensor, cache_len: torch.Tensor,
                            window: Optional[int] = None) -> torch.Tensor:
    """:func:`decode_attention_ref` against an int8 cache: codes (B, KH, S,
    hd) int8, scales (B, KH, S, 1) f32.  The K scale multiplies the scores,
    the V scale the probabilities (after their sum), so the codes are
    consumed as they are."""
    return _attend_core(q, k_codes, v_codes,
                        _decode_lens(cache_len, q.shape[0], q.device), window,
                        k_fold=k_scale[..., 0], v_fold=v_scale[..., 0])


def gather_pages(store: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Each slot's logical cache from the shared page store.

    store: (P, KH, ps, d); page_table: (B, NP) physical ids per logical
    block.  Returns (B, KH, NP * ps, d), the dense native layout.  Unmapped
    entries point at the trash page 0, whose contents sit at positions
    >= the slot's cache length, which attention masks.
    """
    g = store[page_table.to(device=store.device, dtype=torch.long)]
    b, n_pages, kh, ps, d = g.shape                 # (B, NP, KH, ps, d)
    return g.permute(0, 2, 1, 3, 4).reshape(b, kh, n_pages * ps, d)


def paged_decode_attention_ref(q, k_store, v_store, page_table, cache_len,
                               window=None):
    """:func:`decode_attention_ref` against paged stores (P, KH, ps, hd):
    gather the pages through the table, then the masked attention."""
    return decode_attention_ref(q, gather_pages(k_store, page_table),
                                gather_pages(v_store, page_table), cache_len,
                                window=window)


def paged_decode_attention_q8_ref(q, k_codes, k_scale, v_codes, v_scale,
                                  page_table, cache_len, window=None):
    """:func:`decode_attention_q8_ref` against paged int8 stores: the scale
    stores (P, KH, ps, 1) are paged beside the codes."""
    return decode_attention_q8_ref(
        q, gather_pages(k_codes, page_table), gather_pages(k_scale, page_table),
        gather_pages(v_codes, page_table), gather_pages(v_scale, page_table),
        cache_len, window=window)


def verify_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, base_len: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """Multi-position decode attention (speculative verify) in one masked
    pass.

    q: (B, T, H, hd); caches in their native (B, KH, S, hd) layout with the
    burst's T fresh entries already written; base_len (B,) valid entries
    *before* the burst.  Position ``t`` sees the first ``base_len + t + 1``
    entries (shifted-causal over the burst, its own entry included), so row
    ``t`` is :func:`decode_attention_ref` at ``cache_len = base_len + t +
    1``."""
    b, t = q.shape[:2]
    return _attend_core(q, k_cache, v_cache,
                        _verify_lens(base_len, b, t, q.device), window)


def verify_attention_q8_ref(q, k_codes, k_scale, v_codes, v_scale, base_len,
                            window=None):
    """:func:`verify_attention_ref` against an int8 cache (the scale folds
    of :func:`decode_attention_q8_ref` over T positions)."""
    b, t = q.shape[:2]
    return _attend_core(q, k_codes, v_codes,
                        _verify_lens(base_len, b, t, q.device), window,
                        k_fold=k_scale[..., 0], v_fold=v_scale[..., 0])


def paged_verify_attention_ref(q, k_store, v_store, page_table, base_len,
                               window=None):
    """:func:`verify_attention_ref` against paged stores (gather + mask)."""
    return verify_attention_ref(q, gather_pages(k_store, page_table),
                                gather_pages(v_store, page_table), base_len,
                                window=window)


def paged_verify_attention_q8_ref(q, k_codes, k_scale, v_codes, v_scale,
                                  page_table, base_len, window=None):
    """:func:`verify_attention_q8_ref` against paged int8 stores (scale
    stores paged beside the codes)."""
    return verify_attention_q8_ref(
        q, gather_pages(k_codes, page_table), gather_pages(k_scale, page_table),
        gather_pages(v_codes, page_table), gather_pages(v_scale, page_table),
        base_len, window=window)


def quant_error_ref(w: torch.Tensor, scales: torch.Tensor,
                    mean_sq: torch.Tensor, spec) -> torch.Tensor:
    """Weighted quantization error of ``w`` (k, n) for each candidate
    smoothing scale ``scales[a]`` (A, k): ``err[a] = sum(mean_sq[:, None] *
    (deq(Q(w * s_a)) / s_a - w) ** 2) / n``, in f32 — the diagonal loss of
    the alpha search, one candidate at a time.  Returns (A,) f32."""
    w32 = w.float()
    msq = mean_sq.float()[:, None]
    out = []
    for a in range(scales.shape[0]):
        dw = quant_dequant(w32, spec, act_scale=scales[a].float()) - w32
        out.append(torch.sum(msq * dw * dw) / w.shape[1])
    return torch.stack(out)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Full masked softmax attention, GQA-grouped.

    q: (BKH, G, T, hd) — or (BH, T, hd) for G = 1 — against unrepeated
    k/v (BKH, T, hd).  Returns q's shape and dtype."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    t, hd = q.shape[2], q.shape[3]
    s = torch.einsum("bgtd,bsd->bgts", q.float(), k.float()) * hd ** -0.5
    if causal:
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgts,bsd->bgtd", p, v.float()).to(q.dtype)
    return out[:, 0] if squeeze else out
