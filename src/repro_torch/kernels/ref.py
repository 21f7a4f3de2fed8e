"""Plain PyTorch versions of the CUDA kernels.

Each is what the matching kernel computes, written with ordinary tensor
ops.  A CPU tensor takes these in the kernel wrappers; on the card they
are the yardstick each kernel is held against.
"""
from __future__ import annotations

from typing import Optional

import torch

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
    b, _, h, hd = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.float().reshape(b, kh, g, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * hd ** -0.5
    lens = cache_len.to(torch.int64).reshape(-1).expand(b)
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, :] < lens[:, None]                     # (B, S)
    if window is not None:
        mask &= kpos[None, :] >= (lens[:, None] - window)
    mask = mask[:, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(b, 1, h, hd).to(q.dtype)


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
