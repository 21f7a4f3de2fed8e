"""Shared model primitives: norms, RoPE, chunked attention, SwiGLU, linears.

All weights are stored ``(n_in, n_out)`` (``y = x @ W``) so the quantizer's
input-channel-group convention applies directly.  Every quantizable matmul
goes through :func:`qlinear`, which dispatches on the leaf type: plain
tensors matmul directly; :class:`~repro_torch.core.quantizer.QuantizedTensor`
leaves route through the dequant-matmul kernel (serving path).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, flash_attention
from repro_torch.kernels.ops import quant_matmul
# the row kernel on a CUDA tensor (a row's bits do not depend on how many
# rows come with it), its plain version on a CPU tensor
from repro_torch.kernels.rms_norm import rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Linear dispatch (FP or quantized)
# ---------------------------------------------------------------------------

def qlinear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a tensor or a QuantizedTensor."""
    if isinstance(w, QuantizedTensor):
        return quant_matmul(x, w)
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard; M-RoPE arrives with the VLM family)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding.  ``x``: (B, T, H, hd); ``positions``: (B, T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    ang = positions.float()[..., None] * freqs              # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: chunked (flash-style) for train/prefill; decode attention is
# the flash-decode kernel (kernels/ops.py::decode_attention).
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      window: Optional[int] = None,
                      q_offset: int = 0,
                      chunk: int = 512,
                      kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Memory-O(T·chunk) attention with an online softmax over KV chunks.

    q: (B, Tq, H, hd); k, v: (B, Tk, KH, hd) with H % KH == 0 (GQA).
    ``q_offset`` is the absolute position of q[0].  ``window`` enables
    sliding-window masking.  ``kv_lens`` (B,) int32 masks keys at positions
    >= kv_lens[b] — the length-aware causal mask for bucket-padded batched
    prefill.

    On a CUDA tensor, causal self-attention from position 0 with T a
    multiple of 128, hd <= 128 and no window or ``kv_lens`` runs the
    flash-attention kernel in the grouped GQA layout (the reference's TPU
    dispatch condition, with "q is on CUDA" for "the backend is TPU").
    Everything else runs the chunked path below in plain PyTorch.
    """
    b, tq, h, hd = q.shape
    tk, kh = k.shape[1], k.shape[2]
    if (kv_lens is None and window is not None and causal and tq == tk
            and q_offset == 0 and tk > 2 * window):
        raise NotImplementedError(
            "block-local sliding-window attention arrives with the hybrid "
            "family")
    if (q.is_cuda and window is None and q_offset == 0 and tq == tk
            and hd <= MAX_HEAD_DIM and tq % 128 == 0 and kv_lens is None):
        g = h // kh
        qr = q.reshape(b, tq, kh, g, hd).permute(0, 2, 3, 1, 4) \
              .reshape(b * kh, g, tq, hd)
        kr = k.permute(0, 2, 1, 3).reshape(b * kh, tk, hd)
        vr = v.permute(0, 2, 1, 3).reshape(b * kh, tk, hd)
        o = flash_attention(qr, kr, vr, causal=causal)
        return o.reshape(b, kh, g, tq, hd).permute(0, 3, 1, 2, 4) \
                .reshape(b, tq, h, hd)
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    chunk = min(chunk, tk)
    n_chunks = tk // chunk
    scale = hd ** -0.5
    q32 = q.float() * scale
    qpos = q_offset + torch.arange(tq, device=q.device)

    def attend_block(carry, kb, vb, kpos):
        m, l, acc = carry
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float())
        mask = torch.ones((tq, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        if kv_lens is not None:
            mask = (mask[None] & (kpos[None, None, :]
                                  < kv_lens[:, None, None]))[:, None]
        else:
            mask = mask[None, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vb.float())
        return m_new, l_new, acc_new

    carry = (torch.full((b, h, tq), -torch.inf, device=q.device),
             torch.zeros((b, h, tq), device=q.device),
             torch.zeros((b, h, tq, hd), device=q.device))
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        carry = attend_block(carry, k[:, sl], v[:, sl],
                             torch.arange(sl.start, sl.stop, device=q.device))
    if tk > n_chunks * chunk:
        sl = slice(n_chunks * chunk, tk)
        carry = attend_block(carry, k[:, sl], v[:, sl],
                             torch.arange(sl.start, sl.stop, device=q.device))
    m, l, acc = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)            # (B, Tq, H, hd)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return qlinear(F.silu(qlinear(x, w_gate)) * qlinear(x, w_up), w_down)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def padded_vocab(vocab_size: int, multiple: int = 256) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), embedding)


# rows per lm_head product: every call has this many rows (zero-padded)
LM_HEAD_ROWS = 64


def _fixed_rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` computed in products of exactly :data:`LM_HEAD_ROWS` rows,
    each read from a freshly allocated zero-padded buffer.  The library
    GEMM picks its kernel, and so its summation order, from the shape and
    the operands' alignment; fixing both makes a row's bits independent of
    how many rows come with it (a decode step of any batch, a verify pass
    of B * (K + 1) rows)."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    w = w.to(x.dtype)
    outs = []
    for i in range(0, x2.shape[0], LM_HEAD_ROWS):
        rows = x2[i:i + LM_HEAD_ROWS]
        buf = torch.zeros((LM_HEAD_ROWS, d), dtype=x.dtype, device=x.device)
        buf[:rows.shape[0]] = rows
        outs.append(torch.matmul(buf, w)[:rows.shape[0]])
    return torch.cat(outs).reshape(lead + (w.shape[-1],))


def logits_from_hidden(x: torch.Tensor, lm_head, vocab_size: int) -> torch.Tensor:
    """Final projection.  Logits keep the *padded* vocab width; padded
    columns get a -1e30 additive mask so softmax, cross-entropy, and argmax
    all behave as if the vocab were unpadded.  A float head is multiplied
    in fixed-size row blocks, so each row's logits are the same bits at any
    batch (:func:`_fixed_rows_matmul`)."""
    if isinstance(lm_head, QuantizedTensor):
        out = qlinear(x, lm_head)
    else:
        out = _fixed_rows_matmul(x, lm_head)
    v_pad = out.shape[-1]
    if v_pad != vocab_size:
        bias = torch.where(torch.arange(v_pad, device=out.device) < vocab_size,
                           0.0, NEG_INF)
        out = out.float() + bias
    return out


def last_valid_hidden(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Gather the hidden state of each row's last valid token.

    x: (B, T, d); lens: (B,) int32 with 1 <= lens[b] <= T.  Returns
    (B, 1, d) — row b's position ``lens[b] - 1``.
    """
    idx = torch.clamp(lens.long() - 1, 0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))


def update_cache_at(cache: torch.Tensor, new: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Write the span ``new`` (B, KH, T, hd) into ``cache`` (B, KH, S, hd)
    starting at per-slot positions ``pos`` (B,), in place (one indexed
    copy; the reference's functional update copies the cache).  T = 1 is
    the decode step, T > 1 a speculative verify burst; the caller keeps
    ``pos + T <= S`` (an index past S raises, where the reference's
    update clamps).  Returns ``cache``."""
    b, t = cache.shape[0], new.shape[2]
    pos = pos.long().reshape(-1).expand(b)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = pos[:, None] + torch.arange(t, device=cache.device)
    cache[rows, :, cols] = new.transpose(1, 2).to(cache.dtype)
    return cache


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of fresh K/V entries.

    x: (B, T, KH, hd) -> (codes int8 of x's shape, scale (B, T, KH, 1)
    f32); codes round half to even and clip to +-127.  The int8 KV cache
    (``cfg.kv_cache_bits = 8``) halves the cache's memory and traffic."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    codes = torch.clamp(torch.round(x32 / scale), -127, 127)
    return codes.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Paged KV cache (serve/pages.py holds the host-side allocator; this is the
# device-side write; the read side is the paged flash-decode kernel)
# ---------------------------------------------------------------------------

def update_pages_at(store: torch.Tensor, new: torch.Tensor,
                    page_ids: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Write each slot's fresh KV span into its physical pages, in place
    (one indexed copy).

    store: (P, KH, ps, d); new: (B, KH, T, d); page_ids/offsets: (B, T),
    resolved per position since a verify burst may cross a page boundary
    ((B,) for T = 1, the reference's form).  The engine makes every written
    page exclusively owned first (copy-on-write on the host), and inactive
    slots' tables point at the trash page 0, so only the trash page can
    take two writes, and nothing reads it.  Returns ``store``."""
    b, t = new.shape[0], new.shape[2]
    store[page_ids.long().reshape(b, t), :, offsets.long().reshape(b, t)] = \
        new.transpose(1, 2).to(store.dtype)
    return store
