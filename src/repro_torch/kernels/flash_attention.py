"""Causal flash attention, GQA-grouped, forward and backward.

Wrapper of ``csrc/flash_attention.cu``, the port of
``repro/kernels/flash_attention.py::flash_attention_pallas``, and of
``csrc/flash_attention_bwd.cu``, its backward (the reference has none: it
trains through its jnp attention).  A CPU tensor takes the plain versions
:func:`flash_attention_ref` / :func:`flash_attention_bwd_ref`; a CUDA
tensor launches the kernels or raises, routed by dtype alone: bf16 the
tensor-core (wgmma + TMA) forward and backward, f32 the CUDA-core ones.
The bf16 kernels load rows by TMA, so the wrapper zero-pads rows it cannot
describe (:func:`_tma_operands`) and slices the results back.

When grad is enabled and an input requires it, :func:`flash_attention`
runs as a ``torch.autograd.Function``: the forward kernel also writes each
row's log-sum-exp, and the backward kernel rebuilds the probabilities from
it.  Without grad the forward launch is the same as ever.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import FLOAT, INT, PTR, Kernel
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["KERNEL", "KERNEL_BWD", "flash_attention", "flash_attention_bwd",
           "flash_attention_ref", "flash_attention_bwd_ref"]

KERNEL = Kernel("flash_attention.cu", "flash_attention_launch",
                [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, INT,
                 PTR, INT, PTR, PTR])
KERNEL_BWD = Kernel("flash_attention_bwd.cu", "flash_attention_bwd_launch",
                    [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT,
                     INT, INT, INT, INT, FLOAT, INT, PTR])
MAX_HEAD_DIM = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (BKH, G, T, hd) grouped GQA — or (BH, T, hd) for G = 1 —
    against unrepeated k/v (BKH, T, hd), hd <= 128.  Returns q's shape.

    ``kv_lens`` (B,) int, B dividing BKH (row b covers BKH / B consecutive
    entries, its KV heads), masks keys at positions >= kv_lens[b], each
    >= 1: bucket-padded prefill.  Rows past kv_lens[b] are padding and
    still attend the valid keys.  On the card a valid row's bits do not
    depend on T or on the other rows.

    Differentiable in q, k and v (without ``kv_lens``, which training
    never passes): under grad it runs as :class:`_FlashAttention`."""
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
    if kv_lens is not None and (kv_lens.dim() != 1 or kv_lens.numel() == 0
                                or bkh % kv_lens.numel()
                                or kv_lens.device != q.device):
        raise ValueError(f"kv_lens must be (B,) on {q.device} with B "
                         f"dividing {bkh}; got {tuple(kv_lens.shape)} on "
                         f"{kv_lens.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if kv_lens is not None:
            raise ValueError("flash_attention: no backward with kv_lens "
                             "(training never masks keys by length)")
        out = _FlashAttention.apply(q4, k, v, causal)
        return out[:, 0] if q.dim() == 3 else out
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, kv_lens=kv_lens)
    out = _forward(q4, k, v, causal, kv_lens, with_lse=False)[0]
    return out[:, 0] if q.dim() == 3 else out


def _check_cuda(*xs: torch.Tensor) -> None:
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"flash_attention: tensors must share an f32/bf16 "
                         f"dtype; got {[x.dtype for x in xs]}")


def _forward(q4, k, v, causal, kv_lens, with_lse):
    """The forward launch on (BKH, G, T, hd) q; returns (out, lse or
    None), lse (BKH, G, T) f32."""
    _check_cuda(q4, k, v)
    bkh, g, t, hd = q4.shape
    bf16 = q4.dtype == torch.bfloat16
    width, (q4, k, v) = _tma_operands(bf16, q4, k, v)
    lens_ptr, per_len = None, 1
    if kv_lens is not None:
        kv_lens = kv_lens.to(torch.int32).contiguous()
        lens_ptr, per_len = kv_lens.data_ptr(), bkh // kv_lens.numel()
    out = torch.empty_like(q4)
    lse = (torch.empty((bkh, g, t), dtype=torch.float32, device=q4.device)
           if with_lse else None)
    if t > 0:
        KERNEL.launch(q4.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bkh, g, t, width, int(causal),
                      hd ** -0.5, int(bf16), lens_ptr, per_len,
                      None if lse is None else lse.data_ptr(),
                      torch.cuda.current_stream(q4.device).cuda_stream,
                      route=f"G{g} hd{hd} {'' if causal else 'not '}causal")
    if width != hd:
        out = out[..., :hd].contiguous()
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True):
    """dq, dk, dv of :func:`flash_attention` for q, out, dout (BKH, G, T,
    hd) and k, v (BKH, T, hd), given the forward's ``out`` and per-row
    ``lse`` (BKH, G, T) f32.  A CPU tensor takes the plain version
    :func:`flash_attention_bwd_ref` (which recomputes out and lse); a CUDA
    tensor launches ``csrc/flash_attention_bwd.cu`` or raises."""
    bkh, g, t, hd = q.shape
    if k.shape != (bkh, t, hd) or v.shape != k.shape or \
            dout.shape != q.shape or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: need q, dout (BKH, G, T, hd "
                         f"<= {MAX_HEAD_DIM}) and k, v (BKH, T, hd); got "
                         f"{tuple(q.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal)
    _check_cuda(q, k, v, out, dout)
    if out.shape != q.shape or lse.shape != (bkh, g, t) or \
            lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: need out like q and f32 lse "
                         f"(BKH, G, T); got {tuple(out.shape)}, "
                         f"{tuple(lse.shape)} {lse.dtype}")
    bf16 = q.dtype == torch.bfloat16
    width, (q, k, v, out, dout) = _tma_operands(bf16, q, k, v, out, dout)
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if t > 0:
        # f32 scratch: D (and, bf16, lse * log2(e)) per row, by tile
        size = KERNEL_BWD.lib().flash_attention_bwd_scratch
        size.argtypes, size.restype = [INT, INT, INT, INT], ctypes.c_longlong
        scratch = torch.empty(size(bkh, g, t, int(bf16)), dtype=torch.float32,
                              device=q.device)
        KERNEL_BWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                          scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), bkh, g, t, width, int(causal),
                          hd ** -0.5, int(bf16),
                          torch.cuda.current_stream(q.device).cuda_stream,
                          route=f"G{g} hd{hd} "
                                f"{'' if causal else 'not '}causal")
    if width != hd:
        dq, dk, dv = (x[..., :hd].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """flash_attention on (BKH, G, T, hd) q with its backward: the kernels
    on a CUDA tensor, the plain versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, q4, k, v, causal):
        if q4.device.type == "cpu":
            out, lse = flash_attention_ref(q4, k, v, causal=causal), None
        else:
            out, lse = _forward(q4, k, v, causal, None, with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q4, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q4, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q4, k, v, out, lse, dout,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def _tma_operands(bf16: bool, *xs: torch.Tensor):
    """(width, tensors) as the kernels take them: contiguous, and for bf16,
    whose kernels load rows by TMA (16-byte aligned, hd % 8 == 0), rows it
    cannot describe zero-padded to ``width``, hd rounded up to 8 (zeros add
    nothing to any score, output or gradient).  width is hd otherwise."""
    xs = tuple(x.contiguous() for x in xs)
    hd = xs[0].shape[-1]
    if not bf16 or (hd % 8 == 0 and all(x.data_ptr() % 16 == 0 for x in xs)):
        return hd, xs
    width = -(-hd // 8) * 8
    padded = []
    for x in xs:
        out = x.new_zeros(x.shape[:-1] + (width,))
        out[..., :hd] = x
        padded.append(out)
    return width, tuple(padded)
