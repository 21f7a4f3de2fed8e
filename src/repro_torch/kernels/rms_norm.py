"""Row RMS normalisation whose bits do not depend on the number of rows,
forward and backward.

Wrapper of ``csrc/rms_norm.cu``, a kernel of the port with no TPU
counterpart (the reference's ``rms_norm`` is plain jnp that XLA fuses):
one block per row, the squares summed in an order fixed by the row width
alone.  A CPU tensor takes the plain versions :func:`rms_norm_ref` /
:func:`rms_norm_bwd_ref`; a CUDA tensor launches the kernels or raises.
When grad is enabled and x or w requires it, :func:`rms_norm` runs as a
``torch.autograd.Function`` whose backward is the same source's
``rms_norm_bwd_launch`` (x and dy read once into registers, dw summed
from per-block partials in a fixed order, no atomics; rows up to
``MAX_BWD_WIDTH`` wide, wider ones raise).
"""
from __future__ import annotations

import torch

from ._build import FLOAT, INT, PTR, Kernel
from .ref import rms_norm_bwd_ref, rms_norm_ref

__all__ = ["KERNEL", "KERNEL_BWD", "rms_norm", "rms_norm_bwd",
           "rms_norm_ref", "rms_norm_bwd_ref"]

KERNEL = Kernel("rms_norm.cu", "rms_norm_launch",
                [PTR, PTR, PTR, INT, INT, FLOAT, INT, PTR])
KERNEL_BWD = Kernel("rms_norm.cu", "rms_norm_bwd_launch",
                    [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, FLOAT, INT, PTR])
# the backward keeps each thread's 8 chunks of 8 elements of x, dy and dw in
# registers (llama3-405b's 16384 is the widest config in the registry)
MAX_BWD_WIDTH = 16384


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * w`` over the last axis of ``x``
    (any leading shape), in f32, rounded to x's dtype.  ``w`` is (d,).
    Differentiable in x and w."""
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rms_norm: weight {tuple(w.shape)} does not match "
                         f"rows of width {d}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RmsNorm.apply(x, w, eps)
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    x2, rows = _check_cuda(x, w)
    out = torch.empty_like(x2)
    if rows == 0:
        return out
    KERNEL.launch(x2.data_ptr(), w.contiguous().data_ptr(), out.data_ptr(),
                  rows, d, eps, x.dtype == torch.bfloat16,
                  torch.cuda.current_stream(x.device).cuda_stream,
                  route=_route(x))
    return out


def _check_cuda(x, w, *more):
    """x contiguous and its number of rows, after the card's checks."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cpu or cuda, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != x.dtype for t in (w, *more)):
        raise ValueError(f"rms_norm: x, w (and dy) must share an f32/bf16 "
                         f"dtype; got {[t.dtype for t in (x, w, *more)]}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows >= 2 ** 31:
        raise ValueError(f"rms_norm: {rows} rows exceed the grid")
    return x.contiguous(), rows


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6):
    """(dx, dw) of :func:`rms_norm` for the upstream gradient ``dy`` (x's
    shape); dx like x, dw like w."""
    if dy.shape != x.shape or w.shape != (x.shape[-1],):
        raise ValueError(f"rms_norm backward: need dy like x and w (d,); got "
                         f"x {tuple(x.shape)}, dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, w, dy, eps)
    x2, rows = _check_cuda(x, w, dy)
    d = x.shape[-1]
    if d > MAX_BWD_WIDTH:
        raise ValueError(f"rms_norm backward: rows of {d} exceed "
                         f"{MAX_BWD_WIDTH}")
    dy2 = dy.contiguous()
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    if rows == 0:
        return dx, dw.zero_()
    # one (d,) f32 partial of dw per block of the backward
    blocks = KERNEL_BWD.lib().rms_norm_bwd_blocks
    blocks.argtypes, blocks.restype = [INT], INT
    n_part = blocks(rows)
    part = torch.empty((n_part, d), dtype=torch.float32, device=x.device)
    KERNEL_BWD.launch(x2.data_ptr(), w.contiguous().data_ptr(),
                      dy2.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                      part.data_ptr(), rows, d, eps,
                      x.dtype == torch.bfloat16,
                      torch.cuda.current_stream(x.device).cuda_stream,
                      route=_route(x))
    return dx, dw


def _route(x: torch.Tensor) -> str:
    """The route a launch names (:attr:`Kernel.routes`): the row width and
    the dtype."""
    return f"d{x.shape[-1]} {str(x.dtype)[6:]}"


class _RmsNorm(torch.autograd.Function):
    """rms_norm with its backward: the kernels on a CUDA tensor, the plain
    versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, x, w, eps):
        out = rms_norm(x, w, eps)        # grad is off inside forward
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None
