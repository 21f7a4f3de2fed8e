"""Group-wise low-bit weight quantization primitives.

Conventions
-----------
Weights are stored ``(n_in, n_out)`` so that a linear layer computes
``y = x @ W``.  Quantization groups run along the *input-channel* axis
(axis 0), matching AWQ's deployment format: each group of ``group_size``
input channels in each output column shares one (scale, zero) pair.

The paper ("Enhancing Post-Training Quantization via Future Activation
Awareness") adopts **asymmetric** quantization; symmetric is kept as an
option for ablations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "QuantSpec",
    "QuantizedTensor",
    "effective_group_size",
    "quantize_groupwise",
    "dequantize_groupwise",
    "quant_dequant",
    "pack_codes",
    "unpack_codes",
]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a weight-quantization format."""

    bits: int = 4
    group_size: int = 128
    symmetric: bool = False  # paper uses asymmetric quantization

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.symmetric else 2 ** self.bits - 1


@dataclasses.dataclass
class QuantizedTensor:
    """A group-wise quantized 2-D weight (or a layer-stacked ``(L, ...)``
    stack of them).

    ``codes``   uint8, either unpacked ``(n_in, n_out)`` or packed
                ``(n_in // 2, n_out)`` (two 4-bit codes per byte) when
                ``packed`` is True.
    ``scale``   f32 ``(n_groups, n_out)``.
    ``zero``    f32 ``(n_groups, n_out)`` (zero-point, already in code units).
    ``act_scale`` optional f32 ``(n_in,)`` AWQ/FAQ per-channel smoothing
                scale *s*: the stored codes quantize ``W * s[:, None]`` and
                the runtime computes ``(x / s) @ deq(codes)``.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    spec: QuantSpec
    n_in: int
    packed: bool
    act_scale: Optional[torch.Tensor] = None

    def __getitem__(self, i) -> "QuantizedTensor":
        """Layer ``i`` of a layer-stacked tensor (views, no copies)."""
        return QuantizedTensor(
            codes=self.codes[i], scale=self.scale[i], zero=self.zero[i],
            spec=self.spec, n_in=self.n_in, packed=self.packed,
            act_scale=None if self.act_scale is None else self.act_scale[i])


def effective_group_size(n_in: int, group_size: int) -> int:
    """Largest divisor of ``n_in`` that is <= the requested group size.

    Keeps group-wise quantization well-defined for channel counts that are
    not multiples of 128 (e.g. hymba's d_model=1600 -> groups of 100).
    """
    if group_size <= 0 or group_size >= n_in:
        return n_in
    if n_in % group_size == 0:
        return group_size
    for g in range(group_size, 0, -1):
        if n_in % g == 0:
            return g
    return 1


def _affine_params(w: torch.Tensor, spec: QuantSpec, g: int,
                   eps: float = 1e-8):
    """Per-(group, col) scale/zero for the given spec, shapes (n_groups, n_out)."""
    n_in, n_out = w.shape
    wg = w.reshape(n_in // g, g, n_out)
    lo, hi = wg.amin(dim=1), wg.amax(dim=1)
    if spec.symmetric:
        amax = torch.maximum(lo.abs(), hi.abs())
        scale = torch.clamp(amax / spec.qmax, min=eps)
        zero = torch.zeros_like(scale)
    else:
        # Asymmetric: range [lo, hi] -> [0, 2^b - 1]; include 0 in range so
        # exact zeros stay exact (standard practice).
        lo = torch.clamp(lo, max=0.0)
        hi = torch.clamp(hi, min=0.0)
        scale = torch.clamp((hi - lo) / (spec.levels - 1), min=eps)
        zero = torch.round(-lo / scale)
    return scale, zero


def quantize_groupwise(
    w: torch.Tensor,
    spec: QuantSpec,
    act_scale: Optional[torch.Tensor] = None,
    pack: bool = False,
) -> QuantizedTensor:
    """Quantize ``w`` (optionally pre-scaled by ``act_scale``) group-wise."""
    w = w.float()
    if act_scale is not None:
        w = w * act_scale[:, None].float()
    n_in, n_out = w.shape
    g = effective_group_size(n_in, spec.group_size)
    scale, zero = _affine_params(w, spec, g)
    s_full = scale.repeat_interleave(g, dim=0)
    z_full = zero.repeat_interleave(g, dim=0)
    codes = torch.clamp(torch.round(w / s_full) + z_full, spec.qmin, spec.qmax)
    if spec.symmetric:
        # store with bias so uint8 can hold it
        codes = codes - spec.qmin
        zero = zero - spec.qmin
    codes = codes.to(torch.uint8)
    if pack:
        codes = pack_codes(codes, spec.bits)
    return QuantizedTensor(codes=codes, scale=scale, zero=zero, spec=spec,
                           n_in=n_in, packed=pack, act_scale=act_scale)


def dequantize_groupwise(qt: QuantizedTensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_groupwise` (up to rounding).

    Returns the *smoothed-domain* weight ``deq(codes)``; callers holding an
    ``act_scale`` must divide rows by it (or divide activations) to recover
    the original-domain weight.
    """
    codes = qt.codes
    if qt.packed:
        codes = unpack_codes(codes, qt.spec.bits, qt.n_in)
    g = qt.n_in // qt.scale.shape[0]
    s_full = qt.scale.repeat_interleave(g, dim=0)
    z_full = qt.zero.repeat_interleave(g, dim=0)
    return ((codes.float() - z_full) * s_full).to(dtype)


def quant_dequant(w: torch.Tensor, spec: QuantSpec,
                  act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fake-quantization: returns the original-domain reconstruction.

    ``deq(Q(W * s)) / s`` — the weight actually realized at inference time.
    """
    orig_dtype = w.dtype
    qt = quantize_groupwise(w, spec, act_scale=act_scale, pack=False)
    w_hat = dequantize_groupwise(qt)
    if act_scale is not None:
        w_hat = w_hat / act_scale[:, None].float()
    return w_hat.to(orig_dtype)


# ---------------------------------------------------------------------------
# Packing.  4-bit codes pack two-per-byte along the input axis: byte i holds
# code[2i] in the low nibble and code[2i+1] in the high nibble.  3-bit codes
# reuse the 4-bit container; 8-bit is a no-op.
# ---------------------------------------------------------------------------

def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    if bits > 4:
        return codes
    n_in = codes.shape[0]
    if n_in % 2 != 0:
        raise ValueError(f"packing needs even n_in, got {n_in}")
    lo = codes[0::2, :].to(torch.uint8)
    hi = codes[1::2, :].to(torch.uint8)
    return lo | (hi << 4)


def unpack_codes(packed: torch.Tensor, bits: int, n_in: int) -> torch.Tensor:
    if bits > 4:
        return packed
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.stack([lo, hi], dim=1).reshape(n_in, packed.shape[-1])


def numpy_quant_reference(w: np.ndarray, spec: QuantSpec,
                          act_scale: Optional[np.ndarray] = None) -> np.ndarray:
    """Pure-numpy oracle for quant_dequant (used by property tests)."""
    w = w.astype(np.float64)
    if act_scale is not None:
        w = w * act_scale[:, None].astype(np.float64)
    n_in, n_out = w.shape
    g = effective_group_size(n_in, spec.group_size)
    wg = w.reshape(n_in // g, g, n_out)
    lo, hi = wg.min(axis=1), wg.max(axis=1)
    if spec.symmetric:
        amax = np.maximum(np.abs(lo), np.abs(hi))
        scale = np.maximum(amax / spec.qmax, 1e-8)
        zero = np.zeros_like(scale)
        qmin, qmax = spec.qmin, spec.qmax
    else:
        lo = np.minimum(lo, 0.0)
        hi = np.maximum(hi, 0.0)
        scale = np.maximum((hi - lo) / (spec.levels - 1), 1e-8)
        zero = np.round(-lo / scale)
        qmin, qmax = 0, spec.levels - 1
    s_full = np.repeat(scale, g, axis=0)
    z_full = np.repeat(zero, g, axis=0)
    codes = np.clip(np.round(w / s_full) + z_full, qmin, qmax)
    w_hat = (codes - z_full) * s_full
    if act_scale is not None:
        w_hat = w_hat / act_scale[:, None].astype(np.float64)
    return w_hat
