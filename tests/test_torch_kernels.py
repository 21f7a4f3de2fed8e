"""The port's kernel modules on the CPU: each plain PyTorch version
against the reference's Pallas kernel run in interpret mode, on the same
numpy inputs; CPU tensors never reach the CUDA build.

Tolerance: atol = rtol = 1e-5 in float32 (same math, different
summation order).  The CUDA kernels themselves are held against these
plain versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantSpec as JSpec
from repro.core import quantize_groupwise as j_quantize
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro.kernels.quant_matmul import quant_matmul_pallas
from repro_torch.core import QuantSpec, quantize_groupwise
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models.common import chunked_attention

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _packed(k, n, g, seed):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    qt = j_quantize(jnp.asarray(w), JSpec(bits=4, group_size=g), pack=True)
    return tuple(np.array(a) for a in (qt.codes, qt.scale, qt.zero))


@pytest.mark.parametrize("m", [1, 3, 130])
@pytest.mark.parametrize("k,n,g", [(1600, 1600, 100), (128, 1600, 64)])
def test_quant_matmul_plain_matches_pallas(m, k, n, g):
    codes, scale, zero = _packed(k, n, g, seed=m + k)
    x = (np.random.default_rng(m).normal(size=(m, k)) / np.sqrt(k)) \
        .astype(np.float32)
    ref = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(codes),
                              jnp.asarray(scale), jnp.asarray(zero),
                              interpret=True)
    got = qm.quant_matmul(*(torch.as_tensor(a) for a in (x, codes, scale,
                                                         zero)))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_ops_quant_matmul_applies_act_scale_and_leading_dims():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(128, 96)).astype(np.float32)
    s = (np.abs(rng.normal(size=128)) + 0.5).astype(np.float32)
    x = (rng.normal(size=(2, 5, 128)) / 11.0).astype(np.float32)
    qt = quantize_groupwise(torch.as_tensor(w), QuantSpec(4, 64),
                            act_scale=torch.as_tensor(s), pack=True)
    got = ops.quant_matmul(torch.as_tensor(x), qt)
    deq = qm.dequant_ref(qt.codes, qt.scale, qt.zero, 128)
    expect = (torch.as_tensor(x) / torch.as_tensor(s)) @ deq
    assert got.shape == (2, 5, 96)
    torch.testing.assert_close(got, expect, **TOL)


@pytest.mark.parametrize("window", [None, 48])
def test_decode_attention_plain_matches_pallas(window):
    b, h, kh, s, hd = 4, 4, 2, 200, 32
    rng = np.random.default_rng(7)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, kh, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, kh, s, hd)).astype(np.float32)
    lens = np.array([0, 1, s, 131], np.int32)
    ref = flash_decode_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), window=window,
                              interpret=True)
    got = fd.flash_decode(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), torch.as_tensor(lens),
                          window=window)
    assert got.shape == (b, 1, h, hd)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    # an empty slot yields 0, like the kernel's dead-split identity
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("t", [128, 200])
def test_flash_attention_plain_matches_pallas(t):
    bkh, g, hd = 3, 2, 32
    rng = np.random.default_rng(t)
    q = rng.normal(size=(bkh, g, t, hd)).astype(np.float32)
    k = rng.normal(size=(bkh, t, hd)).astype(np.float32)
    v = rng.normal(size=(bkh, t, hd)).astype(np.float32)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, interpret=True)
    got = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=True)
    assert got.shape == (bkh, g, t, hd)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_flash_attention_grouped_layout_matches_chunked():
    """The grouped (BKH, G, T, hd) layout the model's dispatch builds
    reproduces the model-side chunked attention."""
    b, t, h, kh, hd = 2, 128, 4, 2, 32
    g = h // kh
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(b, t, h, hd)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(b, t, kh, hd)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(b, t, kh, hd)).astype(np.float32))
    expect = chunked_attention(q, k, v, causal=True, chunk=64)
    qr = q.reshape(b, t, kh, g, hd).permute(0, 2, 3, 1, 4) \
          .reshape(b * kh, g, t, hd)
    out = fa.flash_attention(qr, k.permute(0, 2, 1, 3).reshape(b * kh, t, hd),
                             v.permute(0, 2, 1, 3).reshape(b * kh, t, hd))
    out = out.reshape(b, kh, g, t, hd).permute(0, 3, 1, 2, 4) \
             .reshape(b, t, h, hd)
    torch.testing.assert_close(out, expect, **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(2, 1, 64, 160)
    with pytest.raises(ValueError, match="hd <= 128"):
        fa.flash_attention(q, torch.zeros(2, 64, 160),
                           torch.zeros(2, 64, 160))
    with pytest.raises(ValueError):
        qm.quant_matmul(torch.zeros(3, 10), torch.zeros(4, 8, dtype=torch.uint8),
                        torch.zeros(1, 8), torch.zeros(1, 8))
    with pytest.raises(ValueError):
        fd.flash_decode(torch.zeros(2, 2, 4, 8), torch.zeros(2, 2, 16, 8),
                        torch.zeros(2, 2, 16, 8), torch.ones(2))


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    """Dispatch follows the tensor's device: on CPU tensors every wrapper
    takes its plain version — nothing is built or loaded and no launch is
    counted."""
    def refuse(*a, **k):
        raise AssertionError("CPU path reached the CUDA build")

    monkeypatch.setattr(_build, "_load", refuse)
    monkeypatch.setattr(_build, "_build_locked", refuse)
    before = [qm.KERNEL.launches, fd.KERNEL.launches, fa.KERNEL.launches]
    qt = quantize_groupwise(torch.randn(64, 32), QuantSpec(4, 32), pack=True)
    ops.quant_matmul(torch.randn(3, 64), qt)
    ops.decode_attention(torch.randn(2, 1, 4, 16), torch.randn(2, 2, 8, 16),
                         torch.randn(2, 2, 8, 16),
                         torch.tensor([3, 8], dtype=torch.int32))
    chunked_attention(torch.randn(1, 128, 4, 16), torch.randn(1, 128, 2, 16),
                      torch.randn(1, 128, 2, 16))
    fa.flash_attention(torch.randn(2, 2, 128, 16), torch.randn(2, 128, 16),
                       torch.randn(2, 128, 16))
    assert [qm.KERNEL.launches, fd.KERNEL.launches,
            fa.KERNEL.launches] == before == [0, 0, 0]
