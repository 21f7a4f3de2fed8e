"""The bf16 quant_matmul kernel's numerics and its wrapper's choices, on
the CPU.

The card runs the kernel (tests/test_torch_cuda.py); here the same
arithmetic is written out in PyTorch and held against the plain version
and the reference's Pallas kernel (interpret mode) on the same numpy
inputs, and the wrapper's Python-side choices are checked:

* groups of whole 64-row k steps (the main path's g = 64): x (code - zero)
  summed per group in f32 with the exact integer weight, the group's scale
  applied by fma, groups folded into chunks and chunks into the total in
  order.  It differs from the plain version by summation order only.
* other groups (g = 100): each weight rounded once to bf16 as
  bf16((code - zero) * scale), 2^-9 relative per weight, about 1.6e-3 of
  the output's norm for random signs.

Tolerance, as on the card: max abs error <= 1e-2 * max|plain| and
||error|| <= 1e-2 * ||plain||; the exact path is also held to 1e-5 of the
norm (f32 summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantSpec as JSpec
from repro.core import quantize_groupwise as j_quantize
from repro.kernels.quant_matmul import quant_matmul_pallas
from repro_torch.kernels import quant_matmul as qm

H100_SMS = 132      # the plans below are the ones the H100 gets


def _packed(k, n, g, seed):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    qt = j_quantize(jnp.asarray(w), JSpec(bits=4, group_size=g), pack=True)
    return tuple(np.array(a) for a in (qt.codes, qt.scale, qt.zero))


def _x(m, k, seed):
    """bf16-representable activations, as the kernel receives them."""
    x = np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)
    return torch.as_tensor(x).bfloat16().float().numpy()


def _codes(codes, k):
    lo, hi = codes & 0x0F, codes >> 4
    return torch.as_tensor(np.stack([lo, hi], axis=1).reshape(k, -1)).float()


def _exact_model(x, codes, scale, zero):
    """The g % 64 == 0 path: per group p = x . (code - zero) in f32, c =
    fma(scale, p, c) over a chunk's groups, total += c over chunks."""
    m, k = x.shape
    g = k // scale.shape[0]
    chunk = qm.chunk_rows(k, g)
    w = _codes(codes, k) - torch.as_tensor(zero).repeat_interleave(g, 0)
    x = torch.as_tensor(x)
    total = torch.zeros(m, codes.shape[1])
    for c0 in range(0, k, chunk):
        c = torch.zeros_like(total)
        for g0 in range(c0, min(k, c0 + chunk), g):
            p = x[:, g0:g0 + g] @ w[g0:g0 + g]
            c = c + torch.as_tensor(scale[g0 // g]) * p
        total = total + c
    return total


def _rounded_weight_model(x, codes, scale, zero):
    """The general path: each weight rounded once to bf16."""
    k = x.shape[1]
    w = qm.dequant_ref(*(torch.as_tensor(a) for a in (codes, scale, zero)), k)
    return torch.as_tensor(x) @ w.bfloat16().float()


def _close(got, want, rel_norm=1e-2):
    diff = got.float() - want.float()
    assert float(diff.abs().max()) <= 1e-2 * float(want.abs().max())
    assert float(diff.norm() / want.norm()) <= rel_norm


@pytest.mark.parametrize("m,k,n,g", [(4, 4096, 1024, 64), (64, 1024, 256, 64),
                                     (3, 512, 96, 128)])
def test_exact_model_matches_plain_and_pallas(m, k, n, g):
    codes, scale, zero = _packed(k, n, g, seed=k + n)
    x = _x(m, k, seed=m)
    got = _exact_model(x, codes, scale, zero)
    plain = qm.quant_matmul_ref(*(torch.as_tensor(a) for a in
                                  (x, codes, scale, zero)))
    _close(got, plain, rel_norm=1e-5)
    if k <= 1024:
        pallas = quant_matmul_pallas(*(jnp.asarray(a) for a in
                                       (x, codes, scale, zero)),
                                     interpret=True)
        _close(got, torch.as_tensor(np.array(pallas)), rel_norm=1e-5)


@pytest.mark.parametrize("m,k,n,g", [(4, 1600, 1600, 100),
                                     (9, 1600, 100, 100), (4, 4096, 1024, 64)])
def test_rounded_weight_model_within_the_stated_limit(m, k, n, g):
    codes, scale, zero = _packed(k, n, g, seed=k - n)
    x = _x(m, k, seed=m + 1)
    plain = qm.quant_matmul_ref(*(torch.as_tensor(a) for a in
                                  (x, codes, scale, zero)))
    got = _rounded_weight_model(x, codes, scale, zero)
    _close(got, plain)
    # 2^-9 per weight, random signs: far under the limit, not zero
    rel = float((got - plain).norm() / plain.norm())
    assert 1e-4 < rel < 4e-3, rel


@pytest.mark.parametrize("m,k,n,g", [(3, 1600, 100, 100), (2, 320, 100, 64),
                                     (5, 100, 30, 100), (1, 6, 10, 3)])
def test_padding_gives_the_plain_result(m, k, n, g):
    codes, scale, zero = (torch.as_tensor(a) for a in
                          _packed(k, n, g, seed=m + k + n))
    x = torch.as_tensor(_x(m, k, seed=n))
    xp, cp, sp, zp = qm.padded(x, codes, scale, zero)
    assert xp.shape[1] % 8 == 0 and cp.shape[1] % 16 == 0
    assert cp.shape == (xp.shape[1] // 2, sp.shape[1])
    assert sp.shape[0] == scale.shape[0] and zp.shape == sp.shape
    got = _padded_ref(xp, cp, sp, zp, k)
    torch.testing.assert_close(got[:, :n], qm.quant_matmul_ref(
        x, codes, scale, zero), atol=1e-5, rtol=1e-5)
    assert float(got[:, n:].abs().sum()) == 0.0


def _padded_ref(xp, cp, sp, zp, k):
    """The padded operands as the kernel reads them: groups of the original
    g, and k rows past the original k in no group (scale and zero 0)."""
    w = torch.zeros(xp.shape[1], cp.shape[1])
    w[:k] = qm.dequant_ref(cp[:k // 2], sp, zp, k)
    return xp @ w


def test_padding_keeps_aligned_operands():
    codes, scale, zero = (torch.as_tensor(a) for a in _packed(128, 64, 64, 0))
    x = torch.zeros(4, 128)
    assert all(a is b for a, b in zip(qm.padded(x, codes, scale, zero),
                                      (x, codes, scale, zero)))


@pytest.mark.parametrize("k,n,g", [(4096, 14336, 64), (14336, 4096, 64),
                                   (4096, 1024, 64), (1600, 1600, 100),
                                   (320, 112, 64), (4096, 4096, 128)])
def test_fold_order_does_not_depend_on_m(k, n, g):
    """The chunks (the fold order) are fixed by k and g; the tile and the
    split may follow m."""
    plans = [qm.plan(m, k, n, g, H100_SMS) for m in (1, 4, 8, 9, 16, 33, 64, 65, 130,
                                           2048, 4096)]
    assert len({(p.chunk, p.n_chunks) for p in plans}) == 1
    chunk = plans[0].chunk
    assert chunk == qm.chunk_rows(k, g) and chunk % 16 == 0
    assert plans[0].n_chunks == -(-k // chunk) <= qm.MAX_CHUNKS
    if g % qm.GROUP_ALIGN == 0:
        assert chunk % g == 0
    assert [p.cfg for p in plans] == sorted(p.cfg for p in plans)
    for p in plans:
        if p.cpb:
            assert 1 <= p.cpb <= p.n_chunks


def test_plan_splits_decode_and_not_large_prefill():
    decode = qm.plan(4, 4096, 14336, 64, H100_SMS)
    assert decode.cfg == 0 and decode.n_chunks == 16 and decode.cpb > 0
    assert qm.plan(4, 4096, 1024, 64, H100_SMS).cpb == 1     # 8 tiles: every chunk apart
    prefill = qm.plan(2048, 4096, 14336, 64, H100_SMS)
    assert prefill.cfg == 3 and prefill.cpb == 0
    # the chunk scratch stays bounded when a split would need more
    assert qm.plan(64, 4096, 14336, 64, H100_SMS).cpb == 0
