"""The quant_error kernel's arithmetic and its wrapper's choices, on the
CPU.

The card runs the kernel (tests/test_torch_cuda.py); here its element
arithmetic is written out in numpy and held against IEEE float32 and the
plain version, and :func:`repro_torch.kernels.quant_error.plan` is held
to the launch it must make:

* division: the kernel replaces a / b by one multiply and three fused
  multiply-adds with b's reciprocal as hi + lo (hi = RN(1/b)).  The model
  must give numpy's float32 quotient bit for bit.  A float32 fma is
  emulated in float64: the product is exact there, the sum is rounded to
  odd, and one rounding to float32 then rounds the exact value.
* rounding: rint(x) as (x + 1.5 * 2^23) - 1.5 * 2^23 in float32 must equal
  torch.round (half to even) for |x| <= 2^22.
* every element's w_hat from the kernel's steps (divisions and rounding as
  above, clamp and zero folded into the shifted rounding domain, no lower
  clamp) must equal the plain version's ``quant_dequant`` bit for bit, so
  the kernel differs from :func:`quant_error_ref` by summation order only.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import QuantSpec
from repro_torch.core.quantizer import quant_dequant
from repro_torch.kernels import quant_error as qe

F32 = np.float32
MAGIC = F32(1.5 * 2 ** 23)


def _fma32(a, b, c):
    """float32 fma(a, b, c) with a single rounding."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b                                   # exact: 24 + 24 bits
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)             # p + c - s, exactly
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _recip(b):
    hi = F32(1) / b
    return hi, _fma32(-b, hi, F32(1)) * hi


def _div(a, b, hi, lo):
    """The kernel's div_rn."""
    q = _fma32(a, hi, a * lo)
    return _fma32(_fma32(-b, q, a), hi, q)


def _log_uniform(rng, lo, hi, size):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), size)).astype(F32)


def _random_floats(rng, size, e_lo, e_hi):
    """Floats with uniformly random 24-bit significands and signs, exponents
    in [e_lo, e_hi)."""
    sig = (rng.integers(1 << 23, 1 << 24, size) * 2.0 ** -23)
    sign = rng.choice([-1.0, 1.0], size)
    return (sign * sig * 2.0 ** rng.integers(e_lo, e_hi, size)).astype(F32)


def _pairs(kind, rng, size):
    if kind == "ws / scale":
        # w * s over scale: |quotient| up to the 4-bit range and past it
        b = _log_uniform(rng, 1e-6, 1.0, size)
        return (b * rng.uniform(-17, 17, size)).astype(F32), b
    if kind == "codes * scale / s":
        scale = _log_uniform(rng, 1e-6, 1.0, size)
        a = (rng.integers(-15, 16, size).astype(F32) * scale).astype(F32)
        return a, _log_uniform(rng, 0.01, 100.0, size)
    return (_random_floats(rng, size, -30, 30),
            _random_floats(rng, size, -30, 30))


@pytest.mark.parametrize("kind", ["ws / scale", "codes * scale / s",
                                  "random bits"])
def test_division_model_equals_ieee_quotient(kind):
    rng = np.random.default_rng(["ws / scale", "codes * scale / s",
                                 "random bits"].index(kind))
    for _ in range(4):
        a, b = _pairs(kind, rng, 1 << 20)
        got = _div(a, b, *_recip(b))
        want = a / b
        bad = np.flatnonzero(got != want)
        i = bad[0] if bad.size else 0
        assert bad.size == 0, (f"{bad.size} quotients differ, first "
                               f"{a[i]!r} / {b[i]!r}: {got[i]!r} != "
                               f"{want[i]!r}")


def test_fma_model_rounds_once():
    # (1 - 2^-24)(1 + 2^-23) + 2^-47 + 2^-60 = 1 + 2^-24 + 2^-60, just
    # above the midpoint of 1 and 1 + 2^-23: one rounding goes up, while
    # rounding to float64 first lands on the midpoint and then goes to 1
    a, b = F32(1 - 2 ** -24), F32(1 + 2 ** -23)
    assert _fma32(a, b, F32(2 ** -47 + 2 ** -60)) == F32(1 + 2 ** -23)
    assert np.float32(np.float64(a) * np.float64(b)
                      + np.float64(F32(2 ** -47 + 2 ** -60))) == F32(1)
    # the product alone, 1 + 2^-24 - 2^-47, rounds down
    assert _fma32(a, b, F32(0)) == F32(1)


def _magic_rint(x: torch.Tensor) -> torch.Tensor:
    return (x + float(MAGIC)) - float(MAGIC)


def test_magic_rounding_matches_round_half_even_on_halves():
    # every multiple of 0.5 in [-2^22, 2^22] (2^24 + 1 values)
    x = (torch.arange(-(1 << 23), (1 << 23) + 1, dtype=torch.float64) / 2
         ).float()
    assert torch.equal(_magic_rint(x), torch.round(x))


def test_magic_rounding_matches_round_half_even_between():
    g = torch.Generator().manual_seed(0)
    x = torch.cat([
        (torch.rand(1 << 22, generator=g, dtype=torch.float64) * 2 - 1)
        .mul(2 ** 22).float(),
        (torch.rand(1 << 22, generator=g) * 2 - 1) * 20,
        torch.randn(1 << 20, generator=g) * 1e-3])
    x = x[x.abs() <= 2 ** 22]
    assert torch.equal(_magic_rint(x), torch.round(x))


def _kernel_w_hat(w, s, g, spec):
    """The kernel's w_hat for w (k, n) f32 and one candidate s (k,)."""
    k, n = w.shape
    ws = w * s[:, None]
    lo = ws.reshape(k // g, g, n).min(axis=1)
    hi = ws.reshape(k // g, g, n).max(axis=1)
    den = np.full_like(lo, spec.qmax if spec.symmetric else spec.levels - 1)
    if spec.symmetric:
        amax = np.maximum(np.abs(lo), np.abs(hi))
        scale = np.maximum(_div(amax, den, *_recip(den)), F32(1e-8))
        zero = np.zeros_like(scale)
    else:
        lo, hi = np.minimum(lo, F32(0)), np.maximum(hi, F32(0))
        scale = np.maximum(_div(hi - lo, den, *_recip(den)), F32(1e-8))
        zero = _magic_rint(torch.from_numpy(_div(-lo, scale, *_recip(scale)))
                           ).numpy()
    scale, zero = (np.repeat(x, g, axis=0) for x in (scale, zero))
    q = _div(ws, scale, *_recip(scale))
    # the lower clamp never acts (csrc/quant_error.cu, deviation)
    t = np.minimum(q + MAGIC, MAGIC + (F32(spec.qmax) - zero))
    v = (t - MAGIC) * scale
    sb = np.broadcast_to(s[:, None], w.shape)
    return _div(v, sb, *_recip(sb))


@pytest.mark.parametrize("k,n,g", [(256, 96, 64), (300, 70, 100),
                                   (256, 50, 128)])
@pytest.mark.parametrize("sym", [False, True])
def test_kernel_terms_equal_plain_terms(k, n, g, sym):
    rng = np.random.default_rng(k + n + g + sym)
    spec = QuantSpec(4, g, symmetric=sym)
    # bf16-valued weights as on the main path, one wide row to clip others
    w = torch.from_numpy(rng.normal(0, 0.02, (k, n)).astype(F32)) \
        .bfloat16().float().numpy()
    w[::7] *= 9
    for s in (np.ones(k, F32), (rng.random(k) * 3 + 0.1).astype(F32),
              _log_uniform(rng, 1e-3, 1e3, k)):
        got = _kernel_w_hat(w, s, g, spec)
        want = quant_dequant(torch.from_numpy(w), spec,
                             act_scale=torch.from_numpy(s)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("k,n,g,a,path,grid", [
    (4096, 14336, 64, 22, 64, (112, 64)),      # w_gate / w_up of llama3-8b
    (14336, 4096, 64, 22, 64, (32, 224)),      # w_down
    (4096, 1024, 64, 22, 64, (8, 64)),         # wk / wv
    (4096, 4096, 128, 22, 128, (32, 32)),
    (300, 100, 100, 5, 0, (1, 3)),             # hymba-like groups of 100
    (320, 33, 32, 1, 0, (1, 10)),
    (1600, 129, 1600, 3, 0, (2, 1)),           # one group: per-channel
])
def test_plan_path_grid_and_shared_memory(k, n, g, a, path, grid):
    p = qe.plan(k, n, g, a)
    assert p.path == path and p.grid == grid
    assert p.n_blocks == grid[0] * grid[1]
    # s, 1/s as hi + lo per (candidate, row), mean_sq per row, each
    # thread's error per candidate
    assert p.smem == (3 * a * g + g + 128 * a) * 4


def test_plan_does_not_depend_on_the_candidates():
    plans = [qe.plan(4096, 14336, 64, a) for a in (1, 5, 22, 181)]
    assert len({(p.path, p.grid, p.n_blocks) for p in plans}) == 1


@pytest.mark.parametrize("g,a_max", [(64, 181), (128, 113), (100, 135)])
def test_plan_candidate_limit(g, a_max):
    p = qe.plan(g * 8, 200, g, a_max)
    assert p.smem <= qe.SMEM_LIMIT
    with pytest.raises(ValueError, match=f"at most {a_max} candidates fit"):
        qe.plan(g * 8, 200, g, a_max + 1)


@pytest.mark.parametrize("k,n,g,a,msg", [
    (300, 10, 64, 1, "g dividing k"),
    (256, 0, 64, 1, "k, n >= 1"),
    (256, 10, 64, 0, "at least one candidate"),
    (4096, 10, 4096, 5, "shared memory"),
    (1 << 17, 10, 1, 1, "exceed the grid"),
])
def test_plan_raises_with_a_clear_message(k, n, g, a, msg):
    with pytest.raises(ValueError, match=msg):
        qe.plan(k, n, g, a)


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(128, 40)).astype(F32))
    scales = torch.from_numpy((rng.random((3, 128)) + 0.5).astype(F32))
    msq = torch.from_numpy(rng.random(128).astype(F32))
    before = qe.KERNEL.launches
    got = qe.quant_error(w, scales, msq, QuantSpec(4, 64))
    assert qe.KERNEL.launches == before
    assert torch.equal(got, qe.quant_error_ref(w, scales, msq,
                                               QuantSpec(4, 64)))
