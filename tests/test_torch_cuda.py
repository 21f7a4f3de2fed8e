"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and skips without one; the file
imports nothing of jax or repro so it also runs where only PyTorch is
installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: atol = rtol = 1e-4 (quant_matmul: k = 1600 f32 sums in
another order) or 1e-5 (attention, quant_error relative), float32 inputs.
The bf16 tensor-core routes: max abs error 1e-2 * max|plain| and
||error|| <= 1e-2 * ||plain|| — the output is rounded to bf16 (2^-9
relative); flash_attention rounds P to bf16 before the P.V product (2^-9
relative per term) where the plain version keeps f32; quant_matmul at
groups not a multiple of 64 rows rounds each weight to bf16 once (2^-9
relative).  At g % 64 == 0 quant_matmul subtracts the zero from the codes
exactly and scales each group's f32 sum, so it differs from the plain
version by summation order only, and its norm limit is 5e-4 (a kernel that
rounded the weights to bf16 reads 2.4e-3 or more).  The paged decode
kernels must give the dense kernels' bits on the same logical cache, every
decode variant a slot's bits whatever else is in the batch, and bf16
quant_matmul a row's bits whatever m is (``torch.equal``).  quant_error's
terms are the plain version's bit for bit (its division and rounding equal
``__fdiv_rn`` and ``rintf`` on 1.3e8 operand pairs), so it is held to
rtol 1e-5 (summation order), and must give the same bits on repeated
calls and for any subset of its candidates, also for subnormal and
near-zero weights and smoothing scales down to 1e-38.

Speculative decoding: every verify variant's row t gives the bits of the
single-position kernel at ``base + t + 1`` (across split and page
boundaries) in one launch; rms_norm is held to max abs error 1e-2 *
max|plain| in bf16 (output rounding) and 1e-5 in f32 (summation order),
and a row's bits do not depend on the rows beside it.  At llama3-8b's
full width (2 of its 32 layers, RTN int4 weights), one decode step gives
each slot the same logits at batch 1, 2 and 4, and ``verify_step`` over a
4-token burst the logits of 4 sequential ``decode_step`` calls, bit for
bit, for the bf16, int8 and paged caches.

Prefill: flash_attention with a key length per batch row (bucket padding)
is held to the plain version with the same lengths, and each prompt's
valid rows equal the prompt run alone at its exact length bit for bit
(kv_lens = T equals no mask); at full width a prompt's prefill logits and
K/V do not depend on the bucket (16, 64, 512) or the batch (1, 2, 4).
"""
import ctypes
import math

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, quantize_groupwise, quantize_model
from repro_torch.core.methods import DEFAULT_ALPHA_GRID, candidate_scale
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import quant_error as qe
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import rms_norm as rn
from repro_torch.models.common import quantize_kv
from repro_torch.models.registry import build_model

pytestmark = pytest.mark.cuda

EXACT_REL_TOL = 5e-4    # bf16 quant_matmul's norm limit at g % 64 == 0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [1, 4, 130])
def test_quant_matmul_matches_plain(dev, m):
    qt = quantize_groupwise(torch.randn(1600, 1600, device=dev),
                            QuantSpec(4, 100), pack=True)
    x = torch.randn(m, 1600, device=dev) / 40
    before = qm.KERNEL.launches
    got = qm.quant_matmul(x, qt.codes, qt.scale, qt.zero)
    assert qm.KERNEL.launches == before + 1
    torch.testing.assert_close(got, qm.quant_matmul_ref(
        x, qt.codes, qt.scale, qt.zero), atol=1e-4, rtol=1e-4)
    # a row's result does not depend on m (skinny vs tiled path)
    one = qm.quant_matmul(x[:1].contiguous(), qt.codes, qt.scale, qt.zero)
    assert torch.equal(one[0], got[0])


def _packed(k, n, g, gen):
    qt = quantize_groupwise(torch.randn(k, n, generator=gen, device=gen.device),
                            QuantSpec(4, g), pack=True)
    return qt.codes, qt.scale, qt.zero


@pytest.mark.parametrize("k,n,g", [(1600, 1600, 100), (1600, 100, 100),
                                   (320, 100, 64), (128, 1600, 64),
                                   (4096, 1024, 64), (512, 256, 128),
                                   (96, 40, 32)])
@pytest.mark.parametrize("m", [1, 3, 4, 9, 33, 130])
def test_quant_matmul_bf16_matches_plain(dev, m, k, n, g):
    """The tensor-core route at the main path's g = 64, g = 128 (groups of
    whole k steps), and groups that are not (100, 32), with padded n."""
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k + n + g)
    codes, scale, zero = _packed(k, n, g, gen)
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    before = qm.KERNEL.launches
    got = qm.quant_matmul(x, codes, scale, zero)
    assert qm.KERNEL.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _bf16_close(got, qm.quant_matmul_ref(x, codes, scale, zero),
                rel_tol=EXACT_REL_TOL if g % 64 == 0 else 1e-2)


@pytest.mark.parametrize("k,n,g", [(4096, 14336, 64), (14336, 4096, 128),
                                   (1600, 1600, 100)])
def test_quant_matmul_bf16_rows_do_not_depend_on_m(dev, k, n, g):
    """Row r of an m-row call has the bits of row r of the 2048-row call,
    across every tile and the split / unsplit regimes."""
    gen = torch.Generator(device=dev).manual_seed(k + n)
    codes, scale, zero = _packed(k, n, g, gen)
    x = torch.randn(2048, k, generator=gen, device=dev).bfloat16()
    full = qm.quant_matmul(x, codes, scale, zero)
    for m in (1, 3, 4, 8, 9, 16, 17, 32, 33, 64, 65, 130, 1000):
        assert torch.equal(qm.quant_matmul(x[:m].contiguous(), codes, scale,
                                           zero), full[:m]), m


@pytest.mark.parametrize("m,k,n,g", [(4, 4096, 1024, 64), (4, 14336, 4096, 64),
                                     (130, 1600, 1600, 100),
                                     (40, 1024, 512, 128)])
def test_quant_matmul_bf16_split_does_not_change_bits(dev, m, k, n, g):
    """A call whose plan splits k across blocks gives the bits of the same
    rows in a call of 4096 rows, whose chunk scratch would be too large to
    split."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert qm.plan(m, k, n, g, sms).cpb > 0
    assert qm.plan(4096, k, n, g, sms).cpb == 0
    gen = torch.Generator(device=dev).manual_seed(m + k)
    codes, scale, zero = _packed(k, n, g, gen)
    x = torch.randn(4096, k, generator=gen, device=dev).bfloat16()
    whole = qm.quant_matmul(x, codes, scale, zero)
    assert torch.equal(qm.quant_matmul(x[:m].contiguous(), codes, scale,
                                       zero), whole[:m])


def test_quant_matmul_bf16_on_two_streams_at_once(dev):
    """Split launches queued on two streams may run at the same time: each
    stream has its own chunk scratch and counters."""
    gen = torch.Generator(device=dev).manual_seed(5)
    inputs = [(torch.randn(4, 4096, generator=gen, device=dev).bfloat16(),
               *_packed(4096, 4096, 64, gen)) for _ in range(2)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert qm.plan(4, 4096, 4096, 64, sms).cpb > 0
    alone = [qm.quant_matmul(*a) for a in inputs]
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    got = [[] for _ in inputs]
    torch.cuda.synchronize(dev)
    for _ in range(20):
        for args, st, out in zip(inputs, streams, got):
            with torch.cuda.stream(st):
                out.append(qm.quant_matmul(*args))
    torch.cuda.synchronize(dev)
    for want, outs in zip(alone, got):
        assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("m", [4, 64, 2048])
def test_quant_matmul_bf16_is_one_launch(dev, m):
    """One device kernel per call, split or not (no reduce pass)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(m)
    codes, scale, zero = _packed(4096, 4096, 64, gen)
    x = torch.randn(m, 4096, generator=gen, device=dev).bfloat16()
    qm.quant_matmul(x, codes, scale, zero)
    torch.cuda.synchronize(dev)

    def profiled():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                qm.quant_matmul(x, codes, scale, zero)
            torch.cuda.synchronize(dev)
        return prof.key_averages()

    profiled()          # a first session can miss a kernel while tracing starts
    events = profiled()
    names = [e.key for e in events
             if getattr(e, "self_device_time_total", 0) > 0]
    qmm = [e for e in events if "qmm" in e.key]
    assert names and all("qmm_tc" in k for k in names if "qmm" in k), names
    assert sum(e.count for e in qmm) == 3, [(e.key, e.count) for e in qmm]


@pytest.mark.parametrize("h,hd", [(8, 64), (32, 128)])
def test_flash_decode_matches_plain(dev, h, hd):
    """G = 4, and G = 16 with hd 128 (every thread of a split owns one
    output unit, no partial sums)."""
    q = torch.randn(4, 1, h, hd, device=dev)
    k, v = (torch.randn(4, 2, 300, hd, device=dev) for _ in range(2))
    lens = torch.tensor([0, 1, 300, 129], dtype=torch.int32, device=dev)
    for window in (None, 50):
        torch.testing.assert_close(
            fd.flash_decode(q, k, v, lens, window=window),
            fd.decode_attention_ref(q, k, v, lens, window=window),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t", [128, 200])
def test_flash_attention_matches_plain(dev, t):
    q = torch.randn(3, 2, t, 64, device=dev)
    k, v = (torch.randn(3, t, 64, device=dev) for _ in range(2))
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_ref(q, k, v),
                               atol=1e-5, rtol=1e-5)


def _bf16_close(got, want, rel_tol=1e-2):
    """bf16 routes: max error <= 1e-2 * max|plain|, the bf16 limit of
    chip_smoke.py, and ||error|| <= rel_tol * ||plain||.  Most causal rows
    average many V rows and are far smaller than max|plain| (row 0's), so
    the norm catches an error spread over them (a shifted mask, a wrong
    scale) that the max-abs limit alone would pass."""
    diff = got.float() - want.float()
    assert bool(torch.isfinite(got).all())
    err = float(diff.abs().max())
    assert err <= 1e-2 * float(want.float().abs().max()), err
    rel = float(diff.norm() / want.float().norm())
    assert rel <= rel_tol, rel


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [36, 64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("t", [37, 150, 200])
def test_flash_attention_bf16_matches_plain(dev, t, g, hd, causal):
    gen = torch.Generator(device=dev).manual_seed(t * 1000 + g * 100 + hd)
    q = torch.randn(3, g, t, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(3, t, hd, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.KERNEL.launches == before + 1
    _bf16_close(got, fa.flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("g", [3, 16])
def test_flash_attention_bf16_head_groups(dev, g):
    """G not a power of two, and G above the 8 heads one block holds."""
    gen = torch.Generator(device=dev).manual_seed(g)
    q = torch.randn(2, g, 150, 64, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(2, 150, 64, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    _bf16_close(fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [16, 64, 512])
def test_flash_attention_kv_lens_rows_equal_exact_length(dev, t, dtype):
    """Length-masked (bucket-padded) rows: held against the plain version
    with the same kv_lens, and (bf16, the main path's route) each valid
    row bit for bit equal to its prompt run alone at its exact length;
    kv_lens = T gives the unmasked call's bits."""
    b, g, hd = 4, 4, 128
    lens = [max(1, t - d) for d in (0, 3, t // 2, t - 1)]
    gen = torch.Generator(device=dev).manual_seed(t)
    q = torch.randn(b * 8, g, t, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b * 8, t, hd, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, kv_lens=kv_lens)
    assert fa.KERNEL.launches == before + 1
    want = fa.flash_attention_ref(q, k, v, kv_lens=kv_lens)
    if dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    full = torch.full((b,), t, dtype=torch.int32, device=dev)
    assert torch.equal(fa.flash_attention(q, k, v, kv_lens=full),
                       fa.flash_attention(q, k, v))
    if dtype != torch.bfloat16:
        return
    for i, n in enumerate(lens):
        rows = slice(8 * i, 8 * i + 8)
        alone = fa.flash_attention(q[rows, :, :n].contiguous(),
                                   k[rows, :n].contiguous(),
                                   v[rows, :n].contiguous())
        assert torch.equal(got[rows, :, :n], alone), (i, n)


def _q8(cache):
    """(B, KH, S, hd) -> int8 codes and (B, KH, S, 1) scales."""
    codes, scale = quantize_kv(cache.transpose(1, 2))
    return codes.transpose(1, 2).contiguous(), scale.transpose(1, 2).contiguous()


def _paged(cache, ps, perm):
    """Cut (B, KH, S, hd) into pages behind the table ``perm`` (B, NP);
    page 0 (unmapped) is NaN for float stores, -128 / NaN for int8."""
    b, kh, s, hd = cache.shape
    pages = cache.reshape(b, kh, s // ps, ps, hd).permute(0, 2, 1, 3, 4) \
        .reshape(b * (s // ps), kh, ps, hd)
    store = torch.empty((1 + pages.shape[0],) + pages.shape[1:],
                        dtype=cache.dtype, device=cache.device)
    store[0] = -128 if cache.dtype == torch.int8 else float("nan")
    store[perm.reshape(-1).long()] = pages
    return store


@pytest.mark.parametrize("window", [None, 48])
def test_flash_decode_variants_match_plain_and_paged_equals_dense(dev,
                                                                  window):
    b, h, kh, s, hd, ps = 4, 8, 2, 256, 64, 8
    q = torch.randn(b, 1, h, hd, device=dev)
    k, v = (torch.randn(b, kh, s, hd, device=dev) for _ in range(2))
    lens = torch.tensor([0, 1, 131, 256], dtype=torch.int32, device=dev)
    perm = (torch.randperm(b * s // ps, device=dev) + 1).reshape(b, -1) \
        .to(torch.int32)
    # unused table entries (past each slot's length) point at page 0
    live = torch.arange(s // ps, device=dev)[None] * ps < lens[:, None]
    table = torch.where(live, perm, torch.zeros_like(perm))
    kc, ks, vc, vs = *_q8(k), *_q8(v)
    dense = fd.flash_decode(q, k, v, lens, window=window)
    dense8 = fd.flash_decode_q8(q, kc, ks, vc, vs, lens, window=window)
    paged = fd.flash_decode_paged(q, _paged(k, ps, perm), _paged(v, ps, perm),
                                  table, lens, window=window)
    paged8 = fd.flash_decode_paged_q8(
        q, _paged(kc, ps, perm), _paged(ks, ps, perm), _paged(vc, ps, perm),
        _paged(vs, ps, perm), table, lens, window=window)
    torch.testing.assert_close(dense8, fd.decode_attention_q8_ref(
        q, kc, ks, vc, vs, lens, window=window), atol=1e-5, rtol=1e-5)
    assert torch.equal(paged, dense)
    assert torch.equal(paged8, dense8)
    assert bool(torch.isfinite(paged8).all())


@pytest.mark.parametrize("sym,k,n,g", [(False, 256, 100, 64),
                                       (True, 300, 70, 100),
                                       (False, 128, 256, 128)])
def test_quant_error_matches_plain(dev, sym, k, n, g):
    w = torch.randn(k, n, device=dev)
    scales = torch.rand(5, k, device=dev) + 0.5
    msq = torch.rand(k, device=dev)
    spec = QuantSpec(4, g, symmetric=sym)
    before = qe.KERNEL.launches
    got = qe.quant_error(w, scales, msq, spec)
    assert qe.KERNEL.launches == before + 1
    torch.testing.assert_close(got, qe.quant_error_ref(w, scales, msq, spec),
                               atol=0, rtol=1e-5)


def _qe_inputs(k, n, a, dtype, gen, dev):
    """bf16-scale weights, the alpha grid's candidate scales (+ the ones,
    as the search adds the RTN baseline) up to ``a`` of them, mean_sq."""
    w = (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(dtype)
    a_stat = torch.rand(k, generator=gen, device=dev) + 0.1
    grid = [candidate_scale(a_stat, al) for al in DEFAULT_ALPHA_GRID]
    grid.append(torch.ones(k, device=dev))
    extra = [torch.rand(k, generator=gen, device=dev) * 3 + 0.1
             for _ in range(max(0, a - len(grid)))]
    scales = torch.stack(grid + extra)[:a].contiguous()
    return w, scales, torch.rand(k, generator=gen, device=dev)


@pytest.mark.parametrize("name,k,n", [
    ("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
    ("wo", 4096, 4096), ("w_gate", 4096, 14336), ("w_up", 4096, 14336),
    ("w_down", 14336, 4096)])
def test_quant_error_llama3_layer_shapes(dev, name, k, n):
    """The 7 projections of one llama3-8b layer, bf16, 21 alphas + ones,
    g = 64 (the register path)."""
    gen = torch.Generator(device=dev).manual_seed(k + n)
    w, scales, msq = _qe_inputs(k, n, 22, torch.bfloat16, gen, dev)
    spec = QuantSpec(4, 64)
    assert qe.plan(k, n, 64, 22).path == 64
    before = qe.KERNEL.launches
    got = qe.quant_error(w, scales, msq, spec)
    assert qe.KERNEL.launches == before + 1
    torch.testing.assert_close(got, qe.quant_error_ref(w, scales, msq, spec),
                               atol=0, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("g,path", [(64, 64), (128, 128), (100, 0)])
def test_quant_error_paths_match_plain(dev, g, path, sym, dtype):
    """Both register instantiations and the general path, n not a multiple
    of the 128-column tile, 7 candidates and 1."""
    k, n = 4 * g, 300
    gen = torch.Generator(device=dev).manual_seed(g + sym)
    w, scales, msq = _qe_inputs(k, n, 7, dtype, gen, dev)
    w[::5] *= 9                     # some rows set the groups' ranges
    spec = QuantSpec(4, g, symmetric=sym)
    assert qe.plan(k, n, g, 7).path == path
    for s in (scales, scales[:1]):
        torch.testing.assert_close(qe.quant_error(w, s, msq, spec),
                                   qe.quant_error_ref(w, s, msq, spec),
                                   atol=0, rtol=1e-5)


@pytest.mark.parametrize("g", [64, 128, 100])
def test_quant_error_at_the_candidate_limit(dev, g):
    k, n = 2 * g, 130
    a_max = (qe.SMEM_LIMIT // 4 - g) // (3 * g + qe.COLS)
    gen = torch.Generator(device=dev).manual_seed(g)
    w, scales, msq = _qe_inputs(k, n, a_max + 1, torch.bfloat16, gen, dev)
    spec = QuantSpec(4, g)
    torch.testing.assert_close(
        qe.quant_error(w, scales[:a_max], msq, spec),
        qe.quant_error_ref(w, scales[:a_max], msq, spec), atol=0, rtol=1e-5)
    before = qe.KERNEL.launches
    with pytest.raises(ValueError, match="shared memory"):
        qe.quant_error(w, scales, msq, spec)
    assert qe.KERNEL.launches == before


@pytest.mark.parametrize("k,n,g", [(4096, 14336, 64), (1024, 1000, 128),
                                   (300, 300, 100)])
def test_quant_error_bits_repeat_and_do_not_depend_on_other_candidates(
        dev, k, n, g):
    gen = torch.Generator(device=dev).manual_seed(n)
    w, scales, msq = _qe_inputs(k, n, 22, torch.bfloat16, gen, dev)
    spec = QuantSpec(4, g)
    full = qe.quant_error(w, scales, msq, spec)
    assert torch.equal(qe.quant_error(w, scales, msq, spec), full)
    assert torch.equal(qe.quant_error(w, scales[:5].contiguous(), msq, spec),
                       full[:5])
    assert torch.equal(qe.quant_error(w, scales[7:8].contiguous(), msq,
                                      spec), full[7:8])


def _div_check(a, b):
    """(division mismatches, rounding mismatches) of the kernel's div_rn
    against __fdiv_rn and its rint against rintf, over the pairs a / b."""
    fn = qe.KERNEL.lib().quant_error_div_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(2, dtype=torch.int64, device=a.device)
    assert fn(a.data_ptr(), b.data_ptr(), a.numel(), bad.data_ptr(),
              torch.cuda.current_stream(a.device).cuda_stream) == 0
    return tuple(int(x) for x in bad.cpu())


def test_quant_error_division_and_rounding_equal_ieee(dev):
    """2^27 operand pairs (1.3e8) in the timed shape's ranges and beyond:
    w * s over the column scale (bf16 weights of scale 0.02 times scales in
    [0.1, 10], over the group's range / 15), (code - zero) * scale over
    s, and random 24-bit significands."""
    gen = torch.Generator(device=dev).manual_seed(0)
    size, total = 1 << 24, 0

    def log_uniform(lo, hi):
        return torch.exp(torch.empty(size, device=dev).uniform_(
            math.log(lo), math.log(hi), generator=gen))

    def random_bits():
        sig = torch.randint(1 << 23, 1 << 24, (size,), device=dev,
                            generator=gen).double() * 2.0 ** -23
        exp = torch.randint(-30, 30, (size,), device=dev, generator=gen)
        sign = torch.randint(0, 2, (size,), device=dev, generator=gen) * 2 - 1
        return (sign * sig * torch.pow(2.0, exp.double())).float()

    for _ in range(2):
        ws = ((torch.randn(size, generator=gen, device=dev) * 0.02)
              .bfloat16().float() * log_uniform(0.1, 10.0))
        scale = (ws.abs().reshape(-1, 64).amax(1) * 2 / 15)
        scale = scale.clamp(min=1e-8).repeat_interleave(64)
        codes = torch.randint(-15, 16, (size,), device=dev, generator=gen)
        cs = log_uniform(1e-6, 1.0)
        for a, b in [(ws, scale),
                     (ws, log_uniform(1e-6, 1.0)),
                     (codes.float() * cs, log_uniform(0.01, 100.0)),
                     (random_bits(), random_bits())]:
            assert _div_check(a, b) == (0, 0)
            total += size
    assert total >= 10 ** 8


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("variant", ["dense", "q8", "paged", "paged_q8"])
def test_flash_decode_slot_bits_do_not_depend_on_the_batch(dev, variant,
                                                          window):
    """Slot b alone gives the bits it gets in a batch of 4 with other
    lengths (and a second launch the same bits: the combine counters are
    left zeroed)."""
    b, h, kh, s, hd, ps = 4, 32, 8, 1024, 128, 16
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, kh, s, hd, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    lens = torch.tensor([37, 700, 1, 300], dtype=torch.int32, device=dev)
    perm = (torch.randperm(b * s // ps, generator=gen, device=dev) + 1) \
        .reshape(b, -1).to(torch.int32)
    live = torch.arange(s // ps, device=dev)[None] * ps < lens[:, None]
    table = torch.where(live, perm, torch.zeros_like(perm))
    kc, ks, vc, vs = *_q8(k), *_q8(v)

    def run(sl):
        if variant == "dense":
            return fd.flash_decode(q[sl], k[sl], v[sl], lens[sl],
                                   window=window)
        if variant == "q8":
            return fd.flash_decode_q8(q[sl], kc[sl], ks[sl], vc[sl], vs[sl],
                                      lens[sl], window=window)
        if variant == "paged":
            return fd.flash_decode_paged(
                q[sl], _paged(k, ps, perm), _paged(v, ps, perm), table[sl],
                lens[sl], window=window)
        return fd.flash_decode_paged_q8(
            q[sl], _paged(kc, ps, perm), _paged(ks, ps, perm),
            _paged(vc, ps, perm), _paged(vs, ps, perm), table[sl], lens[sl],
            window=window)

    full = run(slice(None))
    assert torch.equal(run(slice(None)), full)
    for i in range(b):
        assert torch.equal(run(slice(i, i + 1))[0], full[i]), i


def test_flash_decode_on_two_streams_at_once(dev):
    """Launches queued on two streams may run at the same time: each stream
    has its own combine counters, so each gets the bits it gets alone."""
    gen = torch.Generator(device=dev).manual_seed(11)
    lens = torch.tensor([700, 1000, 333, 64], dtype=torch.int32, device=dev)
    inputs = [(torch.randn(4, 1, 32, 128, generator=gen, device=dev)
               .bfloat16(),
               *(torch.randn(4, 8, 1024, 128, generator=gen, device=dev)
                 .bfloat16() for _ in range(2))) for _ in range(2)]
    alone = [fd.flash_decode(q, k, v, lens) for q, k, v in inputs]
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    got = [[] for _ in inputs]
    torch.cuda.synchronize(dev)
    for _ in range(20):
        for (q, k, v), st, out in zip(inputs, streams, got):
            with torch.cuda.stream(st):
                out.append(fd.flash_decode(q, k, v, lens))
    torch.cuda.synchronize(dev)
    for want, outs in zip(alone, got):
        assert all(torch.equal(o, want) for o in outs)


def test_quant_error_near_underflow_matches_plain(dev):
    """Operands near underflow: subnormal, near-zero and zero weights (the
    products w * s underflow, group ranges fall below the 1e-8 scale floor)
    and smoothing scales log-uniform down to 1e-38 (subnormal; their
    reciprocals up to 1e38), against the plain version; and the kernel's
    division equal to __fdiv_rn on the pairs such inputs form."""
    gen = torch.Generator(device=dev).manual_seed(5)
    k, n, a = 256, 384, 6
    mag = torch.exp(torch.empty(k, n, device=dev).uniform_(
        math.log(1e-45), math.log(1e-3), generator=gen))
    sign = torch.randint(0, 2, (k, n), device=dev, generator=gen) * 2 - 1
    w = sign * mag
    w[::7] = 0.0
    w[1::7] *= 1e-30
    scales = torch.exp(torch.empty(a, k, device=dev).uniform_(
        math.log(1e-38), 0.0, generator=gen))
    scales[0] = 1.0
    msq = torch.rand(k, generator=gen, device=dev)
    assert bool((w.abs() < 1.1754944e-38).any() & (w != 0).any())
    assert bool((scales < 1.1754944e-38).any())
    for g, sym in [(64, False), (128, True), (32, False)]:
        spec = QuantSpec(4, g, symmetric=sym)
        got = qe.quant_error(w, scales, msq, spec)
        want = qe.quant_error_ref(w, scales, msq, spec)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=0, rtol=1e-5)
    # the division equal to __fdiv_rn wherever the quotient is normal: a
    # subnormal quotient (|ws| / scale < 2^-126, range / denom under the
    # 1e-8 floor) rounds to code 0 or is floored whatever its last bit,
    # which the comparison above holds end to end
    size = 1 << 22

    def log_uniform(lo, hi):
        return torch.exp(torch.empty(size, device=dev).uniform_(
            math.log(lo), math.log(hi), generator=gen))

    def signed(x):
        return x * (torch.randint(0, 2, (size,), device=dev,
                                  generator=gen) * 2 - 1)

    for num, den in [
            # subnormal ws over the floored scale
            (signed(log_uniform(1e-45, 1.1754944e-38)),
             torch.full((size,), 1e-8, device=dev)),
            # near-underflow ws over scales of small groups
            (signed(log_uniform(1e-30, 1e-20)), log_uniform(1e-8, 1.0)),
            # (code - zero) * scale over smoothing scales down to 1e-38
            (signed(log_uniform(1e-8, 1e-6)), log_uniform(1e-38, 1.0))]:
        assert _div_check(num, den)[0] == 0


def _verify_inputs(variant, t, gen, dev, dtype=torch.bfloat16,
                   b=4, h=32, kh=8, s=1024, hd=128, ps=16):
    """q (B, T, H, hd) and the cache arguments of ``variant`` (dense, q8,
    paged or paged_q8), with bases whose bursts cross a 64-position split
    and a 16-position page boundary."""
    q = torch.randn(b, t, h, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, kh, s, hd, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    base = torch.tensor([60, 126, 0, 700][:b], dtype=torch.int32, device=dev)
    perm = (torch.randperm(b * s // ps, generator=gen, device=dev) + 1) \
        .reshape(b, -1).to(torch.int32)
    if variant == "dense":
        return q, (k, v), base
    if variant == "q8":
        return q, (*_q8(k), *_q8(v)), base
    if variant == "paged":
        return q, (_paged(k, ps, perm), _paged(v, ps, perm), perm), base
    return q, (*(_paged(x, ps, perm) for x in (*_q8(k), *_q8(v))), perm), base


_VERIFY = {"dense": (fd.flash_verify, fd.flash_decode, fd.VERIFY,
                     fd.verify_attention_ref),
           "q8": (fd.flash_verify_q8, fd.flash_decode_q8, fd.VERIFY_Q8,
                  fd.verify_attention_q8_ref),
           "paged": (fd.flash_verify_paged, fd.flash_decode_paged,
                     fd.VERIFY_PAGED, fd.paged_verify_attention_ref),
           "paged_q8": (fd.flash_verify_paged_q8, fd.flash_decode_paged_q8,
                        fd.VERIFY_PAGED_Q8,
                        fd.paged_verify_attention_q8_ref)}


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["dense", "q8", "paged", "paged_q8"])
def test_flash_verify_rows_equal_single_position_launches(dev, variant, t,
                                                          window):
    """One launch for the burst; row t has the bits of the decode kernel at
    base + t + 1, and the burst is within bf16 tolerance of the plain
    version."""
    verify, decode, kernel, plain = _VERIFY[variant]
    gen = torch.Generator(device=dev).manual_seed(t)
    q, args, base = _verify_inputs(variant, t, gen, dev)
    before = kernel.launches
    got = verify(q, *args, base, window=window)
    assert kernel.launches == before + 1
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    for i in range(t):
        want = decode(q[:, i:i + 1].contiguous(), *args, base + i + 1,
                      window=window)
        assert torch.equal(got[:, i:i + 1], want), i
    ref = plain(q, *args, base, window=window)
    assert float((got.float() - ref.float()).abs().max()) <= \
        1e-2 * float(ref.float().abs().max())


@pytest.mark.parametrize("variant", ["dense", "q8", "paged", "paged_q8"])
def test_flash_verify_f32_matches_plain(dev, variant):
    verify, _, _, plain = _VERIFY[variant]
    gen = torch.Generator(device=dev).manual_seed(3)
    q, args, base = _verify_inputs(variant, 3, gen, dev, torch.float32, b=3,
                                   h=4, kh=2, s=768, hd=32, ps=8)
    torch.testing.assert_close(verify(q, *args, base),
                               plain(q, *args, base), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [4096, 100, 36])
def test_rms_norm_matches_plain_and_rows_do_not_depend_on_the_batch(
        dev, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(d)
    x = (torch.randn(17 * d + 1, generator=gen, device=dev) * 3).to(dtype)
    w = (torch.rand(d, generator=gen, device=dev) + 0.5).to(dtype)
    rows = x[:16 * d].view(16, d)
    before = rn.KERNEL.launches
    got = rn.rms_norm(rows, w, 1e-5)
    assert rn.KERNEL.launches == before + 1
    want = rn.rms_norm_ref(rows, w, 1e-5)
    tol = (1e-2 * float(want.float().abs().max()) if dtype == torch.bfloat16
           else 1e-5 * max(1.0, float(want.abs().max())))
    assert float((got.float() - want.float()).abs().max()) <= tol
    for i in (0, 5, 15):
        assert torch.equal(rn.rms_norm(rows[i:i + 1], w, 1e-5)[0], got[i])
    assert torch.equal(rn.rms_norm(rows[:4].reshape(2, 2, d), w, 1e-5),
                       got[:4].reshape(2, 2, d))
    # a row at an address that rules out 16-byte loads: the same bits
    shifted = x[1:16 * d + 1].view(16, d)
    shifted.copy_(rows.clone())
    assert torch.equal(rn.rms_norm(shifted, w, 1e-5), got)


@pytest.fixture(scope="module")
def full_width():
    """llama3-8b at full width (d_model 4096, 32 heads, 8 KV heads, d_ff
    14336, vocab 128256) and 2 of its 32 layers, random bf16 weights
    packed to int4 by RTN (g = 64), and 4 prompts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    cfg = ARCHS["llama3-8b"].scaled(n_layers=2)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    qp, _ = quantize_model(params, model.quant_site_map(), None,
                           method="rtn", spec=QuantSpec(4, 64),
                           mode="packed")
    gen = torch.Generator().manual_seed(0)
    plen = torch.tensor([12, 60, 126, 200], dtype=torch.int32)
    tokens = torch.randint(1, 4096, (4, 256), generator=gen).int()
    return cfg, qp, tokens, plen


def _prefilled(cfg, qp, tokens, plen, kv_bits):
    model = build_model(cfg.scaled(kv_cache_bits=kv_bits))
    cache = model.init_cache(4, 512)
    nxt, cache = model.prefill(qp, tokens.cuda(), cache, plen.cuda())
    return model, cache, nxt[:, 0].argmax(-1).int()


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_decode_logits_do_not_depend_on_the_batch(full_width, kv_bits):
    cfg, qp, tokens, plen = full_width
    model, cache, nxt = _prefilled(cfg, qp, tokens, plen, kv_bits)
    logits = {}
    for b in (4, 2, 1):
        sub = {k: (v[:b].clone() if k == "len" else v[:, :b].clone())
               for k, v in cache.items()}
        logits[b], _ = model.decode_step(qp, sub, nxt[:b, None])
    for b in (2, 1):
        assert torch.equal(logits[b], logits[4][:b]), b


def _to_pages(cache, ps):
    """The dense cache's (L, B, KH, S, d) leaves as page stores, layer by
    layer (:func:`_paged`), behind a table that maps slot b's logical page
    j to page 1 + b * NP + j."""
    b, s = cache["k"].shape[1], cache["k"].shape[3]
    table = (1 + torch.arange(b * (s // ps), device="cuda")).reshape(b, -1) \
        .to(torch.int32)
    return {key: torch.stack([_paged(layer, ps, table) for layer in leaf])
            for key, leaf in cache.items() if key != "len"}, table


@pytest.mark.parametrize("kind", ["bf16", "int8", "paged"])
def test_verify_step_equals_sequential_decode_steps(full_width, kind):
    """A 4-token burst scored by verify_step gives the logits of 4
    sequential decode steps from the same cache state, bit for bit (the
    bursts from lengths 12/60/126/200 cross a split and a page)."""
    cfg, qp, tokens, plen = full_width
    model, cache, nxt = _prefilled(cfg, qp, tokens, plen,
                                   8 if kind == "int8" else 16)
    gen = torch.Generator().manual_seed(1)
    burst = torch.cat([nxt[:, None].cpu(), torch.randint(
        1, 4096, (4, 3), generator=gen).int()], dim=1).cuda()
    clone = lambda c: {k: v.clone() for k, v in c.items()}
    before = fd.VERIFY.launches + fd.VERIFY_PAGED.launches \
        + fd.VERIFY_Q8.launches
    if kind == "paged":
        store, table = _to_pages(cache, 16)
        got, _ = model.verify_step_paged(qp, {k: v.clone() for k, v in
                                              store.items()},
                                         burst, table, cache["len"])
        steps = []
        for i in range(4):
            lg, store = model.decode_step_paged(qp, store, burst[:, i:i + 1],
                                                table, cache["len"] + i)
            steps.append(lg)
    else:
        got, after = model.verify_step(qp, clone(cache), burst)
        assert torch.equal(after["len"], cache["len"] + 4)
        steps, c = [], clone(cache)
        for i in range(4):
            lg, c = model.decode_step(qp, c, burst[:, i:i + 1])
            steps.append(lg)
    launched = fd.VERIFY.launches + fd.VERIFY_PAGED.launches \
        + fd.VERIFY_Q8.launches - before
    assert launched == cfg.n_layers       # one verify launch per layer
    assert torch.equal(got, torch.cat(steps, dim=1))


@pytest.mark.parametrize("bucket", [16, 64, 512])
def test_prefill_rows_do_not_depend_on_batch_or_bucket(full_width, bucket):
    """A prompt's prefill (its last logits and its K/V) has the bits of its
    exact-length batch-1 prefill whatever bucket it is padded to and
    whatever batch (1, 2 or 4) it shares: every prefill attention runs the
    length-masked kernel."""
    cfg, qp, tokens, _ = full_width
    model = build_model(cfg)
    lens = [12, 7, 16, 3]
    alone = []
    for i, n in enumerate(lens):
        lg, c = model.prefill(qp, tokens[i:i + 1, :n].cuda(),
                              model.init_cache(1, 512))
        alone.append((lg[0], c["k"][:, 0, :, :n], c["v"][:, 0, :, :n]))
    for b in (1, 2, 4):
        toks = torch.zeros((b, bucket), dtype=torch.int32)
        for i in range(b):
            toks[i, :lens[i]] = tokens[i, :lens[i]]
        lg, c = model.prefill(qp, toks.cuda(), model.init_cache(b, 512),
                              torch.tensor(lens[:b], dtype=torch.int32,
                                           device="cuda"))
        for i in range(b):
            n = lens[i]
            assert torch.equal(lg[i], alone[i][0]), (b, i)
            assert torch.equal(c["k"][:, i, :, :n], alone[i][1]), (b, i)
            assert torch.equal(c["v"][:, i, :, :n], alone[i][2]), (b, i)


# ---------------------------------------------------------------------------
# Backward kernels: flash_attention_bwd.cu and rms_norm.cu's backward
# ---------------------------------------------------------------------------

def _grad_close(got, want):
    """bf16: the forward's limits (max error 1e-2 * max|plain| and ||error||
    <= 1e-2 * ||plain||); f32: max error 1e-4 * max(1, max|plain|)."""
    if want.dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


def _attention_inputs(dev, g, t, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(2, g, t, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(2, t, hd, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    dout = torch.randn(2, g, t, hd, generator=gen, device=dev).to(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t", [16, 64, 512])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_attention_bwd_matches_plain(dev, g, t, hd, dtype):
    """Autograd through flash_attention launches the backward kernel once;
    dq, dk, dv against flash_attention_bwd_ref; a second backward gives
    the same bits (no atomics)."""
    q, k, v, dout = _attention_inputs(dev, g, t, hd, dtype, g * t + hd)
    want = fa.flash_attention_bwd_ref(q, k, v, dout)
    grads = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fa.KERNEL_BWD.launches
        out = fa.flash_attention(*leaves)
        grads.append(torch.autograd.grad(out, leaves, dout))
        assert fa.KERNEL_BWD.launches == before + 1
    for got, ref in zip(grads[0], want):
        assert got.dtype == dtype
        _grad_close(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [37, 200])
def test_flash_attention_bwd_odd_shapes(dev, t, causal):
    """T off the 32-row tile, hd 36 (not a multiple of 32), causal or not."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, dout = _attention_inputs(dev, 3, t, 36, dtype, t)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(fa.flash_attention(*leaves, causal=causal),
                                  leaves, dout)
        for a, b in zip(got, fa.flash_attention_bwd_ref(q, k, v, dout,
                                                        causal=causal)):
            _grad_close(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_forward_bits_do_not_depend_on_grad_mode(dev, dtype):
    q, k, v, _ = _attention_inputs(dev, 4, 512, 128, dtype, 3)
    plain = fa.flash_attention(q, k, v)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    assert torch.equal(fa.flash_attention(*leaves).detach(), plain)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(*leaves), plain)


def test_flash_attention_refuses_kv_lens_under_grad(dev):
    q, k, v, _ = _attention_inputs(dev, 1, 16, 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="kv_lens"):
        fa.flash_attention(q.requires_grad_(), k, v,
                           kv_lens=torch.tensor([16, 16], device=dev))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(2048, 4096), (37, 100), (5, 36)])
def test_rms_norm_bwd_matches_plain(dev, rows, d, dtype):
    """dx and dw against rms_norm_bwd_ref, the same bits twice; the forward
    under grad gives the no-grad forward's bits."""
    gen = torch.Generator(device=dev).manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=gen, device=dev) * 3).to(dtype)
    w = torch.randn(d, generator=gen, device=dev).to(dtype)
    dy = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
    want = rn.rms_norm_bwd_ref(x, w, dy, 1e-5)
    grads = []
    for _ in range(2):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = rn.KERNEL_BWD.launches
        out = rn.rms_norm(xl, wl, 1e-5)
        assert torch.equal(out.detach(), rn.rms_norm(x, w, 1e-5))
        grads.append(torch.autograd.grad(out, (xl, wl), dy))
        assert rn.KERNEL_BWD.launches == before + 1
    for got, ref in zip(grads[0], want):
        assert got.dtype == dtype
        if dtype == torch.bfloat16:
            _bf16_close(got, ref)
        else:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


class _PlainKernels:
    """The model's attention and rms_norm swapped for their plain versions
    (autograd through plain PyTorch) for the duration of a with-block."""

    def __init__(self, monkeypatch):
        from repro_torch.models import common, dense
        monkeypatch.setattr(common, "flash_attention",
                            lambda q, k, v, causal=True, kv_lens=None:
                            fa.flash_attention_ref(q, k, v, causal=causal,
                                                   kv_lens=kv_lens))
        monkeypatch.setattr(common, "rms_norm", rn.rms_norm_ref)
        monkeypatch.setattr(dense, "rms_norm", rn.rms_norm_ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_train_step_on_the_card(dev, dtype, monkeypatch):
    """One make_train_step step of the tiny llama3-8b on the card: both
    backward kernels launch, every gradient is non-zero, and each leaf's
    gradient is within a relative norm of 1e-4 (f32) / 5e-2 (bf16) of the
    same step through the plain versions."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.dist._tree import leaves_with_keys
    from repro_torch.train.trainer import make_loss_fn, value_and_grad

    cfg = ARCHS["llama3-8b"].tiny().scaled(dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(0, 4, 64).items()}
    loss_fn = make_loss_fn(model, 0.0)
    counts = (fa.KERNEL_BWD.launches, rn.KERNEL_BWD.launches)
    (loss, _), grads = value_and_grad(loss_fn, params, batch)
    assert fa.KERNEL_BWD.launches == counts[0] + cfg.n_layers
    assert rn.KERNEL_BWD.launches == counts[1] + 2 * cfg.n_layers + 1
    with monkeypatch.context() as mp:
        _PlainKernels(mp)
        (plain_loss, _), plain = value_and_grad(loss_fn, params, batch)
    plain = dict(leaves_with_keys(plain))
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert abs(float(loss) - float(plain_loss)) <= tol * float(plain_loss)
    for key, g in leaves_with_keys(grads):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), key
        rel = float((g.float() - plain[key].float()).norm()
                    / plain[key].float().norm())
        assert rel <= tol, (key, rel)
