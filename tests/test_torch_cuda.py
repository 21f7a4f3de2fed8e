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

Training: the backward kernels (flash_attention's bf16 tensor-core and
f32 CUDA-core routes, rms_norm's) are held to their plain versions with
the forward's limits, launch once per backward and give the same bits on
a second call; flash_attention's at T off the 64-row tile, hd 36 / 64 /
128, G 1 / 3 / 4 / 8 / 16, causal or not, unaligned bases, T 4096 and
from a thread that has made no CUDA call yet.

The ssm and audio families: flash_attention not causal at G 1 / hd 64 up
to T 1536 (whisper's encoder), flash_decode at G 1 / hd 64 over a self
cache and a full 1536-key cross cache, quant_matmul at their seven site
widths (rows independent of m), xLSTM's four float decode products and
its decode logits at B 1 / 2 / 4 bit for bit, the tiny models on the
card against the CPU and xLSTM's engine == ``generate``.

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


# d: the scalar path (36, 100), the warp route's widths (one logical warp at
# 128, 4 at 1024, 8 at 1536 / 1600 / 2048, two chunks a lane at 4096 bf16)
# and the block route's (4096 f32, 5120, 16384); 16 rows take the block
# route, 2048 the warp route where the row fits it
@pytest.mark.parametrize("n", [16, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [4096, 100, 36, 128, 1024, 1536, 1600, 2048,
                               5120, 16384])
def test_rms_norm_matches_plain_and_rows_do_not_depend_on_the_batch(
        dev, d, dtype, n):
    gen = torch.Generator(device=dev).manual_seed(d)
    x = (torch.randn((n + 1) * d + 1, generator=gen, device=dev) * 3).to(dtype)
    w = (torch.rand(d, generator=gen, device=dev) + 0.5).to(dtype)
    rows = x[:n * d].view(n, d)
    before = rn.KERNEL.launches
    got = rn.rms_norm(rows, w, 1e-5)
    assert rn.KERNEL.launches == before + 1
    want = rn.rms_norm_ref(rows, w, 1e-5)
    tol = (1e-2 * float(want.float().abs().max()) if dtype == torch.bfloat16
           else 1e-5 * max(1.0, float(want.abs().max())))
    assert float((got.float() - want.float()).abs().max()) <= tol
    for i in (0, 5, n - 1):
        assert torch.equal(rn.rms_norm(rows[i:i + 1], w, 1e-5)[0], got[i])
    assert torch.equal(rn.rms_norm(rows[:4].reshape(2, 2, d), w, 1e-5),
                       got[:4].reshape(2, 2, d))
    # a row at an address that rules out 16-byte loads: the same bits
    shifted = x[1:n * d + 1].view(n, d)
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


def _attention_inputs(dev, g, t, hd, dtype, seed, bkh=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(bkh, g, t, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(bkh, t, hd, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    dout = torch.randn(bkh, g, t, hd, generator=gen, device=dev).to(dtype)
    return q, k, v, dout


def _bwd_held(q, k, v, dout, causal=True):
    """Two backwards through autograd, one KERNEL_BWD launch each: dq, dk,
    dv against flash_attention_bwd_ref (:func:`_grad_close`), and the
    second gives the first's bits (no atomics)."""
    want = fa.flash_attention_bwd_ref(q, k, v, dout, causal=causal)
    grads = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fa.KERNEL_BWD.launches
        out = fa.flash_attention(*leaves, causal=causal)
        grads.append(torch.autograd.grad(out, leaves, dout))
        assert fa.KERNEL_BWD.launches == before + 1
    for got, ref in zip(grads[0], want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _grad_close(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [36, 64, 128])
@pytest.mark.parametrize("t", [16, 37, 64, 200, 512, 1000])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_flash_attention_bwd_matches_plain(dev, g, t, hd, causal, dtype):
    """Autograd through flash_attention launches the backward kernel once;
    dq, dk, dv against flash_attention_bwd_ref; a second backward gives
    the same bits (no atomics).  For the bf16 (wgmma) route's edges: T off
    the 64-row tile (rows and keys past T masked), hd 36 (zero-padded to
    40), 64 and 128 (its two tile widths), G folded into the dQ block's
    rows (64, 16 and 8 positions per block), causal and not."""
    _bwd_held(*_attention_inputs(dev, g, t, hd, dtype, g * t + hd),
              causal=causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [37, 200, 1000])
def test_flash_attention_bwd_odd_shapes(dev, t, causal):
    """T off the 32- and 64-row tiles, hd 36 (not a multiple of 32; bf16
    zero-pads it to 40), G 3, causal or not, both routes."""
    for dtype in (torch.bfloat16, torch.float32):
        _bwd_held(*_attention_inputs(dev, 3, t, 36, dtype, t), causal=causal)


def _unaligned(x):
    """x's values in a view whose base is 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 2
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bwd_unaligned_base(dev, hd, causal):
    """bf16 operands whose bases TMA cannot describe: the wrapper pads them
    (one launch), and the gradients equal those of aligned copies bit for
    bit."""
    q, k, v, dout = _attention_inputs(dev, 4, 200, hd, torch.bfloat16, hd)
    out, lse = fa._forward(q, k, v, causal, None, with_lse=True)
    want = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    before = fa.KERNEL_BWD.launches
    got = fa.flash_attention_bwd(*(_unaligned(x) for x in (q, k, v, out)),
                                 lse, _unaligned(dout), causal=causal)
    assert fa.KERNEL_BWD.launches == before + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(want, fa.flash_attention_bwd_ref(q, k, v, dout,
                                                     causal=causal)):
        _grad_close(a, b)


def test_flash_attention_launches_from_a_fresh_thread(dev):
    """The bf16 kernels encode TMA tensor maps by cuTensorMapEncodeTiled,
    which needs the thread's context current: a thread that has made no CUDA
    call yet (as an autograd worker may be) still launches both passes."""
    import threading

    q, k, v, dout = _attention_inputs(dev, 4, 200, 128, torch.bfloat16, 5)
    want = fa.flash_attention_bwd_ref(q, k, v, dout)
    got = {}

    def run():
        out, lse = fa._forward(q, k, v, True, None, with_lse=True)
        got["grads"] = fa.flash_attention_bwd(q, k, v, out, lse, dout)

    for _ in range(2):
        worker = threading.Thread(target=run)
        worker.start()
        worker.join()
        for a, b in zip(got.pop("grads"), want):
            _grad_close(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_sixteen_heads_per_kv_head(dev, causal):
    """G 16 (llama3-405b: 128 heads on 8 KV heads): the dQ pass splits the
    grouped heads over two blocks of 8, the dK/dV pass walks all 16."""
    _bwd_held(*_attention_inputs(dev, 16, 200, 128, torch.bfloat16, 16),
              causal=causal)


def test_flash_attention_bwd_one_kv_head_at_4096(dev):
    """One KV head of 4 query heads at the reference's training length
    (T 4096, hd 128, bf16, causal): 64 key blocks walk up to 64 query tiles
    of each head."""
    _bwd_held(*_attention_inputs(dev, 4, 4096, 128, torch.bfloat16, 4096,
                                 bkh=1))


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
@pytest.mark.parametrize("rows,d", [(2048, 4096), (37, 100), (5, 36),
                                    (1, 14336), (8192, 14336)])
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


def test_rms_norm_bwd_refuses_rows_past_its_width(dev):
    """Rows wider than MAX_BWD_WIDTH raise; nothing falls back."""
    d = rn.MAX_BWD_WIDTH + 8
    x = torch.ones(2, d, device=dev)
    with pytest.raises(ValueError, match="exceed"):
        rn.rms_norm_bwd(x, torch.ones(d, device=dev), x)


class _PlainKernels:
    """The models' attention and rms_norm swapped for their plain versions
    (autograd through plain PyTorch) for the duration of a with-block, in
    every model module that imported rms_norm."""

    def __init__(self, monkeypatch):
        from repro_torch.models import (common, dense, hymba, moe, ssm, vlm,
                                        xlstm)
        monkeypatch.setattr(common, "flash_attention",
                            lambda q, k, v, causal=True, kv_lens=None:
                            fa.flash_attention_ref(q, k, v, causal=causal,
                                                   kv_lens=kv_lens))
        for mod in (common, dense, hymba, moe, ssm, vlm, xlstm):
            if hasattr(mod, "rms_norm"):
                monkeypatch.setattr(mod, "rms_norm", rn.rms_norm_ref)


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


# -- the families' training routes and train steps ---------------------------

# (KV heads, G, T, hd, causal) of the families' attention backward at B 2:
# qwen2-vl-2b's 12 / 2 heads, whisper-small's decoder and encoder, qwen2-moe
# -a2.7b's 16 heads
FAMILY_BWD = [(2, 6, 512, 128, True), (12, 1, 256, 64, True),
              (12, 1, 1536, 64, False), (16, 1, 512, 128, True)]


@pytest.mark.parametrize("kh,g,t,hd,causal", FAMILY_BWD,
                         ids=["vlm_g6", "whisper_g1", "whisper_noncausal_g1",
                              "moe_g1"])
def test_flash_attention_bwd_family_routes(dev, kh, g, t, hd, causal):
    """The families' backward routes in bf16 (B 2): dq, dk, dv against the
    plain version, the same bits twice, and each of 2 ranks' launch on its
    half of the KV heads (model 2) bit for bit against its heads of the
    whole launch."""
    b = 2
    q, k, v, dout = _attention_inputs(dev, g, t, hd, torch.bfloat16,
                                      kh * g + t, bkh=b * kh)
    _bwd_held(q, k, v, dout, causal=causal)
    o, lse = fa._forward(q, k, v, causal, None, with_lse=True)
    whole = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal)
    half = kh // 2

    def heads(w, r):
        return w.reshape(b, kh, *w.shape[1:])[:, r * half:(r + 1) * half] \
            .reshape(b * half, *w.shape[1:]).contiguous()

    for r in range(2):
        qr, kr, vr, dr = (heads(w, r) for w in (q, k, v, dout))
        o_r, lse_r = fa._forward(qr, kr, vr, causal, None, with_lse=True)
        got = fa.flash_attention_bwd(qr, kr, vr, o_r, lse_r, dr,
                                     causal=causal)
        for a, full in zip(got, whole):
            assert torch.equal(a, heads(full, r))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [1536, 1600, 1024, 2048])
def test_rms_norm_family_widths(dev, d, dtype):
    """rms_norm forward and backward at the families' widths (qwen2-vl-2b,
    hymba-1.5b, xlstm-350m, qwen2-moe-a2.7b; xlstm's mLSTM / sLSTM output
    norms at 2048 / 1024 in f32) over 2048 rows against the plain
    versions; the backward twice gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(d)
    x = (torch.randn(2048, d, generator=gen, device=dev) * 3).to(dtype)
    w = torch.randn(d, generator=gen, device=dev).to(dtype)
    dy = torch.randn(2048, d, generator=gen, device=dev).to(dtype)
    close = (_bf16_close if dtype == torch.bfloat16 else
             lambda a, b: torch.testing.assert_close(a, b, atol=1e-4,
                                                     rtol=1e-4))
    close(rn.rms_norm(x, w, 1e-5), rn.rms_norm_ref(x, w, 1e-5))
    got = rn.rms_norm_bwd(x, w, dy, 1e-5)
    for a, b in zip(got, rn.rms_norm_bwd_ref(x, w, dy, 1e-5)):
        close(a, b)
    assert all(torch.equal(a, b) for a, b in
               zip(got, rn.rms_norm_bwd(x, w, dy, 1e-5)))


# the kernels each family's train step launches (hymba's windowed attention
# and whisper's cross attention run plain PyTorch; whisper has no rms_norm)
FAMILY_TRAIN_KERNELS = {
    "qwen2-vl-2b": (fa.KERNEL, fa.KERNEL_BWD, rn.KERNEL, rn.KERNEL_BWD),
    "hymba-1.5b": (rn.KERNEL, rn.KERNEL_BWD),
    "xlstm-350m": (rn.KERNEL, rn.KERNEL_BWD),
    "whisper-small": (fa.KERNEL, fa.KERNEL_BWD),
    "qwen2-moe-a2.7b": (fa.KERNEL, fa.KERNEL_BWD, rn.KERNEL,
                        rn.KERNEL_BWD)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(FAMILY_TRAIN_KERNELS))
def test_family_train_step_on_the_card(dev, arch, dtype, monkeypatch):
    """One family's value_and_grad of the train loss at tiny width, 2
    layers (xlstm 4: its sLSTM block is layer 3), on the card: the
    family's kernels launch, every gradient is finite and non-zero, and
    each leaf is within a relative norm of 1e-4 (f32) / 5e-2 (bf16) of the
    same step through the plain versions (MoE: on the kernel run's expert
    choices)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.dist._tree import leaves_with_keys
    from repro_torch.models import moe
    from repro_torch.train.trainer import make_loss_fn, value_and_grad

    cfg = ARCHS[arch].tiny()
    cfg = cfg.scaled(dtype=dtype, moe_capacity_factor=16.0,
                     n_layers=4 if cfg.family == "ssm" else 2)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(0, 4, 64).items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    extra = {"vlm": ("patches", cfg.patch_len),
             "audio": ("frames", cfg.encoder_len)}.get(cfg.family)
    if extra is not None:
        batch[extra[0]] = torch.randn((4, extra[1], cfg.d_model),
                                      generator=gen, device=dev)
    loss_fn = make_loss_fn(model, 0.01)
    before = [k.launches for k in FAMILY_TRAIN_KERNELS[arch]]
    # the plain run takes the kernel run's expert choices: a bf16 router
    # near a tie picks another expert for another rounding of its input
    routes = []
    route = moe._route

    def recorded(x, w, n_real, k):
        out = route(x, w, n_real, k)
        routes.append(out[1])
        return out

    def replayed(x, w, n_real, k):
        _, _, aux = route(x, w, n_real, k)
        topi = routes.pop(0)
        logits = (x @ w.to(x.dtype)).float()
        return torch.softmax(logits.gather(1, topi), dim=-1), topi, aux

    with monkeypatch.context() as mp:
        mp.setattr(moe, "_route", recorded)
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
    for kern, n in zip(FAMILY_TRAIN_KERNELS[arch], before):
        assert kern.launches > n, kern.symbol
    with monkeypatch.context() as mp:
        _PlainKernels(mp)
        mp.setattr(moe, "_route", replayed)
        (plain_loss, _), plain = value_and_grad(loss_fn, params, batch)
    plain = dict(leaves_with_keys(plain))
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert abs(float(loss) - float(plain_loss)) <= tol * float(plain_loss)
    for key, g in leaves_with_keys(grads):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), key
        rel = float((g.float() - plain[key].float()).norm()
                    / plain[key].float().norm())
        assert rel <= tol, (key, rel)


# -- MoE: quant_matmul_experts (one grouped launch) ---------------------------

@pytest.mark.parametrize("act", [False, True], ids=["plain", "act_scale"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048), (128, 96)])
@pytest.mark.parametrize("c", [1, 8, 43, 683])
@pytest.mark.parametrize("e", [1, 16, 64])
def test_quant_matmul_experts_matches_plain_and_single_launches(
        dev, e, c, k, n, dtype, act):
    """quant_matmul_experts against its plain version (the per-expert
    plain product); bf16: one launch of the grouped kernel whose expert
    rows equal single-expert launches on the same operands bit for bit,
    and the same bits on a second call; f32: the f32 launch per expert."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import quant_matmul_experts_ref

    gen = torch.Generator(device=dev).manual_seed(e * 1000 + c + k + n)
    act_scale = (torch.rand((e, k), generator=gen, device=dev) + 0.5
                 if act else None)
    qt = quantize_groupwise(torch.randn((e, k, n), generator=gen, device=dev),
                            QuantSpec(4, 64), act_scale=act_scale, pack=True)
    x = (torch.randn((e, c, k), generator=gen, device=dev) / 8).to(dtype)
    before = (qm.KERNEL_EXPERTS.launches, qm.KERNEL.launches)
    got = ops.quant_matmul_experts(x, qt)
    want = quant_matmul_experts_ref(x, qt)
    assert got.shape == (e, c, n) and got.dtype == dtype
    if dtype == torch.float32:
        assert qm.KERNEL.launches == before[1] + e
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        return
    assert qm.KERNEL_EXPERTS.launches == before[0] + 1
    assert qm.KERNEL.launches == before[1]
    _bf16_close(got, want, rel_tol=EXACT_REL_TOL)
    assert torch.equal(ops.quant_matmul_experts(x, qt), got)
    xs = x if act_scale is None else x / act_scale[:, None, :].to(dtype)
    for i in range(e):
        one = qm.quant_matmul(xs[i].contiguous(), qt.codes[i], qt.scale[i],
                              qt.zero[i])
        assert torch.equal(one, got[i]), i


def test_moe_tiny_forward_on_the_card(dev):
    """The tiny qwen2-moe in f32 on the card (kernels) against the same
    packed weights on the CPU (plain versions): logits and moe_aux within
    1e-4 (f32 sums in another order)."""
    from repro_torch.bridge import tree_to
    from repro_torch.core import run_calibration

    cfg = ARCHS["qwen2-moe-a2.7b"].tiny()
    model = build_model(cfg)
    cpu = torch.device("cpu")
    params = model.init(0, device=cpu)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    stats = run_calibration(model.forward, params, [{"tokens": tokens}])
    qp, _ = quantize_model(params, model.quant_site_map(), stats,
                           method="faq", spec=QuantSpec(4, 64), mode="packed")
    want, want_aux = model.forward(qp, {"tokens": tokens})
    got, got_aux = model.forward(tree_to(qp, dev), {"tokens": tokens.to(dev)})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert abs(float(got_aux["moe_aux"]) - float(want_aux["moe_aux"])) <= 1e-5


@pytest.mark.parametrize("t", [1, 3, 512])
def test_moe_ffn_bf16_kernels_against_plain(dev, t):
    """One bf16 MoE FFN at qwen2-moe's full width (d 2048, 64 padded
    experts, top-4, d_ff 1408), int4 experts, on the card: the grouped
    launch (one per projection) against the plain per-expert product on
    the same input, so the routing is the same; output within a relative
    norm of 1e-2 (the expert outputs round to bf16 after another f32
    summation order), and the same bits on a second call."""
    from repro_torch.kernels.ref import quant_matmul_experts_ref
    from repro_torch.models import moe

    cfg = ARCHS["qwen2-moe-a2.7b"]
    gen = torch.Generator(device=dev).manual_seed(t)
    e_pad, d, f = 64, cfg.d_model, cfg.d_ff
    router = (torch.randn((d, e_pad), generator=gen, device=dev)
              / d ** 0.5).bfloat16()
    ws = [quantize_groupwise(torch.randn(shape, generator=gen, device=dev)
                             / shape[1] ** 0.5, QuantSpec(4, 64), pack=True)
          for shape in ((e_pad, d, f), (e_pad, d, f), (e_pad, f, d))]
    x = torch.randn((2, t, d), generator=gen, device=dev).bfloat16()
    before = qm.KERNEL_EXPERTS.launches
    got, aux, _ = moe.moe_ffn_local(x, router, *ws, cfg)
    assert qm.KERNEL_EXPERTS.launches == before + 3
    again, _, _ = moe.moe_ffn_local(x, router, *ws, cfg)
    assert torch.equal(got, again)
    saved = moe.quant_matmul_experts
    moe.quant_matmul_experts = quant_matmul_experts_ref
    try:
        want, want_aux, _ = moe.moe_ffn_local(x, router, *ws, cfg)
    finally:
        moe.quant_matmul_experts = saved
    assert torch.equal(aux, want_aux)
    _bf16_close(got, want)


def test_moe_spec_equals_plain_at_one_slot_on_the_card(dev):
    """The tiny qwen2-moe in bf16, int4 packed, on the card: the self-int8
    speculative serve gives the plain serve's tokens bit for bit at one
    slot (the verify span routes each position alone, and every kernel on
    the path gives a row the bits of the T = 1 step)."""
    from repro_torch.core import run_calibration
    from repro_torch.serve.draft import self_int8_draft
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import SpecConfig

    cfg = ARCHS["qwen2-moe-a2.7b"].tiny().scaled(dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    stats = run_calibration(model.forward, params, [{"tokens": tokens}])
    qp, _ = quantize_model(params, model.quant_site_map(), stats,
                           method="faq", spec=QuantSpec(4, 64), mode="packed")
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
               for n in (5, 17, 30)]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]

    plain = ServeEngine(model, qp, n_slots=1, max_len=64).serve(reqs())
    eng = ServeEngine(model, qp, n_slots=1, max_len=64, spec=SpecConfig(
        k=3, draft=self_int8_draft(model, qp, stats)))
    spec = eng.serve(reqs())
    assert eng.metrics()["spec_cycles"] > 0
    for i in plain:
        assert torch.equal(torch.as_tensor(spec[i]),
                           torch.as_tensor(plain[i])), i


# -- the VLM and hybrid families (qwen2-vl-2b, hymba-1.5b) -------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,kh,hd,s,lens", [
    (25, 5, 64, 1024, [1024, 1024, 332, 44]),    # hymba: two slots wrapped
    (25, 5, 64, 1024, [1024, 1, 0, 700]),
    (12, 2, 128, 1024, [44, 140, 332, 732]),     # qwen2-vl
    (12, 2, 128, 300, [0, 1, 300, 129])])
def test_flash_decode_ring_g5_and_g6_match_plain(dev, h, kh, hd, s, lens,
                                                 dtype):
    """G 5 at hd 64 over a 1024-slot ring (valid = min(len, W)) and G 6 at
    hd 128, against the plain version; a slot's bits do not depend on the
    batch."""
    gen = torch.Generator(device=dev).manual_seed(h * 1000 + s + lens[-1])
    q = torch.randn(4, 1, h, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(4, kh, s, hd, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = fd.KERNEL.launches
    got = fd.flash_decode(q, k, v, cl)
    assert fd.KERNEL.launches == before + 1
    want = fd.decode_attention_ref(q, k, v, cl)
    if dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    alone = torch.cat([fd.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                       cl[i:i + 1]) for i in range(4)])
    assert torch.equal(alone, got)


@pytest.mark.parametrize("n_pos", [700, 1024, 1300, 2231])
def test_flash_decode_over_a_wrapped_ring_equals_the_window(dev, n_pos):
    """hymba's ring: positions 0..n-1 stored at slot pos % 1024, attended
    at valid = min(n, 1024), give the last-1024-positions window of the
    linear cache (f32: the same terms summed in another order)."""
    w, h, kh, hd = 1024, 25, 5, 64
    gen = torch.Generator(device=dev).manual_seed(n_pos)
    q = torch.randn(2, 1, h, hd, generator=gen, device=dev)
    lin = [torch.randn(2, kh, n_pos, hd, generator=gen, device=dev)
           for _ in range(2)]
    ring = [torch.zeros(2, kh, w, hd, device=dev) for _ in range(2)]
    slots = torch.arange(n_pos, device=dev) % w
    for r, x in zip(ring, lin):
        r[:, :, slots[-w:]] = x[:, :, -w:]
    valid = torch.full((2,), min(n_pos, w), dtype=torch.int32, device=dev)
    got = fd.flash_decode(q, *ring, valid)
    want = fd.decode_attention_ref(q, *lin, torch.full_like(valid, n_pos),
                                   window=w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [37, 371, 512, 513])
def test_flash_attention_vlm_g6_hd128_matches_plain(dev, t, dtype):
    """qwen2-vl's 6 query heads per KV head at hd 128: 6 of the block's 8
    head rows used; T 512 (calibration: 256 patches + 256 tokens) and odd
    T (a prefill of 256 patches + 115 tokens)."""
    gen = torch.Generator(device=dev).manual_seed(t)
    q = torch.randn(4, 6, t, 128, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(4, t, 128, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v)
    assert fa.KERNEL.launches == before + 1
    want = fa.flash_attention_ref(q, k, v)
    if dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 16, 8192])
def test_quant_matmul_hymba_x_proj_width(dev, m):
    """hymba's x_proj: k 3200 -> n 132 (padded to 144), g 64; a row's bits
    are those of the 8192-row call."""
    gen = torch.Generator(device=dev).manual_seed(3200 + m)
    codes, scale, zero = _packed(3200, 132, 64, gen)
    x = torch.randn(8192, 3200, generator=gen, device=dev).bfloat16()
    full = qm.quant_matmul(x, codes, scale, zero)
    got = qm.quant_matmul(x[:m].contiguous(), codes, scale, zero)
    assert got.shape == (m, 132)
    _bf16_close(got, qm.quant_matmul_ref(x[:m], codes, scale, zero),
                rel_tol=EXACT_REL_TOL)
    assert torch.equal(got, full[:m])


def _family_setup(arch, dtype, dev_params):
    """A tiny model of ``arch`` in ``dtype``, FAQ-packed on the CPU, and a
    calibration batch (patches for the VLM)."""
    from repro_torch.bridge import tree_to
    from repro_torch.core import run_calibration

    cfg = ARCHS[arch].tiny().scaled(dtype=dtype)
    model = build_model(cfg)
    cpu = torch.device("cpu")
    params = model.init(0, device=cpu)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.patch_len, cfg.d_model,
                                       generator=gen) * 0.1
    stats = run_calibration(model.forward, params, [batch])
    qp, _ = quantize_model(params, model.quant_site_map(), stats,
                           method="faq", spec=QuantSpec(4, 64), mode="packed")
    return cfg, model, qp, tree_to(qp, dev_params), batch


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hymba-1.5b"])
def test_vlm_and_hymba_tiny_forward_and_decode_on_the_card(dev, arch):
    """The tiny model in f32 on the card (kernels) against the same packed
    weights on the CPU (plain versions), within 1e-4: the forward (hymba
    at T 40 > 2 x its window of 16: block-local; the VLM with patches),
    then prefill and 20 decode steps (hymba's ring wraps)."""
    cfg, model, qp, qd, batch = _family_setup(arch, "float32", dev)
    want = model.forward(qp, batch)[0]
    got = model.forward(qd, {k: v.to(dev) for k, v in batch.items()})[0]
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    kw = {} if cfg.family != "vlm" else {"patches": batch["patches"][:, :3]}
    toks = batch["tokens"][:, :20]
    out = []
    for device, params in ((torch.device("cpu"), qp), (dev, qd)):
        cache = model.init_cache(2, 64, device=device)
        logits, cache = model.prefill(params, toks.to(device), cache,
                                      **{k: v.to(device)
                                         for k, v in kw.items()})
        seq = [logits.float().cpu()]
        for i in range(20):
            nxt = batch["tokens"][:, 20 + i:21 + i].int().to(device)
            logits, cache = model.decode_step(params, cache, nxt)
            seq.append(logits.float().cpu())
        out.append(torch.cat(seq, 1))
    torch.testing.assert_close(out[1], out[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hymba-1.5b"])
def test_vlm_and_hymba_engine_equals_generate_on_the_card(dev, arch):
    """bf16 on the card at 4 slots: every request's tokens equal batch-1
    ``generate`` bit for bit (exact-length admission, decode rows that do
    not depend on the batch: hymba's float dt_proj in fixed row blocks)."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, model, _, qd, _ = _family_setup(arch, "bfloat16", dev)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
               for n in (5, 30, 17, 50, 9, 3)]
    eng = ServeEngine(model, qd, n_slots=4, max_len=96, device=dev)
    res = eng.serve([Request(rid=i, prompt=p, max_new_tokens=12)
                     for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        alone = eng.generate(Request(rid=10 + i, prompt=p, max_new_tokens=12))
        assert torch.equal(torch.as_tensor(res[i]), torch.as_tensor(alone)), i


# -- the ssm and audio families (xlstm-350m, whisper-small) -----------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [37, 512, 1536])
def test_flash_attention_whisper_noncausal_g1_hd64_matches_plain(dev, t,
                                                                 dtype):
    """whisper's encoder self-attention: MHA (G 1), hd 64, not causal, T up
    to its 1536 frames; one launch, counted under its route, the same bits
    twice."""
    gen = torch.Generator(device=dev).manual_seed(t + 64)
    q = torch.randn(6, 1, t, 64, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(6, t, 64, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    before = fa.KERNEL.launches
    routed = fa.KERNEL.routes["G1 hd64 not causal"]
    got = fa.flash_attention(q, k, v, causal=False)
    assert fa.KERNEL.launches == before + 1
    assert fa.KERNEL.routes["G1 hd64 not causal"] == routed + 1
    want = fa.flash_attention_ref(q, k, v, causal=False)
    if dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(fa.flash_attention(q, k, v, causal=False), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,lens", [
    (132, [13, 100, 131, 1]),                    # self-attention decode
    (1536, [1536, 1536, 1536, 1536])])           # cross-attention
def test_flash_decode_whisper_g1_hd64_matches_plain(dev, s, lens, dtype):
    """whisper's decode attention at G 1 (12 heads, 12 KV heads), hd 64: the
    self cache at mixed lengths and the cross cache over all 1536 encoder
    keys; one launch, counted under its route, the same bits twice, a
    slot's bits whatever else is in the batch."""
    gen = torch.Generator(device=dev).manual_seed(s + lens[0])
    q = torch.randn(4, 1, 12, 64, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(4, 12, s, 64, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = fd.KERNEL.launches
    routed = fd.KERNEL.routes[f"G1 hd64 S{s}"]
    got = fd.flash_decode(q, k, v, cl)
    assert fd.KERNEL.launches == before + 1
    assert fd.KERNEL.routes[f"G1 hd64 S{s}"] == routed + 1
    want = fd.decode_attention_ref(q, k, v, cl)
    if dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(fd.flash_decode(q, k, v, cl), got)
    alone = torch.cat([fd.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                       cl[i:i + 1]) for i in range(4)])
    assert torch.equal(alone, got)
    pair = fd.flash_decode(q[2:], k[2:], v[2:], cl[2:])
    assert torch.equal(pair, got[2:])


# the new (k, n) site widths: xlstm's up_proj / w_in, wq / wk / wv,
# down_proj, out_proj; whisper's attention, w1, w2
@pytest.mark.parametrize("k,n", [(1024, 4096), (2048, 2048), (2048, 1024),
                                 (1024, 1024), (768, 768), (768, 3072),
                                 (3072, 768)])
def test_quant_matmul_ssm_and_audio_widths(dev, k, n):
    """g 64 at decode m 1..4 and at calibration m (8192 rows: 16 x 512),
    against the plain version; a row's bits are those of the 8192-row
    call."""
    gen = torch.Generator(device=dev).manual_seed(k * 7 + n)
    codes, scale, zero = _packed(k, n, 64, gen)
    x = torch.randn(8192, k, generator=gen, device=dev).bfloat16()
    before = qm.KERNEL.launches
    full = qm.quant_matmul(x, codes, scale, zero)
    assert qm.KERNEL.launches == before + 1
    _bf16_close(full, qm.quant_matmul_ref(x, codes, scale, zero),
                rel_tol=EXACT_REL_TOL)
    for m in (1, 2, 3, 4):
        got = qm.quant_matmul(x[:m].contiguous(), codes, scale, zero)
        _bf16_close(got, qm.quant_matmul_ref(x[:m], codes, scale, zero),
                    rel_tol=EXACT_REL_TOL)
        assert torch.equal(got, full[:m]), m


def _rows_of_batch_1(fn, *xs):
    """fn at B 4, its first two rows at B 2 and each row alone: equal bits."""
    full = fn(*xs)
    assert torch.equal(fn(*(x[:2] for x in xs)), full[:2])
    for i in range(4):
        assert torch.equal(fn(*(x[i:i + 1].clone() for x in xs)),
                           full[i:i + 1]), i
    return full


def test_xlstm_float_products_do_not_depend_on_the_batch(dev):
    """The four float products of an xLSTM decode step at full width
    (d_inner 2048, 4 heads: mLSTM head 512, sLSTM head 256), each at B 1 /
    2 / 4 bit for bit: the gates ``xi @ w_gates`` (2048 -> 8, bf16, fixed
    row blocks), the mLSTM read-out ``bhd,bhde->bhe`` and normaliser
    ``bhd,bhd->bh`` (f32, one slot at a time) and the sLSTM recurrence
    ``bhd,ghde->bghe`` (f32, fixed row blocks)."""
    from repro_torch.models import ssm

    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    w_gates = (rnd(2048, 8) * 0.01).bfloat16()
    _rows_of_batch_1(lambda x: ssm._float_linear(x, w_gates),
                     rnd(4, 1, 2048).bfloat16())
    q, n = rnd(4, 4, 512), rnd(4, 4, 512)
    C = rnd(4, 4, 512, 512)
    got = _rows_of_batch_1(lambda a, b: ssm._per_slot(ssm._readout, a, b),
                           q, C)
    torch.testing.assert_close(got, torch.einsum("bhd,bhde->bhe", q, C),
                               atol=1e-3, rtol=1e-5)
    _rows_of_batch_1(lambda a, b: ssm._per_slot(ssm._normaliser, a, b), q, n)
    r = rnd(4, 4, 256, 256) * 256 ** -0.5
    got = _rows_of_batch_1(lambda h: ssm._recurrence(h, r), rnd(4, 4, 256))
    assert got.shape == (4, 4, 4, 256)


@pytest.fixture(scope="module")
def xlstm_full_width():
    """xlstm-350m at full width (d_model 1024, 4 heads, d_inner 2048, vocab
    50304) and 4 of its 24 layers (layer 3 an sLSTM block), random bf16
    weights packed to int4 by RTN (g = 64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    cfg = ARCHS["xlstm-350m"].scaled(n_layers=4)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    qp, _ = quantize_model(params, model.quant_site_map(), None,
                           method="rtn", spec=QuantSpec(4, 64),
                           mode="packed")
    return model, qp


def test_xlstm_decode_logits_do_not_depend_on_the_batch(xlstm_full_width):
    """Four prompts (5..300 tokens) prefilled alone at their exact lengths
    and written into a 4-slot state, then 3 decode steps: each step's
    logits at B 4, 2 and 1 (the same slots' state) equal bit for bit."""
    from repro_torch.serve.cache_ops import write_slot

    model, qp = xlstm_full_width
    gen = torch.Generator().manual_seed(1)
    cache = model.init_cache(4, 512)
    last = []
    for s, n in enumerate((5, 64, 130, 300)):
        toks = torch.randint(1, 4096, (1, n), generator=gen).int().cuda()
        logits, one = model.prefill(qp, toks, model.init_cache(1, 512))
        write_slot(cache, one, s)
        last.append(int(logits[0, 0, :model.cfg.vocab_size].argmax()))
    nxt = torch.tensor(last, dtype=torch.int32, device="cuda")[:, None]

    def sub(c, b):
        return {"mlstm": {k: v[:, :b].clone() for k, v in c["mlstm"].items()},
                "slstm": [v[:, :b].clone() for v in c["slstm"]],
                "len": c["len"][:b].clone()}

    for _ in range(3):
        logits = {}
        for b in (2, 1):
            logits[b], _ = model.decode_step(qp, sub(cache, b), nxt[:b])
        logits[4], cache = model.decode_step(qp, cache, nxt)
        for b in (2, 1):
            assert torch.equal(logits[b], logits[4][:b]), b
        nxt = logits[4][:, 0, :model.cfg.vocab_size].argmax(-1).int()[:, None]


def _ssm_audio_setup(arch, dtype, dev_params):
    """A tiny model of ``arch`` in ``dtype``, FAQ-packed on the CPU, and a
    calibration batch (frames for whisper)."""
    from repro_torch.bridge import tree_to
    from repro_torch.core import run_calibration

    cfg = ARCHS[arch].tiny().scaled(dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=gen)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.encoder_len, cfg.d_model,
                                      generator=gen) * 0.1
    stats = run_calibration(model.forward, params, [batch])
    qp, _ = quantize_model(params, model.quant_site_map(), stats,
                           method="faq", spec=QuantSpec(4, 64), mode="packed")
    return cfg, model, qp, tree_to(qp, dev_params), batch


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-small"])
def test_xlstm_and_whisper_tiny_forward_and_decode_on_the_card(dev, arch):
    """The tiny model in f32 on the card (kernels) against the same packed
    weights on the CPU (plain versions), within 1e-4: the forward (whisper
    with frames: its encoder through the non-causal attention kernel),
    then prefill and 20 decode steps (xlstm's recurrent states; whisper's
    self and cross decode launches)."""
    cfg, model, qp, qd, batch = _ssm_audio_setup(arch, "float32", dev)
    want = model.forward(qp, batch)[0]
    got = model.forward(qd, {k: v.to(dev) for k, v in batch.items()})[0]
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    toks = batch["tokens"][:, :20]
    out = []
    for device, params in ((torch.device("cpu"), qp), (dev, qd)):
        kw = ({"frames": batch["frames"].to(device)}
              if cfg.family == "audio" else {})
        cache = model.init_cache(2, 64, device=device)
        logits, cache = model.prefill(params, toks.to(device), cache, **kw)
        seq = [logits.float().cpu()]
        for i in range(20):
            nxt = batch["tokens"][:, 20 + i:21 + i].int().to(device)
            logits, cache = model.decode_step(params, cache, nxt)
            seq.append(logits.float().cpu())
        out.append(torch.cat(seq, 1))
    torch.testing.assert_close(out[1], out[0], atol=1e-4, rtol=1e-4)


def test_xlstm_engine_equals_generate_on_the_card(dev):
    """bf16 on the card at 4 slots: every request's tokens equal batch-1
    ``generate`` bit for bit (exact-length admission, the list-valued
    sLSTM state written and merged per slot, batch-invariant decode)."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, model, _, qd, _ = _ssm_audio_setup("xlstm-350m", "bfloat16", dev)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
               for n in (5, 30, 17, 70, 9, 3)]
    eng = ServeEngine(model, qd, n_slots=4, max_len=96, device=dev)
    res = eng.serve([Request(rid=i, prompt=p, max_new_tokens=12)
                     for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        alone = eng.generate(Request(rid=10 + i, prompt=p, max_new_tokens=12))
        assert torch.equal(torch.as_tensor(res[i]), torch.as_tensor(alone)), i


# -- tensor-parallel serving: a rank's routes and ranks on the card -----------

@pytest.mark.parametrize("k,n", [(4096, 2048), (4096, 512), (4096, 7168)])
def test_quant_matmul_column_shard_is_its_columns(dev, k, n):
    """A rank's column shard at model 2 (wq, wk / wv, gate / up of
    llama3-8b): the product on the shard is the plain version's within the
    exact limit and the same columns of the whole product bit for bit (k
    and g are unchanged, so is the fold)."""
    gen = torch.Generator(device=dev).manual_seed(k + n)
    codes, scale, zero = _packed(k, 2 * n, 64, gen)
    x = torch.randn(4, k, generator=gen, device=dev).bfloat16()
    whole = qm.quant_matmul(x, codes, scale, zero)
    for r in range(2):
        part = [t[:, r * n:(r + 1) * n].contiguous()
                for t in (codes, scale, zero)]
        got = qm.quant_matmul(x, *part)
        _bf16_close(got, qm.quant_matmul_ref(x, *part),
                    rel_tol=EXACT_REL_TOL)
        assert torch.equal(got, whole[:, r * n:(r + 1) * n]), r


@pytest.mark.parametrize("k,n", [(2048, 4096), (7168, 4096)])
def test_quant_matmul_row_shards_sum_to_the_product(dev, k, n):
    """A rank's row shard at model 2 (wo, down): each partial product is
    the plain version's within the exact limit; the two, summed as the
    all_reduce sums them, are the whole product up to one more bf16
    rounding."""
    gen = torch.Generator(device=dev).manual_seed(k * 3 + n)
    codes, scale, zero = _packed(2 * k, n, 64, gen)
    x = torch.randn(4, 2 * k, generator=gen, device=dev).bfloat16()
    total = 0
    for r in range(2):
        args = (x[:, r * k:(r + 1) * k].contiguous(),
                codes[r * k // 2:(r + 1) * k // 2].contiguous(),
                scale[r * k // 64:(r + 1) * k // 64].contiguous(),
                zero[r * k // 64:(r + 1) * k // 64].contiguous())
        got = qm.quant_matmul(*args)
        _bf16_close(got, qm.quant_matmul_ref(*args), rel_tol=EXACT_REL_TOL)
        total = total + got.float()
    _bf16_close(total.bfloat16(), qm.quant_matmul_ref(x, codes, scale, zero))


@pytest.mark.parametrize("variant", ["dense", "q8", "paged", "paged_q8"])
def test_decode_on_a_ranks_heads_is_its_part(dev, variant):
    """Decode attention on one rank's 16 query / 4 KV heads (llama3-8b at
    model 2), every variant: the plain version's within the bf16 limit,
    and the same heads of the single-device launch bit for bit (heads
    never mix)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    b, h, kh, s, hd, ps = 4, 16, 4, 1024, 128, 16
    lens = [44, 140, 332, 732]
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, 2 * h, hd, generator=gen, device=dev).bfloat16()
    kv = [torch.randn(b, 2 * kh, s, hd, generator=gen,
                      device=dev).bfloat16() for _ in range(2)]
    if "q8" in variant:
        kv = [c for t in kv for c in _q8(t)]
    perm = (torch.randperm(b * s // ps, generator=gen, device=dev) + 1) \
        .reshape(b, s // ps).to(torch.int32)

    def pages(t):
        blocks = t.reshape(b, t.shape[1], s // ps, ps, -1) \
            .permute(0, 2, 1, 3, 4).reshape(b * s // ps, t.shape[1], ps, -1)
        store = torch.zeros((1 + blocks.shape[0],) + blocks.shape[1:],
                            dtype=t.dtype, device=dev)
        store[perm.reshape(-1).long()] = blocks
        return store

    kern, plain = {
        "dense": (fd.flash_decode, fd.decode_attention_ref),
        "q8": (fd.flash_decode_q8, fd.decode_attention_q8_ref),
        "paged": (fd.flash_decode_paged, fd.paged_decode_attention_ref),
        "paged_q8": (fd.flash_decode_paged_q8,
                     fd.paged_decode_attention_q8_ref)}[variant]

    def args(qq, caches):
        if "paged" in variant:
            return (qq, *(pages(c) for c in caches), perm, cl)
        return (qq, *caches, cl)

    whole = kern(*args(q, kv))
    for r in range(2):
        qr = q[:, :, r * h:(r + 1) * h].contiguous()
        cr = [c[:, r * kh:(r + 1) * kh].contiguous() for c in kv]
        a = args(qr, cr)
        got = kern(*a)
        _bf16_close(got, plain(*a))
        assert torch.equal(got, whole[:, :, r * h:(r + 1) * h]), r


def _q8(t):
    codes, scale = quantize_kv(t.transpose(1, 2))
    return codes.transpose(1, 2).contiguous(), scale.transpose(1, 2) \
        .contiguous()


def test_flash_attention_on_a_ranks_kv_heads_is_its_part(dev):
    """Prefill attention on one rank's 4 of 8 KV heads (G 4, hd 128, T
    512, with a key length per slot): the same rows of the single-device
    launch bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(9)
    b, kh, g, t, hd = 4, 8, 4, 512, 128
    q = torch.randn(b * kh, g, t, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b * kh, t, hd, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    lens = torch.tensor([300, 512, 37, 450], dtype=torch.int32, device=dev)
    whole = fa.flash_attention(q, k, v, causal=True, kv_lens=lens)

    def mine(w, r):
        return w.reshape(b, kh, *w.shape[1:])[:, r * 4:(r + 1) * 4] \
            .reshape(b * 4, *w.shape[1:])

    for r in range(2):
        got = fa.flash_attention(*(mine(w, r).contiguous() for w in (q, k, v)),
                                 causal=True, kv_lens=lens)
        assert torch.equal(got, mine(whole, r)), r


def test_quant_matmul_experts_on_a_ranks_experts_is_its_part(dev):
    """Expert parallelism at model 2: a rank's 32 of 64 experts over both
    ranks' capacity rows (decode: every rank routes the same tokens) give
    the rows of the single-device grouped launch bit for bit."""
    from repro_torch.kernels.ops import quant_matmul_experts
    from repro_torch.kernels.ref import quant_matmul_experts_ref

    gen = torch.Generator(device=dev).manual_seed(11)
    e, c, k, n = 64, 5, 2048, 1408
    qt = quantize_groupwise(
        torch.randn(e, k, n, generator=gen, device=dev) / k ** 0.5,
        QuantSpec(4, 64), pack=True,
        act_scale=torch.rand((e, k), generator=gen, device=dev) + 0.5)
    x = (torch.randn(e, c, k, generator=gen, device=dev) / 4).bfloat16()
    whole = quant_matmul_experts(x, qt)
    for r in range(2):
        sl = slice(r * 32, (r + 1) * 32)
        xr = torch.cat([x[sl]] * 2, dim=1)
        got = quant_matmul_experts(xr, qt[sl])
        _bf16_close(got, quant_matmul_experts_ref(xr, qt[sl]),
                    rel_tol=EXACT_REL_TOL)
        assert torch.equal(got, torch.cat([whole[sl]] * 2, dim=1)), r


def _tp_tiny(dev, mesh=None):
    """A tiny llama3-8b (f32, RTN int4) served on ``dev``; tokens."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = ARCHS["llama3-8b"].tiny()
    model = build_model(cfg)
    qp, _ = quantize_model(model.init(0, device=dev), model.quant_site_map(),
                           None, method="rtn", spec=QuantSpec(4, 64),
                           mode="packed")
    gen = torch.Generator().manual_seed(2)
    res = {}
    for paged in (False, True):
        eng = ServeEngine(model, qp, n_slots=2, max_len=64, paged=paged,
                          page_size=8, mesh=mesh, device=dev)
        out = eng.serve([Request(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (n,), generator=gen).numpy(),
            max_new_tokens=8) for i, n in enumerate((5, 19, 33))])
        res[paged] = {r: out[r].tolist() for r in out}
    return res


def _tp_rank(mesh):
    return _tp_tiny(mesh.device, mesh)


@pytest.mark.parametrize("shape,backend", [((1, 2), "gloo"),
                                           ((1, 1), "nccl")])
def test_ranks_on_the_card_serve_single_device_tokens(dev, tmp_path, shape,
                                                      backend):
    """Two ranks sharing the card over gloo (CUDA tensors staged through
    the host), and a 1 x 1 NCCL mesh: dense and paged tokens equal the
    single-device engine's (f32: a row-parallel sum parts from the single
    product by float rounding only, far from a tie here)."""
    from repro_torch.launch.mesh import spawn
    got = spawn(_tp_rank, shape, backend, str(tmp_path), device="cuda",
                timeout=600)
    assert got == _tp_tiny(dev)


# -- tensor-parallel serving of the vlm / hybrid / ssm / audio families ------

def _family_columns(k, n, r):
    """The whole product's columns that rank r's column shard (k -> n) of
    a family at model 2 holds: Mamba in_proj's blocks of its u and z
    halves, else a contiguous block; and the whole width."""
    if (k, n) == (1600, 3200):
        cols = (list(range(r * 1600, (r + 1) * 1600))
                + list(range(3200 + r * 1600, 3200 + (r + 1) * 1600)))
        return cols, 6400
    return list(range(r * n, (r + 1) * n)), 2 * n


@pytest.mark.parametrize("k,n", [(1600, 3200), (2048, 1024), (768, 1536)])
def test_quant_matmul_family_column_shard_is_its_columns(dev, k, n):
    """A rank's column shard of the families at model 2 (Mamba in_proj's
    two halves, mLSTM wq / wk / wv, whisper w1): the plain version's
    within the exact limit, and its columns of the whole product bit for
    bit."""
    gen = torch.Generator(device=dev).manual_seed(k + 7 * n)
    cols, width = _family_columns(k, n, 0)
    codes, scale, zero = _packed(k, width, 64, gen)
    x = torch.randn(4, k, generator=gen, device=dev).bfloat16()
    whole = qm.quant_matmul(x, codes, scale, zero)
    for r in range(2):
        sel = torch.tensor(_family_columns(k, n, r)[0], device=dev)
        part = [t[:, sel].contiguous() for t in (codes, scale, zero)]
        got = qm.quant_matmul(x, *part)
        _bf16_close(got, qm.quant_matmul_ref(x, *part),
                    rel_tol=EXACT_REL_TOL)
        assert torch.equal(got, whole[:, sel]), r


@pytest.mark.parametrize("k,n,out,m", [(1536, 768, torch.bfloat16, 4),
                                       (1600, 132, torch.float32, 4),
                                       (1600, 1600, torch.float32, 4),
                                       (2752, 1600, torch.float32, 4),
                                       (1600, 1600, torch.float32, 512)])
def test_quant_matmul_family_row_shards_sum_to_the_product(dev, k, n, out,
                                                           m):
    """A rank's row shard of the families at model 2: whisper w2 on bf16
    partials (the two summed are the whole product up to one more bf16
    rounding), and hymba's Mamba x_proj and out_proj and w_down with f32
    output (``models.common.row_parallel_f32``: the tensor-core route's
    f32 sums, which round to its bf16 output bit for bit; the two summed
    and rounded once are the single-device bf16 product within the exact
    limit), at decode (split k) and prefill rows.  Each partial is the
    plain version's within the exact limit."""
    gen = torch.Generator(device=dev).manual_seed(5 * k + n + m)
    codes, scale, zero = _packed(2 * k, n, 64, gen)
    x = torch.randn(m, 2 * k, generator=gen, device=dev).bfloat16()
    total = 0
    for r in range(2):
        args = (x[:, r * k:(r + 1) * k].contiguous(),
                codes[r * k // 2:(r + 1) * k // 2].contiguous(),
                scale[r * k // 64:(r + 1) * k // 64].contiguous(),
                zero[r * k // 64:(r + 1) * k // 64].contiguous())
        got = qm.quant_matmul(*args, out_dtype=out)
        assert got.dtype == out
        _bf16_close(got, qm.quant_matmul_ref(*args, out_dtype=out),
                    rel_tol=EXACT_REL_TOL)
        if out == torch.float32:
            assert torch.equal(got.bfloat16(), qm.quant_matmul(*args)), r
        total = total + got.float()
    if out == torch.float32:
        _bf16_close(total.bfloat16(), qm.quant_matmul(x, codes, scale, zero),
                    rel_tol=EXACT_REL_TOL)
    else:
        _bf16_close(total.bfloat16(),
                    qm.quant_matmul_ref(x, codes, scale, zero))


@pytest.mark.parametrize("route", ["vlm prefill", "whisper encoder",
                                   "vlm decode", "whisper cross"])
def test_family_attention_on_a_ranks_heads_is_its_part(dev, route):
    """Attention on one rank's heads at model 2: qwen2-vl's prefill at G 6
    on 1 of 2 KV heads (causal, T 512) and its decode at H 6 / KH 1;
    whisper's encoder on 6 of 12 heads (not causal, T 1536) and its cross
    decode on 6 heads over 1536 keys: the plain version's within the bf16
    limit, and the same heads of the single-device launch bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(13)
    b = 4

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    if route in ("vlm prefill", "whisper encoder"):
        kh, g, t, hd, causal = ((2, 6, 512, 128, True) if route == "vlm "
                                "prefill" else (12, 1, 1536, 64, False))
        q, k, v = rand(b * kh, g, t, hd), rand(b * kh, t, hd), rand(
            b * kh, t, hd)
        whole = fa.flash_attention(q, k, v, causal=causal)
        per = kh // 2

        def mine(w, r):
            return w.reshape(b, kh, *w.shape[1:])[:, r * per:(r + 1) * per] \
                .reshape(b * per, *w.shape[1:])

        for r in range(2):
            a = tuple(mine(w, r).contiguous() for w in (q, k, v))
            got = fa.flash_attention(*a, causal=causal)
            _bf16_close(got, fa.flash_attention_ref(*a, causal=causal))
            assert torch.equal(got, mine(whole, r)), r
        return
    h, kh, s, hd, lens = ((12, 2, 1024, 128, [44, 140, 332, 732])
                          if route == "vlm decode"
                          else (12, 12, 1536, 64, [1536] * 4))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q, kc, vc = rand(b, 1, h, hd), rand(b, kh, s, hd), rand(b, kh, s, hd)
    whole = fd.flash_decode(q, kc, vc, cl)
    hr, kr = h // 2, kh // 2
    for r in range(2):
        a = (q[:, :, r * hr:(r + 1) * hr].contiguous(),
             kc[:, r * kr:(r + 1) * kr].contiguous(),
             vc[:, r * kr:(r + 1) * kr].contiguous(), cl)
        got = fd.flash_decode(*a)
        _bf16_close(got, fd.decode_attention_ref(*a))
        assert torch.equal(got, whole[:, :, r * hr:(r + 1) * hr]), r


def _family_tiny(dev, mesh=None):
    """qwen2-vl, hymba and xlstm tiny (f32, RTN int4) served on 2 slots,
    and whisper tiny's prefill(frames=) + 6 greedy decode steps through an
    engine's placed weights: tokens."""
    from repro_torch.serve.engine import Request, ServeEngine
    gen = torch.Generator().manual_seed(4)
    res = {}
    for arch in ("qwen2-vl-2b", "hymba-1.5b", "xlstm-350m", "whisper-small"):
        cfg = ARCHS[arch].tiny()
        model = build_model(cfg)
        qp, _ = quantize_model(model.init(0, device=dev),
                               model.quant_site_map(), None, method="rtn",
                               spec=QuantSpec(4, 64), mode="packed")
        eng = ServeEngine(model, qp, n_slots=2, max_len=48, mesh=mesh,
                          device=dev)
        if arch != "whisper-small":
            out = eng.serve([Request(rid=i, prompt=torch.randint(
                1, cfg.vocab_size, (n,), generator=gen).numpy(),
                max_new_tokens=8) for i, n in enumerate((5, 19, 12))])
            res[arch] = {r: out[r].tolist() for r in out}
            continue
        toks = torch.randint(1, cfg.vocab_size, (2, 9), generator=gen)
        frames = torch.randn(2, cfg.encoder_len, cfg.d_model,
                             generator=gen) * 0.1
        with eng._mesh_ctx():
            cache = eng.new_cache(model, 2, 48)
            logits, cache = model.prefill(eng.params, toks.to(dev), cache,
                                          frames=frames.to(dev))
            seq = [logits[:, 0, :cfg.vocab_size].argmax(-1)]
            for _ in range(6):
                logits, cache = model.decode_step(
                    eng.params, cache, seq[-1][:, None].int())
                seq.append(logits[:, 0, :cfg.vocab_size].argmax(-1))
        res[arch] = torch.stack(seq, 1).tolist()
    return res


def _family_rank(mesh):
    return _family_tiny(mesh.device, mesh)


def test_family_ranks_on_the_card_serve_single_device_tokens(dev, tmp_path):
    """Two ranks sharing the card over gloo serve the tiny vlm, hybrid and
    ssm families (and drive whisper's prefill(frames=) / decode) with the
    single-device tokens (f32: row-parallel sums part from the single
    product by float rounding only, far from a tie here)."""
    from repro_torch.launch.mesh import spawn
    got = spawn(_family_rank, (1, 2), "gloo", str(tmp_path), device="cuda",
                timeout=600)
    assert got == _family_tiny(dev)
