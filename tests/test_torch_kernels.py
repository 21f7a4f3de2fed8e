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
from repro.models.common import rms_norm as j_rms_norm
from repro.models.common import update_cache_at as j_update_cache_at
from repro_torch.core import QuantSpec, quantize_groupwise
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import rms_norm as rn
from repro_torch.models.common import (LM_HEAD_ROWS, chunked_attention,
                                       logits_from_hidden, qlinear,
                                       update_cache_at)

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


def test_quant_matmul_f32_out_is_the_sum_before_rounding():
    """``out_dtype=float32`` from bf16 x (a row-parallel partial product):
    on the CPU the plain version's f32 product, which rounds to the
    default bf16 output; ops.quant_matmul divides by act_scale in x's
    dtype first, and qlinear on a float weight takes it as x's dtype."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(128, 96)).astype(np.float32)
    s = (np.abs(rng.normal(size=128)) + 0.5).astype(np.float32)
    x = torch.as_tensor(rng.normal(size=(2, 5, 128)) / 11.0).bfloat16()
    qt = quantize_groupwise(torch.as_tensor(w), QuantSpec(4, 64),
                            act_scale=torch.as_tensor(s), pack=True)
    got = ops.quant_matmul(x, qt, torch.float32)
    xs = x / torch.as_tensor(s).bfloat16()
    deq = qm.dequant_ref(qt.codes, qt.scale, qt.zero, 128)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 96)
    torch.testing.assert_close(got, xs.float() @ deq, **TOL)
    assert torch.equal(got.bfloat16(), ops.quant_matmul(x, qt))
    wf = torch.as_tensor(w)
    assert torch.equal(qlinear(x, wf, torch.float32),
                       x.float() @ wf.bfloat16().float())
    with pytest.raises(ValueError, match="float32"):
        qm.quant_matmul(x[0], qt.codes, qt.scale, qt.zero, torch.float16)


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


def _grouped(q, k, v):
    """(B, T, H, hd) q and (B, T, KH, hd) k/v in the grouped layout."""
    b, t, h, hd = q.shape
    kh = k.shape[2]
    qr = q.reshape(b, t, kh, h // kh, hd).permute(0, 2, 3, 1, 4) \
          .reshape(b * kh, h // kh, t, hd)
    return (qr, k.permute(0, 2, 1, 3).reshape(b * kh, t, hd),
            v.permute(0, 2, 1, 3).reshape(b * kh, t, hd))


def _ungrouped(o, b, h):
    bkh, g, t, hd = o.shape
    return o.reshape(b, bkh // b, g, t, hd).permute(0, 3, 1, 2, 4) \
            .reshape(b, t, h, hd)


@pytest.mark.parametrize("t,lens", [(16, (12, 16, 1)), (150, (37, 150, 90))])
def test_flash_attention_kv_lens_plain_matches_reference(t, lens):
    """The length mask of the plain version is the reference's
    ``chunked_attention(kv_lens=...)`` mask, padding rows included."""
    from repro.models.common import chunked_attention as j_chunked
    b, h, kh, hd = len(lens), 4, 2, 32
    rng = np.random.default_rng(t)
    q, k, v = (rng.normal(size=(b, t, n, hd)).astype(np.float32)
               for n in (h, kh, kh))
    kv_lens = np.asarray(lens, np.int32)
    ref = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, chunk=64, kv_lens=jnp.asarray(kv_lens))
    got = fa.flash_attention(*_grouped(*(torch.as_tensor(a)
                                         for a in (q, k, v))),
                             kv_lens=torch.as_tensor(kv_lens))
    np.testing.assert_allclose(_np(_ungrouped(got, b, h)), _np(ref), **TOL)


def test_flash_attention_kv_lens_plain_matches_port_chunked():
    """The port's CPU chunked path (the prefill's) and the kernel's plain
    version agree under the mask; kv_lens = T is the unmasked call."""
    b, t, h, kh, hd = 3, 70, 4, 1, 16
    rng = np.random.default_rng(2)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, t, n, hd))
                               .astype(np.float32)) for n in (h, kh, kh))
    lens = torch.tensor([5, 70, 33], dtype=torch.int32)
    expect = chunked_attention(q, k, v, causal=True, chunk=32, kv_lens=lens)
    got = fa.flash_attention(*_grouped(q, k, v), kv_lens=lens)
    torch.testing.assert_close(_ungrouped(got, b, h), expect, **TOL)
    full = torch.full((b,), t, dtype=torch.int32)
    torch.testing.assert_close(fa.flash_attention(*_grouped(q, k, v),
                                                  kv_lens=full),
                               fa.flash_attention(*_grouped(q, k, v)),
                               atol=0, rtol=0)


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
    with pytest.raises(ValueError, match="B, T, H"):
        fd.flash_verify(torch.zeros(2, 0, 4, 8), torch.zeros(2, 2, 16, 8),
                        torch.zeros(2, 2, 16, 8), torch.ones(2))
    with pytest.raises(ValueError, match="does not match"):
        rn.rms_norm(torch.zeros(3, 8), torch.ones(6))
    with pytest.raises(ValueError, match="kv_lens"):
        fa.flash_attention(torch.zeros(3, 1, 8, 16), torch.zeros(3, 8, 16),
                           torch.zeros(3, 8, 16),
                           kv_lens=torch.ones(2, dtype=torch.int32))


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    """Dispatch follows the tensor's device: on CPU tensors every wrapper
    takes its plain version — nothing is built or loaded and no launch is
    counted."""
    def refuse(*a, **k):
        raise AssertionError("CPU path reached the CUDA build")

    monkeypatch.setattr(_build, "_load", refuse)
    monkeypatch.setattr(_build, "_build_locked", refuse)
    before = [qm.KERNEL.launches, fd.KERNEL.launches, fa.KERNEL.launches,
              fd.VERIFY.launches, rn.KERNEL.launches]
    qt = quantize_groupwise(torch.randn(64, 32), QuantSpec(4, 32), pack=True)
    ops.quant_matmul(torch.randn(3, 64), qt)
    ops.decode_attention(torch.randn(2, 1, 4, 16), torch.randn(2, 2, 8, 16),
                         torch.randn(2, 2, 8, 16),
                         torch.tensor([3, 8], dtype=torch.int32))
    chunked_attention(torch.randn(1, 128, 4, 16), torch.randn(1, 128, 2, 16),
                      torch.randn(1, 128, 2, 16))
    fa.flash_attention(torch.randn(2, 2, 128, 16), torch.randn(2, 128, 16),
                       torch.randn(2, 128, 16))
    ops.verify_attention(torch.randn(2, 3, 4, 16), torch.randn(2, 2, 8, 16),
                         torch.randn(2, 2, 8, 16),
                         torch.tensor([3, 5], dtype=torch.int32))
    rn.rms_norm(torch.randn(3, 16), torch.ones(16))
    assert [qm.KERNEL.launches, fd.KERNEL.launches, fa.KERNEL.launches,
            fd.VERIFY.launches, rn.KERNEL.launches] == before == [0] * 5
    assert not (fd.KERNEL.routes or fa.KERNEL.routes or fd.VERIFY.routes)


def test_kernel_counts_launches_by_route():
    """``launch`` adds one to ``launches`` and, where the wrapper names a
    route, to that route's count (a stand-in for the loaded function)."""
    kern = _build.Kernel("none.cu", "none_launch", [])
    kern._fn = lambda *args: 0
    kern.launch(1, 2, route="G1 hd64 not causal")
    kern.launch(route="G1 hd64 not causal")
    kern.launch(3)
    assert kern.launches == 3
    assert kern.routes == {"G1 hd64 not causal": 2}


@pytest.mark.parametrize("hd,offsets,bf16,width", [
    (64, (0, 0), True, 64), (36, (0, 0), True, 40), (64, (0, 1), True, 64),
    (36, (0, 0), False, 36), (64, (1, 0), False, 64)])
def test_tma_operands_pad_only_rows_tma_cannot_describe(hd, offsets, bf16,
                                                        width):
    """The flash-attention wrappers' operand rule (forward and backward):
    bf16 rows TMA cannot describe (hd % 8 != 0, or any base off 16 bytes)
    are copied, all of them, zero-padded to hd rounded up to 8; otherwise
    the tensors pass through as they are (f32 never pads)."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    xs, views = [], []
    for i, off in enumerate(offsets):
        x = torch.randn(2, 3, 5, hd, generator=torch.Generator()
                        .manual_seed(i)).to(dtype)
        buf = torch.zeros(x.numel() + off, dtype=dtype)
        view = buf[off:].view(x.shape)
        view.copy_(x)
        xs.append(x)
        views.append(view)
    got_width, got = fa._tma_operands(bf16, *views)
    assert got_width == width
    padded = bf16 and (hd % 8 or any(offsets))
    for x, view, y in zip(xs, views, got):
        if not padded:
            assert y.data_ptr() == view.data_ptr()
            continue
        assert y.shape == x.shape[:-1] + (width,) and y.data_ptr() % 16 == 0
        assert torch.equal(y[..., :hd], x) and not y[..., hd:].any()


# the kernel's routes' widths too: one, four and eight logical warps, two
# chunks a lane (4096), the block route's wider rows (5120)
@pytest.mark.parametrize("shape", [(3, 128), (2, 5, 100), (1, 36), (4, 1024),
                                   (3, 1536), (2, 1600), (2, 2048),
                                   (2, 4096), (1, 5120)])
def test_rms_norm_plain_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=shape[-1]).astype(np.float32)
    got = rn.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-5)
    np.testing.assert_allclose(
        _np(got), np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                        1e-5)), **TOL)


@pytest.mark.parametrize("variant", ["dense", "q8", "paged", "paged_q8"])
def test_verify_rows_equal_decode_on_cpu(variant):
    """The verify wrappers' plain path: row t equals the decode wrapper at
    base + t + 1 (the card holds the same bit for bit)."""
    from repro_torch.models.common import quantize_kv

    gen = torch.Generator().manual_seed(2)
    b, t, h, kh, s, hd, ps = 3, 5, 4, 2, 32, 16, 8
    q = torch.randn(b, t, h, hd, generator=gen)
    k, v = (torch.randn(b, kh, s, hd, generator=gen) for _ in range(2))
    base = torch.tensor([0, 6, 27], dtype=torch.int32)

    def q8(c):
        codes, scale = quantize_kv(c.transpose(1, 2))
        return codes.transpose(1, 2), scale.transpose(1, 2)

    def pages(c):
        return c.reshape(b, kh, s // ps, ps, -1).permute(0, 2, 1, 3, 4) \
            .reshape(b * s // ps, kh, ps, -1)

    table = torch.arange(b * s // ps, dtype=torch.int32).reshape(b, -1)
    leaves = (k, v) if variant in ("dense", "paged") else (*q8(k), *q8(v))
    if variant.startswith("paged"):
        args = (*(pages(x) for x in leaves), table)
    else:
        args = leaves
    verify = {"dense": fd.flash_verify, "q8": fd.flash_verify_q8,
              "paged": fd.flash_verify_paged,
              "paged_q8": fd.flash_verify_paged_q8}[variant]
    decode = {"dense": fd.flash_decode, "q8": fd.flash_decode_q8,
              "paged": fd.flash_decode_paged,
              "paged_q8": fd.flash_decode_paged_q8}[variant]
    got = verify(q, *args, base, window=6)
    for i in range(t):
        torch.testing.assert_close(
            got[:, i:i + 1], decode(q[:, i:i + 1], *args, base + i + 1,
                                    window=6), **TOL)


def test_update_cache_at_span_matches_reference():
    rng = np.random.default_rng(3)
    cache = rng.normal(size=(3, 2, 16, 8)).astype(np.float32)
    new = rng.normal(size=(3, 2, 4, 8)).astype(np.float32)
    pos = np.array([0, 5, 12], np.int32)
    want = j_update_cache_at(jnp.asarray(cache), jnp.asarray(new),
                             jnp.asarray(pos))
    got = update_cache_at(torch.as_tensor(cache.copy()), torch.as_tensor(new),
                          torch.as_tensor(pos))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_lm_head_rows_in_fixed_blocks():
    """The float head multiplies in zero-padded blocks of LM_HEAD_ROWS rows:
    any row count (one block, several, a ragged last one) gives x @ w."""
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(32, 300, generator=gen)
    for rows in (1, LM_HEAD_ROWS, 2 * LM_HEAD_ROWS + 3):
        x = torch.randn(2, rows, 32, generator=gen)
        got = logits_from_hidden(x, w, 290)
        want = x @ w
        assert got.shape == (2, rows, 300)
        torch.testing.assert_close(got[..., :290], want[..., :290], **TOL)
        assert bool((got[..., 290:] < -1e29).all())


H100_SMS = 132


@pytest.mark.parametrize("e,c,k,n,cfg,cpb,tiles", [
    # decode: one row per expert; 64 experts give enough tiles to not split
    (64, 1, 2048, 1408, 0, 0, 64 * 11),
    (64, 1, 1408, 2048, 0, 0, 64 * 16),
    # calibration capacity (8192 tokens, top-4 of 60): 64 x 256 tiles
    (64, 683, 2048, 1408, 3, 0, 64 * 11 * 6),
    (64, 171, 1408, 2048, 3, 0, 64 * 3 * 8),
    # one expert behaves as the single-product launch: split at decode
    (1, 1, 2048, 1408, 0, 1, 11),
    (16, 8, 128, 96, 0, 1, 16)])
def test_quant_matmul_experts_plan_and_scratch(e, c, k, n, cfg, cpb, tiles):
    """The grouped launch's choices: the tile by the per-expert rows C,
    tiles over every expert, a split only when all experts' tiles leave
    the card short, and scratch / counters sized for every expert."""
    p = qm.plan(c, k, n, 64, H100_SMS, experts=e)
    assert (p.cfg, p.tiles) == (cfg, tiles)
    assert (p.cpb > 0) == (cpb > 0)
    assert p.chunk == qm.chunk_rows(k, 64)          # the fold: k and g only
    assert p.chunk == qm.plan(c, k, n, 64, H100_SMS).chunk
    scratch, counters = qm.scratch_sizes(p, c, n, e)
    if p.cpb:
        assert scratch == e * p.n_chunks * c * n and counters == p.tiles
    else:
        assert (scratch, counters) == (0, 0)


def test_quant_matmul_experts_split_scratch_counts_every_expert():
    """Few experts at decode split k like the single-product launch; the
    scratch holds each expert's chunk sums and the counters each tile."""
    p = qm.plan(1, 4096, 1024, 64, H100_SMS, experts=4)
    assert p.cpb > 0 and p.tiles == 4 * 8
    assert qm.scratch_sizes(p, 1, 1024, 4) == (4 * p.n_chunks * 1024, 32)
    # a stack too large for the scratch does not split
    assert qm.plan(64, 4096, 14336, 64, H100_SMS, experts=2).cpb == 0


def test_quant_matmul_experts_cpu_is_the_plain_version(monkeypatch):
    """On CPU tensors the grouped wrapper takes the plain product per
    expert (nothing built, nothing counted), with padded shapes handled
    per expert by the wrapper's own padding rule."""
    def refuse(*a, **k):
        raise AssertionError("CPU path reached the CUDA build")

    monkeypatch.setattr(_build, "_load", refuse)
    monkeypatch.setattr(_build, "_build_locked", refuse)
    gen = torch.Generator().manual_seed(0)
    qt = quantize_groupwise(torch.randn(3, 128, 40, generator=gen),
                            QuantSpec(4, 64), pack=True)
    x = torch.randn(3, 5, 128, generator=gen)
    got = qm.quant_matmul_experts(x, qt.codes, qt.scale, qt.zero)
    for e in range(3):
        torch.testing.assert_close(
            got[e], qm.quant_matmul_ref(x[e], qt.codes[e], qt.scale[e],
                                        qt.zero[e]), atol=0, rtol=0)
    xp, cp, sp, zp = qm.padded(x, qt.codes, qt.scale, qt.zero)
    assert xp.shape == (3, 5, 128) and cp.shape == (3, 64, 48)
    assert sp.shape == zp.shape == (3, 2, 48)
    assert torch.equal(cp[:, :, :40], qt.codes) and not cp[:, :, 40:].any()
    assert qm.KERNEL_EXPERTS.launches == qm.KERNEL.launches == 0
    with pytest.raises(ValueError, match="E, m, k"):
        qm.quant_matmul_experts(x[0], qt.codes, qt.scale, qt.zero)
