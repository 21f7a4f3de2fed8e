"""repro_torch.core against repro.core on the same numpy inputs.

Tolerances: codes and chosen alpha indices must be identical; float32
values (scales, dequantized weights, fused stats, losses) agree to
atol = rtol = 1e-5 — both sides compute in float32 but XLA and PyTorch
sum in different orders.  The float64 numpy oracle is held at 1e-4, as
tests/test_properties.py holds the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantSpec as JSpec
from repro.core import methods as jmethods
from repro.core import quantizer as jq
from repro.core import stats as jstats
from repro_torch.core import QuantSpec
from repro_torch.core import methods as tmethods
from repro_torch.core import quantizer as tq
from repro_torch.core import stats as tstats

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("n_in,n_out,bits,group,sym,smooth", [
    (128, 64, 4, 64, False, False),
    (128, 64, 4, 64, False, True),
    (1600, 32, 4, 100, False, True),      # hymba's group of 100
    (256, 48, 4, 64, True, False),
    (96, 16, 3, 32, False, True),
    (90, 8, 4, 64, False, False),         # odd effective group (45)
])
def test_packed_codes_match_reference(n_in, n_out, bits, group, sym, smooth):
    rng = np.random.default_rng(n_in + n_out + bits)
    w = rng.normal(size=(n_in, n_out)).astype(np.float32)
    act = (np.abs(rng.normal(size=n_in)) + 0.5).astype(np.float32) \
        if smooth else None
    spec_j = JSpec(bits=bits, group_size=group, symmetric=sym)
    spec_t = QuantSpec(bits=bits, group_size=group, symmetric=sym)
    ref = jq.quantize_groupwise(jnp.asarray(w), spec_j,
                                act_scale=None if act is None
                                else jnp.asarray(act), pack=True)
    got = tq.quantize_groupwise(torch.as_tensor(w), spec_t,
                                act_scale=None if act is None
                                else torch.as_tensor(act), pack=True)
    np.testing.assert_array_equal(_np(got.codes), _np(ref.codes))
    np.testing.assert_allclose(_np(got.scale), _np(ref.scale), **TOL)
    np.testing.assert_allclose(_np(got.zero), _np(ref.zero), **TOL)
    assert got.n_in == ref.n_in and got.packed
    # the realized weight against the float64 numpy oracle (both copies)
    w_hat = tq.quant_dequant(torch.as_tensor(w), spec_t,
                             act_scale=None if act is None
                             else torch.as_tensor(act))
    oracle = tq.numpy_quant_reference(w, spec_t, act)
    np.testing.assert_array_equal(oracle,
                                  jq.numpy_quant_reference(w, spec_j, act))
    np.testing.assert_allclose(_np(w_hat), oracle, atol=1e-4)


@pytest.mark.parametrize("n_in,group", [(64, 32), (1600, 100), (90, 64)])
def test_unpack_dequant_roundtrip(n_in, group):
    rng = np.random.default_rng(n_in)
    w = rng.normal(size=(n_in, 24)).astype(np.float32)
    spec = QuantSpec(bits=4, group_size=group)
    packed = tq.quantize_groupwise(torch.as_tensor(w), spec, pack=True)
    plain = tq.quantize_groupwise(torch.as_tensor(w), spec, pack=False)
    assert packed.codes.shape == (n_in // 2, 24)
    torch.testing.assert_close(
        tq.unpack_codes(packed.codes, 4, n_in), plain.codes, rtol=0, atol=0)
    torch.testing.assert_close(tq.pack_codes(plain.codes, 4), packed.codes,
                               rtol=0, atol=0)
    deq = tq.dequantize_groupwise(packed)
    torch.testing.assert_close(deq, tq.dequantize_groupwise(plain),
                               rtol=0, atol=0)
    ref = jq.dequantize_groupwise(jq.quantize_groupwise(
        jnp.asarray(w), JSpec(bits=4, group_size=group), pack=True))
    np.testing.assert_allclose(_np(deq), _np(ref), **TOL)
    # nibble order: byte i holds code[2i] low, code[2i+1] high
    c = _np(plain.codes)
    np.testing.assert_array_equal(_np(packed.codes),
                                  c[0::2] | (c[1::2] << 4))


@pytest.mark.parametrize("window", [1, 2, 3, 4, 10])
def test_window_preview_and_fuse_match(window):
    rng = np.random.default_rng(window)
    stats = (np.abs(rng.normal(size=(6, 16))) + 0.01).astype(np.float32)
    got = tmethods.window_preview(torch.as_tensor(stats), window)
    ref = jmethods.window_preview(jnp.asarray(stats), window)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    got = tmethods.fuse_stats(torch.as_tensor(stats), 0.85, window)
    ref = jmethods.fuse_stats(jnp.asarray(stats), 0.85, window)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_window_preview_exact_window_one():
    """Shift-and-mask, not a cumsum difference: window 1 is exact."""
    stats = torch.arange(20, dtype=torch.float32).reshape(5, 4) * 1e3 + 0.1
    pvw = tmethods.window_preview(stats, 1)
    torch.testing.assert_close(pvw[:-1], stats[1:], rtol=0, atol=0)
    torch.testing.assert_close(pvw[-1], stats[-1], rtol=0, atol=0)


def test_merge_stats_round_robin_matches():
    rng = np.random.default_rng(0)

    def batch():
        return {"site": {
            "mean_abs": rng.random(8).astype(np.float32),
            "mean_sq": rng.random(8).astype(np.float32),
            "sample": rng.normal(size=(16, 8)).astype(np.float32)}}

    batches = [batch() for _ in range(4)]
    as_j = [{s: {k: jnp.asarray(v) for k, v in d.items()}
             for s, d in b.items()} for b in batches]
    as_t = [{s: {k: torch.as_tensor(v) for k, v in d.items()}
             for s, d in b.items()} for b in batches]
    acc_j, acc_t, tokens = as_j[0], as_t[0], 32.0
    for i in range(1, 4):
        acc_j = jstats.merge_stats(acc_j, as_j[i], tokens, 32.0,
                                   batch_index=i)
        acc_t = tstats.merge_stats(acc_t, as_t[i], tokens, 32.0,
                                   batch_index=i)
        tokens += 32.0
    for k in ("mean_abs", "mean_sq"):
        np.testing.assert_allclose(_np(acc_t["site"][k]),
                                   _np(acc_j["site"][k]), **TOL)
    np.testing.assert_array_equal(_np(acc_t["site"]["sample"]),
                                  _np(acc_j["site"]["sample"]))
    # every batch keeps rows in the sample (round-robin, not batch 0 only)
    sample = _np(acc_t["site"]["sample"])
    for b in batches:
        assert any((sample == row).all(1).any()
                   for row in b["site"]["sample"])


def test_site_stat_matches():
    x = np.random.default_rng(1).normal(size=(2, 50, 12)).astype(np.float32)
    got = tstats.site_stat(torch.as_tensor(x))
    ref = jstats.site_stat(jnp.asarray(x))
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), **TOL)
    assert got["sample"].shape == (64, 12)


@pytest.mark.parametrize("loss", ["sample", "diag"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_alpha_index_matches(loss, seed):
    rng = np.random.default_rng(seed)
    n_in, n_out = 128, 64
    w = rng.normal(size=(n_in, n_out)).astype(np.float32)
    chan = np.exp(rng.normal(size=n_in)).astype(np.float32)
    sample = (rng.normal(size=(32, n_in)) * chan).astype(np.float32)
    a_stat = np.abs(sample).mean(0)
    mean_sq = (sample * sample).mean(0)
    kw_j, kw_t = {}, {}
    if loss == "sample":
        kw_j["sample"], kw_t["sample"] = (jnp.asarray(sample),
                                          torch.as_tensor(sample))
    else:
        kw_j["mean_sq"], kw_t["mean_sq"] = (jnp.asarray(mean_sq),
                                            torch.as_tensor(mean_sq))
    ref = jmethods.search_alpha(jnp.asarray(w), jnp.asarray(a_stat),
                                JSpec(bits=3, group_size=64), **kw_j)
    got = tmethods.search_alpha(torch.as_tensor(w), torch.as_tensor(a_stat),
                                QuantSpec(bits=3, group_size=64), **kw_t)
    assert tmethods.DEFAULT_ALPHA_GRID == jmethods.DEFAULT_ALPHA_GRID
    assert float(got.alpha) == float(ref.alpha)
    np.testing.assert_allclose(_np(got.act_scale), _np(ref.act_scale), **TOL)
    np.testing.assert_allclose(float(got.loss), float(ref.loss), rtol=1e-5)
    np.testing.assert_allclose(float(got.rtn_loss), float(ref.rtn_loss),
                               rtol=1e-5)
    assert float(got.loss) <= float(got.rtn_loss) + 1e-6


def test_site_stat_for_method_dispatch():
    stats = torch.rand(4, 16) + 0.1
    assert tmethods.site_stat_for_method("rtn", stats) is None
    torch.testing.assert_close(tmethods.site_stat_for_method("awq", stats),
                               stats)
    with pytest.raises(ValueError):
        tmethods.site_stat_for_method("gptq", stats)
