"""The port's int8 / paged decode-attention and quant-error modules on the
CPU against the reference's Pallas kernels run in interpret mode, on the
same numpy inputs; plus the KV-cache helpers (``quantize_kv``,
``update_pages_at``, ``scatter_prefill_pages``, ``copy_page``) exact.

Tolerance: atol = rtol = 1e-5 in float32 (same math, another summation
order); codes, page writes and page copies are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantSpec as JSpec
from repro.kernels.flash_decode import (flash_decode_paged_pallas,
                                        flash_decode_paged_q8_pallas,
                                        flash_decode_q8_pallas)
from repro.kernels.quant_error import quant_error_pallas
from repro.models.common import quantize_kv as j_quantize_kv
from repro.models.common import update_pages_at as j_update_pages_at
from repro.serve.cache_ops import copy_page as j_copy_page
from repro.serve.cache_ops import scatter_prefill_pages as j_scatter
from repro_torch.core import QuantSpec
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels.quant_error import quant_error
from repro_torch.models.common import quantize_kv, update_pages_at
from repro_torch.serve.cache_ops import copy_page, scatter_prefill_pages

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _decode_inputs(b, h, kh, hd, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, kh, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, kh, s, hd)).astype(np.float32)
    lens = np.array([0, 1, s, 2 * s // 3 + 1][:b], np.int32)
    return q, k, v, lens


def _q8(x):
    """(B, KH, S, hd) -> int8 codes (B, KH, S, hd), scales (B, KH, S, 1),
    through the reference's quantize_kv."""
    c, sc = j_quantize_kv(jnp.asarray(x).transpose(0, 2, 1, 3))
    return (np.array(c.transpose(0, 2, 1, 3)),
            np.array(sc.transpose(0, 2, 1, 3)))


def _paged(x, ps, perm):
    """Cut (B, KH, S, d) into ps-position pages at ``perm`` (B, NP); the
    trash page 0 holds garbage (never read below a slot's length)."""
    b, kh, s, d = x.shape
    pages = x.reshape(b, kh, s // ps, ps, d).transpose(0, 2, 1, 3, 4) \
        .reshape(b * (s // ps), kh, ps, d)
    store = np.full((1 + pages.shape[0],) + pages.shape[1:], 7,
                    dtype=x.dtype)
    store[perm.reshape(-1)] = pages
    return store


CASES = [(4, 2, None), (4, 2, 48), (8, 8, None), (8, 8, 48)]


@pytest.mark.parametrize("h,kh,window", CASES)
def test_q8_decode_plain_matches_pallas(h, kh, window):
    q, k, v, lens = _decode_inputs(4, h, kh, 32, 96, seed=h + kh)
    (kc, ks), (vc, vs) = _q8(k), _q8(v)
    ref = flash_decode_q8_pallas(*(jnp.asarray(a) for a in
                                   (q, kc, ks, vc, vs, lens)),
                                 window=window, bs=32, interpret=True)
    got = ops.decode_attention_q8(*_t(q, kc, ks, vc, vs, lens),
                                  window=window)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("h,kh,window", CASES)
def test_paged_decode_plain_matches_pallas(h, kh, window):
    q, k, v, lens = _decode_inputs(4, h, kh, 32, 64, seed=10 + h)
    ps = 8
    perm = (np.random.default_rng(h).permutation(4 * 64 // ps) + 1) \
        .reshape(4, -1).astype(np.int32)
    k_st, v_st = _paged(k, ps, perm), _paged(v, ps, perm)
    ref = flash_decode_paged_pallas(*(jnp.asarray(a) for a in
                                      (q, k_st, v_st, perm, lens)),
                                    window=window, interpret=True)
    got = ops.paged_decode_attention(*_t(q, k_st, v_st, perm, lens),
                                     window=window)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    # the paged plain version is the dense one on the gathered cache
    dense = fd.flash_decode(*_t(q, k, v, lens), window=window)
    np.testing.assert_allclose(_np(got), _np(dense), **TOL)


@pytest.mark.parametrize("h,kh,window", CASES)
def test_paged_q8_decode_plain_matches_pallas(h, kh, window):
    q, k, v, lens = _decode_inputs(4, h, kh, 32, 64, seed=20 + h)
    ps = 8
    perm = (np.random.default_rng(kh).permutation(4 * 64 // ps) + 1) \
        .reshape(4, -1).astype(np.int32)
    stores = [_paged(a, ps, perm) for pair in (_q8(k), _q8(v))
              for a in pair]
    ref = flash_decode_paged_q8_pallas(
        *(jnp.asarray(a) for a in (q, *stores, perm, lens)), window=window,
        interpret=True)
    got = ops.paged_decode_attention_q8(*_t(q, *stores, perm, lens),
                                        window=window)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k,n,g", [(256, 128, 64), (320, 100, 64),
                                   (300, 260, 100)])
@pytest.mark.parametrize("sym", [False, True])
def test_quant_error_plain_matches_pallas(k, n, g, sym):
    rng = np.random.default_rng(k + n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    scales = (np.abs(rng.normal(size=(3, k))) + 0.5).astype(np.float32)
    msq = np.abs(rng.normal(size=(k,))).astype(np.float32)
    ref = quant_error_pallas(jnp.asarray(w), jnp.asarray(scales),
                             jnp.asarray(msq),
                             JSpec(bits=4, group_size=g, symmetric=sym),
                             interpret=True)
    got = ops.quant_error_batch(*_t(w, scales, msq),
                                QuantSpec(bits=4, group_size=g,
                                          symmetric=sym))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    assert torch.equal(got, quant_error(*_t(w, scales, msq),
                                        QuantSpec(4, g, symmetric=sym)))


def test_quantize_kv_codes_equal_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 2, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # all-zero row
    x[1, 1, 1, :4] = [127.0, -127.0, 63.5, 0.5]       # ties round to even
    jc, js = j_quantize_kv(jnp.asarray(x))
    tc, ts = quantize_kv(torch.as_tensor(x))
    assert tc.dtype == torch.int8 and ts.shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


def test_update_pages_at_exact():
    rng = np.random.default_rng(1)
    store = rng.normal(size=(6, 2, 4, 8)).astype(np.float32)
    new = rng.normal(size=(3, 2, 1, 8)).astype(np.float32)
    ids, offs = np.array([4, 2, 5], np.int32), np.array([3, 0, 1], np.int32)
    ref = j_update_pages_at(jnp.asarray(store), jnp.asarray(new),
                            jnp.asarray(ids), jnp.asarray(offs))
    got = update_pages_at(*_t(store, new), *_t(ids, offs))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    # two inactive slots writing the trash page touch no other page
    got = update_pages_at(*_t(store, new), *_t(np.array([0, 2, 0]), offs))
    np.testing.assert_array_equal(_np(got)[1:], np.asarray(
        j_update_pages_at(jnp.asarray(store), jnp.asarray(new),
                          jnp.asarray([0, 2, 0]), jnp.asarray(offs)))[1:])


def test_scatter_prefill_pages_and_copy_page_exact():
    rng = np.random.default_rng(2)
    ps = 4
    store = {key: rng.normal(size=(2, 9, 2, ps, 8)).astype(np.float32)
             for key in ("k", "v")}
    scratch = {key: rng.normal(size=(2, 3, 2, 3 * ps, 8)).astype(np.float32)
               for key in ("k", "v")}
    scratch["len"] = np.array([12, 5, 9], np.int32)
    slots = np.array([2, 0], np.int32)
    ids = np.array([[3, 7, 1], [5, 0, 0]], np.int32)   # slot 0: 1 page
    ref = j_scatter({k: jnp.asarray(v) for k, v in store.items()},
                    {k: jnp.asarray(v) for k, v in scratch.items()},
                    jnp.asarray(slots), jnp.asarray(ids))
    got = scatter_prefill_pages({k: torch.as_tensor(v.copy())
                                 for k, v in store.items()},
                                {k: torch.as_tensor(v)
                                 for k, v in scratch.items()}, slots, ids)
    for key in store:                     # the trash page 0 takes the tail
        np.testing.assert_array_equal(_np(got[key])[:, 1:],
                                      np.asarray(ref[key])[:, 1:])
    ref = j_copy_page(ref, 3, 8)
    got = copy_page(got, 3, 8)
    for key in store:
        np.testing.assert_array_equal(_np(got[key])[:, 1:],
                                      np.asarray(ref[key])[:, 1:])
