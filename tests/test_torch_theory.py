"""Theorem 1 (paper §2.3) on the port (``repro_torch.core.theory``): the
reference's two tests (``tests/test_theory.py``) with the port's torch
generator, and ``_true_error`` on numpy inputs against the reference's
(rtol 1e-4: norms of f32 products summed in another order; the pick is
the same).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import QuantSpec as RSpec
from repro.core.theory import _true_error as r_true_error
from repro_torch.core.quantizer import QuantSpec
from repro_torch.core.theory import (_true_error, theorem1_check,
                                     theorem1_win_rate)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: these tests run small torch ops in
    loops, and under pytest-xdist several workers each spinning a full
    thread pool on the same cores made them ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_theorem1_win_rate():
    """Under the theorem's scenario FAQ's fused scale beats AWQ's
    current-layer scale in a large majority of draws."""
    rate = theorem1_win_rate(n_seeds=16)
    assert rate >= 0.75, f"win rate {rate}"


def test_theorem1_single_instance():
    r = theorem1_check(torch.Generator().manual_seed(0))
    assert float(r.delta_awq) > 0 and float(r.delta_faq) > 0


def test_true_error_matches_reference():
    rng = np.random.default_rng(0)
    n, n_out = 256, 64
    chan = np.exp(rng.normal(size=n) * 1.2).astype(np.float32)
    chan[0] *= 20
    w = (rng.normal(size=(n, n_out)) * 0.1).astype(np.float32)
    a_true = (rng.normal(size=(512, n)) * chan).astype(np.float32)
    stat = (np.abs(rng.normal(size=n)) * chan + 0.1).astype(np.float32)
    calib = (rng.normal(size=(8, n)) * stat).astype(np.float32)
    got = _true_error(*(torch.as_tensor(x) for x in (a_true, w, stat, calib)),
                      QuantSpec(bits=3, group_size=128))
    want = r_true_error(*(jnp.asarray(x) for x in (a_true, w, stat, calib)),
                        RSpec(bits=3, group_size=128))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
