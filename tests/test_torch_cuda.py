"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and skips without one; the file
imports nothing of jax or repro so it also runs where only PyTorch is
installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: atol = rtol = 1e-4 (quant_matmul: k = 1600 f32 sums in
another order) or 1e-5 (attention), float32 inputs.
"""
import pytest
import torch

from repro_torch.core import QuantSpec, quantize_groupwise
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import quant_matmul as qm

pytestmark = pytest.mark.cuda


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


def test_flash_decode_matches_plain(dev):
    q = torch.randn(4, 1, 8, 64, device=dev)
    k, v = (torch.randn(4, 2, 300, 64, device=dev) for _ in range(2))
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
