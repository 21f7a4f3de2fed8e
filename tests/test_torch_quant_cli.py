"""The port's quantization surface beyond the main path, on the CPU:
``storage_bits``, ``full_search_faq`` (paper Eq. 8),
``launch.quantize`` (work units, the per-process split, ``--out``) and
``launch.serve --ckpt-dir``, against the reference.

Bars: full_search_faq picks the reference's (γ, j, α) per layer with its
loss within 1e-5 relative (f32 sums in another order) — in the last
layer, which has no future layers, every (γ, j) gives the same statistic
up to rounding, so there α and the loss are held and (γ, j) is not; the work units are
the reference's; the union of two processes' shares is the one-process
result bit for bit; the packed tree ``--out`` writes restores in the
reference bit for bit; serving a checkpoint gives the reference's tokens
for the same checkpoint.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.core import QuantSpec as RSpec
from repro.core.methods import full_search_faq as r_full_search
from repro.core.quantizer import QuantizedTensor as RQuantizedTensor
from repro.dist import checkpoint as r_ckpt
from repro.launch import quantize as r_quantize_cli
from repro.launch import serve as r_serve_cli
from repro.models.registry import build_model as r_build
from repro_torch.configs import ARCHS
from repro_torch.core import (QuantSpec, QuantizedTensor, fuse_stats,
                              quantize_groupwise, run_calibration,
                              search_alpha, storage_bits)
from repro_torch.core.methods import full_search_faq
from repro_torch.data.synthetic import calibration_batches
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.launch import quantize as quantize_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import data_for
from repro_torch.models.registry import build_model


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: these tests run small torch ops in
    loops, and under pytest-xdist several workers each spinning a full
    thread pool on the same cores made them ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_storage_bits_packed():
    w = torch.randn(1024, 1024, generator=torch.Generator().manual_seed(3))
    qt = quantize_groupwise(w, QuantSpec(bits=4, group_size=128), pack=True)
    assert 4.0 < storage_bits(qt) < 5.0  # 4 bits + group metadata overhead
    with_act = quantize_groupwise(w, QuantSpec(bits=4, group_size=128),
                                  act_scale=torch.ones(1024), pack=True)
    assert storage_bits(with_act) == storage_bits(qt) + 32 / 1024


def _search_inputs(seed):
    rng = np.random.default_rng(seed)
    L, n, m = 3, 128, 32
    w = rng.normal(size=(L, n, m)).astype(np.float32)
    stats = (np.abs(rng.normal(size=(L, n))) + 0.1).astype(np.float32)
    return w, stats, stats ** 2


def test_full_search_no_worse_than_presearched():
    """Eq. 8's joint search achieves <= the pre-searched config's loss."""
    w, stats, msq = (torch.as_tensor(x) for x in _search_inputs(4))
    spec = QuantSpec(bits=3, group_size=64)
    best = full_search_faq(w, stats, spec, mean_sq=msq)
    fused = fuse_stats(stats, 0.85, 3)
    pre = torch.stack([search_alpha(w[l], fused[l], spec, mean_sq=msq[l]).loss
                       for l in range(w.shape[0])])
    assert bool((best["loss"] <= pre + 1e-6).all())


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_full_search_matches_reference(seed):
    w, stats, msq = _search_inputs(seed)
    got = full_search_faq(*(torch.as_tensor(x) for x in (w, stats)),
                          QuantSpec(bits=3, group_size=64),
                          mean_sq=torch.as_tensor(msq))
    want = r_full_search(jnp.asarray(w), jnp.asarray(stats),
                         RSpec(bits=3, group_size=64),
                         mean_sq=jnp.asarray(msq))
    # the last layer has no future: every (gamma, j) fuses to its own
    # statistic up to rounding, so their losses tie within an ulp or two
    # and which combination wins there is rounding noise in either
    # package; every other layer's (gamma, j) is the reference's exactly
    for key in ("gamma", "window"):
        assert np.array_equal(got[key].numpy()[:-1],
                              np.asarray(want[key])[:-1]), key
    assert np.array_equal(got["alpha"].numpy(), np.asarray(want["alpha"]))
    assert got["window"].dtype == torch.int32
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["act_scale"].numpy(),
                               np.asarray(want["act_scale"]), rtol=1e-5)


@pytest.fixture(scope="module")
def calibrated():
    cfg = ARCHS["llama3-8b"].tiny()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    stats = run_calibration(model.forward, params,
                            calibration_batches(data_for(cfg), 2, 64))
    return model, params, stats


def test_work_units_match_reference(calibrated):
    model = calibrated[0]
    r_model = r_build(R_ARCHS["llama3-8b"].tiny())
    assert quantize_cli.work_units(model.quant_site_map()) == \
        r_quantize_cli.work_units(r_model.quant_site_map())


def test_two_process_shares_union_to_one_process(calibrated):
    model, params, stats = calibrated
    spec = QuantSpec(bits=4, group_size=64)
    whole, rep1, owned1 = quantize_cli.quantize_distributed(
        model, params, stats, spec=spec)
    shares = [quantize_cli.quantize_distributed(
        model, params, stats, spec=spec, process_index=pi, process_count=2)
        for pi in range(2)]
    assert sorted(shares[0][2] + shares[1][2]) == sorted(owned1)
    assert not set(shares[0][2]) & set(shares[1][2])
    for pi in range(2):
        part, rep, owned = shares[pi]
        for path in owned:
            a, b = part["blocks"][path.split("/")[1]], \
                whole["blocks"][path.split("/")[1]]
            assert isinstance(a, QuantizedTensor)
            assert all(torch.equal(x, y) for (_, x), (_, y) in
                       zip(leaves_with_keys(a), leaves_with_keys(b)))
            assert torch.equal(rep[path]["alpha"], rep1[path]["alpha"])


def _repro_tree(tree):
    """A reference tree of the same structure (zeros), as a restore
    target."""
    if isinstance(tree, dict):
        return {k: _repro_tree(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        z = lambda t: None if t is None else jnp.zeros(tuple(t.shape))
        return RQuantizedTensor(
            codes=z(tree.codes), scale=z(tree.scale), zero=z(tree.zero),
            spec=RSpec(tree.spec.bits, tree.spec.group_size,
                       tree.spec.symmetric),
            n_in=tree.n_in, packed=tree.packed, act_scale=z(tree.act_scale))
    return jnp.zeros(tuple(tree.shape))


def test_quantize_cli_out_restores_in_reference(tmp_path, capsys):
    qparams, _ = quantize_cli.main(["--tiny", "--device", "cpu",
                                    "--calib-n", "2", "--out",
                                    str(tmp_path)])
    assert "saved to" in capsys.readouterr().out
    r_q = _repro_tree(qparams)
    restored = r_ckpt.restore(str(tmp_path), 0, {"qparams": r_q})["qparams"]
    want = dict(leaves_with_keys(qparams))
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(got) == len(want)
    for path, leaf in got:
        mine = want[jax.tree_util.keystr(path)]
        if mine.dtype == torch.bfloat16:
            mine = mine.view(torch.int16)
            leaf = np.asarray(leaf).view(np.int16)
        assert np.array_equal(mine.numpy(), np.asarray(leaf))
    back = ckpt.restore(str(tmp_path), 0, {"qparams": qparams})["qparams"]
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves_with_keys(back), leaves_with_keys(qparams)))


def test_serve_ckpt_dir_matches_reference(tmp_path, capsys, monkeypatch):
    """A checkpoint of trained-looking params (the reference's init at
    another key) written by the reference; both CLIs serve it with
    --ckpt-dir and give the same greedy tokens."""
    r_model = r_build(R_ARCHS["llama3-8b"].tiny())
    r_params = r_model.init(jax.random.PRNGKey(7))
    r_ckpt.save(str(tmp_path), 3, {"params": r_params})
    argv = ["--tiny", "--ckpt-dir", str(tmp_path), "--requests", "2",
            "--new-tokens", "4", "--calib-n", "2"]
    ours = serve_cli.main(argv + ["--device", "cpu"])
    assert "loaded checkpoint step 3" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    r_serve_cli.main()
    out = capsys.readouterr().out
    theirs = {int(m.group(1)): [int(t) for t in m.group(2).split(",")]
              for m in re.finditer(r"req (\d+): \[([^\]]*)\]", out)}
    assert sorted(theirs) == sorted(ours) == [0, 1]
    for rid, toks in theirs.items():
        assert np.asarray(ours[rid]).tolist() == toks, rid
