"""The audio family in the port (``repro_torch.models.whisper`` and
``layer_norm`` in ``repro_torch.models.common``) against repro's on the
CPU: whisper-small at ``tiny()`` (2 encoder and 4 decoder layers, d_model
128, 4/2 heads of 32, d_ff 256, 32 stub frames, f32), repro's weights
crossed to the port as numpy arrays by ``bridge.from_numpy_tree``.

Held at atol = rtol = 1e-4 (f32 sums in another order): ``layer_norm``
and the tanh GELU; the non-causal encoder and its statistics; whole-model
logits and the statistics of all 11 site kinds (encoder sites stacked
over the encoder's layers, decoder sites over the decoder's), float and
packed; ``prefill(frames=)`` with its self and cross caches, then decode
against repro's step by step and against a teacher-forced forward; one
train step's loss.  Held exactly: FAQ α and packed codes per site.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as R_ARCHS
from repro.core import QuantSpec as RSpec
from repro.core import quantize_model as r_quantize_model
from repro.core import run_calibration as r_run_calibration
from repro.models import common as rcommon
from repro.models.registry import build_model as r_build
from repro.train import trainer as r_trainer
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ARCHS
from repro_torch.core import (QuantSpec, QuantizedTensor, quantize_model,
                              run_calibration)
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.launch import quantize as quantize_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common as tcommon
from repro_torch.models.registry import build_model
from repro_torch.models.whisper import MAX_DEC_POS
from repro_torch.train.trainer import make_loss_fn

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper-small"
SPEC = dict(bits=4, group_size=64)
SITES = {"enc_attn_in", "enc_attn_out", "enc_mlp_in", "enc_mlp_down",
         "dec_attn_in", "dec_attn_out", "dec_mlp_in", "dec_mlp_down",
         "cross_q_in", "cross_kv_in", "cross_out"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (several xdist workers each spinning a
    full pool on the same cores are slow)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=what,
                               **TOL)


def _close_stats(got, want):
    assert set(got) == set(want)
    for site, st in want.items():
        for key, ref in st.items():
            assert tuple(got[site][key].shape) == ref.shape, (site, key)
            _close(got[site][key], ref, f"{site}/{key}")


def _frames(cfg, seed, b=2):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_len, cfg.d_model)) * 0.1).astype(np.float32)


_SETUP = {}


def _setup():
    """repro's tiny whisper, its float and FAQ-packed weights and
    statistics, and the port's model on the same numpy arrays (built
    once)."""
    if not _SETUP:
        cfg = R_ARCHS[ARCH].tiny()
        rm = r_build(cfg)
        rp = rm.init(jax.random.PRNGKey(0))
        batch = {"tokens": np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 24)).astype(np.int32),
            "frames": _frames(cfg, 1)}
        rs = r_run_calibration(rm.forward, rp,
                               [{k: jnp.asarray(v) for k, v in batch.items()}])
        rq, rrep = r_quantize_model(rp, rm.quant_site_map(), rs, method="faq",
                                    spec=RSpec(**SPEC), mode="packed")
        _SETUP.update(
            cfg=cfg, rm=rm, tm=build_model(ARCHS[ARCH].tiny()), batch=batch,
            float=(rp, from_numpy_tree(_to_np(rp), "cpu")),
            packed=(rq, from_numpy_tree(_to_np(rq), "cpu")),
            stats=(rs, from_numpy_tree(_to_np(rs), "cpu")), report=rrep)
    return _SETUP


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# -- primitives --------------------------------------------------------------

def test_layer_norm_and_tanh_gelu_match():
    """LayerNorm with bias (eps 1e-5, f32 inside, cast back) in f32 and
    bf16, and jax.nn.gelu's default tanh approximation."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 96)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(96).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    _close(tcommon.layer_norm(*(torch.as_tensor(a) for a in (x, w, b))),
           rcommon.layer_norm(*(jnp.asarray(a) for a in (x, w, b))), "f32")
    got = tcommon.layer_norm(torch.as_tensor(x).bfloat16(),
                             torch.as_tensor(w).bfloat16(),
                             torch.as_tensor(b).bfloat16())
    want = rcommon.layer_norm(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.05, rtol=1e-2)
    _close(F.gelu(torch.as_tensor(x), approximate="tanh"),
           jax.nn.gelu(jnp.asarray(x)), "gelu")


def test_encoder_is_non_causal_and_matches():
    """The encoder's output and statistics; changing the last frame changes
    every position's output (no causal mask)."""
    s = _setup()
    rp, tp = s["float"]
    frames = _frames(s["cfg"], 3)
    want, rstats = s["rm"].encode(rp, jnp.asarray(frames), collect=True)
    got, tstats = s["tm"].encode(tp, torch.as_tensor(frames), collect=True)
    _close(got, want, "memory")
    _close_stats(tstats, rstats)
    moved = frames.copy()
    moved[:, -1] += 1.0
    other, _ = s["tm"].encode(tp, torch.as_tensor(moved))
    assert bool(((other - got).abs().amax(-1) > 0).all())


# -- the model ---------------------------------------------------------------

def test_init_tree_and_bridge_match():
    """The port's init tree has repro's key paths and shapes; from_numpy_tree
    carries repro's float and packed trees across leaf for leaf."""
    s = _setup()
    tp = s["tm"].init(0, device="cpu")
    for port_tree, ref_tree in ((tp, s["float"][0]),
                                (s["float"][1], s["float"][0]),
                                (s["packed"][1], s["packed"][0])):
        want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
        got = dict(leaves_with_keys(port_tree))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        if port_tree is not tp:
            for key, leaf in got.items():
                assert np.array_equal(_np(leaf), want[key]), key
    assert s["tm"].quant_site_map() == s["rm"].quant_site_map()
    assert tuple(tp["dec_pos"].shape) == (MAX_DEC_POS, s["cfg"].d_model)


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_forward_logits_and_stats_match(kind):
    """Teacher-forced logits and the statistics of all 11 site kinds (the
    16-entry site map: Q, K and V share their input's site)."""
    s = _setup()
    rp, tp = s[kind]
    batch = {"tokens": np.random.default_rng(4).integers(
        0, s["cfg"].vocab_size, (2, 20)).astype(np.int32),
        "frames": _frames(s["cfg"], 5)}
    rl, raux = s["rm"].forward(rp, _jb(batch), collect_stats=True)
    tl, taux = s["tm"].forward(tp, _tb(batch), collect_stats=True)
    _close(tl, rl, "logits")
    _close_stats(taux["stats"], raux["stats"])
    assert set(taux["stats"]) == SITES
    assert taux["stats"]["enc_mlp_in"]["mean_abs"].shape[0] == \
        s["cfg"].n_encoder_layers
    assert taux["stats"]["cross_out"]["mean_abs"].shape[0] == \
        s["cfg"].n_layers


def test_calibration_stats_match():
    s = _setup()
    stats = run_calibration(s["tm"].forward, s["float"][1], [s["batch"]])
    _close_stats(stats, s["stats"][0])


def test_packed_quantization_matches_per_site():
    """FAQ α (the previews per stack), codes, scales, zeros and act_scale
    of every site; "fake" mode gives the packed model's logits."""
    s = _setup()
    rq = s["packed"][0]
    tq, rep = quantize_model(s["float"][1], s["tm"].quant_site_map(),
                             s["stats"][1], method="faq",
                             spec=QuantSpec(**SPEC), mode="packed")
    assert len(rep) == 16
    for path in s["tm"].quant_site_map():
        name = "/".join(path)
        got, want = tq, rq
        for key in path:
            got, want = got[key], want[key]
        assert isinstance(got, QuantizedTensor) and got.packed
        want_alpha = np.asarray(s["report"][name]["alpha"])
        np.testing.assert_array_equal(
            _np(rep[name]["alpha"]).reshape(want_alpha.shape), want_alpha)
        np.testing.assert_array_equal(_np(got.codes), np.asarray(want.codes))
        for field in ("scale", "zero", "act_scale"):
            _close(getattr(got, field), getattr(want, field), name + field)
    tf, _ = quantize_model(s["float"][1], s["tm"].quant_site_map(),
                           s["stats"][1], method="faq",
                           spec=QuantSpec(**SPEC), mode="fake")
    batch = _tb(s["batch"])
    np.testing.assert_allclose(_np(s["tm"].forward(tf, batch)[0]),
                               _np(s["tm"].forward(tq, batch)[0]), atol=1e-4)


def test_prefill_frames_and_decode_match():
    """prefill(frames=) of a 12-token prompt then 6 decode steps on the
    packed weights: logits against repro's each step, the self and cross
    caches, the first decode against a forward over prompt + token
    (tests/test_models_smoke.py's check) and the last against a forward
    over the whole sequence."""
    s = _setup()
    cfg, rm, tm = s["cfg"], s["rm"], s["tm"]
    rp, tp = s["packed"]
    rng = np.random.default_rng(6)
    b, t, max_len = 2, 12, 24
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    frames = _frames(cfg, 7)
    rl, rc = jax.jit(lambda p, x, c, f: rm.prefill(p, x, c, frames=f))(
        rp, jnp.asarray(toks), rm.init_cache(b, max_len), jnp.asarray(frames))
    tl, tc = tm.prefill(tp, torch.as_tensor(toks),
                        tm.init_cache(b, max_len, device="cpu"),
                        frames=torch.as_tensor(frames))
    _close(tl, rl, "prefill")
    for key in ("k", "v", "xk", "xv"):
        _close(tc[key], rc[key], key)
    fwd = lambda seq: tm.forward(tp, {"tokens": torch.as_tensor(seq),
                                      "frames": torch.as_tensor(frames)})[0]
    assert float((tl[:, 0] - fwd(toks)[:, -1]).abs().max()) < 1e-4
    r_decode = jax.jit(rm.decode_step)
    seq = [toks]
    for i in range(6):
        nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        seq.append(nxt)
        rl, rc = r_decode(rp, rc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(nxt))
        _close(tl, rl, f"decode {i}")
        np.testing.assert_array_equal(_np(tc["len"]), np.asarray(rc["len"]))
        if i == 0:
            lf = fwd(np.concatenate(seq, 1))
            assert float((tl[:, 0] - lf[:, -1]).abs().max()) < 1e-3
    for key in ("k", "v"):
        _close(tc[key], rc[key], key)
    _close(tl[:, 0], _np(fwd(np.concatenate(seq, 1))[:, -1]),
           "decode vs forward")


def test_one_train_step_loss_matches_reference():
    """Loss through the encoder, cross-attention and decoder, and gradients
    reaching both stacks and the positional tables."""
    s = _setup()
    rp, tp = s["float"]
    batch = dict(s["batch"], labels=s["batch"]["tokens"])
    r_loss, r_aux = r_trainer.make_loss_fn(s["rm"], 0.01)(rp, _jb(batch))
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, aux = make_loss_fn(s["tm"], 0.01)(tp, _tb(batch))
    loss.backward()
    _close(aux["ce"], r_aux["ce"], "ce")
    _close(loss, r_loss, "loss")
    for path in (("enc_blocks", "attn", "wq"), ("dec_blocks", "cross", "wk"),
                 ("dec_blocks", "w1"), ("enc_pos",), ("dec_pos",),
                 ("dec_blocks", "lnx_b")):
        leaf = tp
        for key in path:
            leaf = leaf[key]
        assert leaf.grad is not None and float(leaf.grad.abs().sum()) > 0, \
            path


def test_quantize_other_families_mirror():
    """tests/test_quant_e2e.py::test_quantize_other_families for whisper:
    FAQ at g 32 in "fake" mode over a frames + tokens batch, then a finite
    forward and a report per site."""
    s = _setup()
    stats = run_calibration(s["tm"].forward, s["float"][1], [s["batch"]])
    qp, rep = quantize_model(s["float"][1], s["tm"].quant_site_map(), stats,
                             method="faq", spec=QuantSpec(bits=4,
                                                          group_size=32),
                             mode="fake")
    logits, _ = s["tm"].forward(qp, _tb(s["batch"]))
    assert bool(torch.isfinite(logits[..., :s["cfg"].vocab_size]).all())
    assert sorted(rep) == sorted("/".join(p)
                                 for p in s["tm"].quant_site_map())


@pytest.mark.parametrize("cli", [quantize_cli, serve_cli, train_cli])
def test_clis_decline_whisper(cli):
    """The CLIs make token batches only, and whisper needs frames beside
    them: its --arch is refused (the reference's CLIs fail on it with a
    KeyError)."""
    with pytest.raises(SystemExit):
        cli.main(["--arch", ARCH, "--tiny", "--device", "cpu"])
