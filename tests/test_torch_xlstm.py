"""The ssm family in the port (``repro_torch.models.xlstm`` and the mLSTM /
sLSTM half of ``repro_torch.models.ssm``) against repro's on the CPU:
xlstm-350m at ``tiny()`` (4 layers, d_model 128, 4 heads, d_inner 256 so
an mLSTM head of 64 and an sLSTM head of 32, an sLSTM block at layer 3,
f32), repro's weights crossed to the port as numpy arrays by
``bridge.from_numpy_tree``.

Held at atol = rtol = 1e-4 (f32 sums in another order): the chunked mLSTM
with and without a carried state at T 16 / 64 / 100 (100 pads the tail
and cuts two chunks) with its final state; the sLSTM scan, its seeded
final state, and the mLSTM / sLSTM decode steps with their states;
whole-model logits and every site's statistics, float and packed;
prefill, then decode against repro's step by step and against a forward;
one train step's loss.  Held exactly: FAQ α and packed codes per site,
greedy serving tokens at 4 slots against repro's engine, serve ==
``generate`` through the exact-length admission, spec and paged
declined; ``write_slot`` / ``merge_slots`` over the list-valued sLSTM
state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.core import QuantSpec as RSpec
from repro.core import quantize_model as r_quantize_model
from repro.core import run_calibration as r_run_calibration
from repro.models import ssm as rssm
from repro.models import xlstm as rxlstm
from repro.models.registry import build_model as r_build
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.train import trainer as r_trainer
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ARCHS
from repro_torch.core import (QuantSpec, QuantizedTensor, quantize_model,
                              run_calibration)
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.launch import quantize as quantize_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import build_model
from repro_torch.serve.cache_ops import merge_slots, write_slot
from repro_torch.serve.draft import self_int8_draft
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig
from repro_torch.train.trainer import make_loss_fn

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "xlstm-350m"
SPEC = dict(bits=4, group_size=64)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (small torch ops in loops; several
    xdist workers each spinning a full pool on the same cores are slow)."""
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


_SETUP = {}


def _setup():
    """repro's tiny xLSTM, its float and FAQ-packed weights and statistics,
    and the port's model on the same numpy arrays (built once)."""
    if not _SETUP:
        cfg = R_ARCHS[ARCH].tiny()
        rm = r_build(cfg)
        rp = rm.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)) \
            .astype(np.int32)
        rs = r_run_calibration(rm.forward, rp, [{"tokens": jnp.asarray(toks)}])
        rq, rrep = r_quantize_model(rp, rm.quant_site_map(), rs, method="faq",
                                    spec=RSpec(**SPEC), mode="packed")
        _SETUP.update(
            cfg=cfg, rm=rm, tm=build_model(ARCHS[ARCH].tiny()), toks=toks,
            float=(rp, from_numpy_tree(_to_np(rp), "cpu")),
            packed=(rq, from_numpy_tree(_to_np(rq), "cpu")),
            stats=(rs, from_numpy_tree(_to_np(rs), "cpu")), report=rrep)
    return _SETUP


def _branch(kind, l):
    """Layer ``l``'s (repro, port) parameters of the ``kind`` block."""
    rp, tp = _setup()["float"]
    return ({k: v[l] for k, v in rp["blocks"][kind].items()},
            {k: v[l] for k, v in tp["blocks"][kind].items()})


# -- primitives --------------------------------------------------------------

@pytest.mark.parametrize("t", [16, 64, 100])
def test_mlstm_chunked_matches(t):
    """Layer 0's mLSTM over T tokens (chunk = min(64, T): one chunk at 16
    and 64, two with a padded tail at 100): the output and both
    statistics from the zero state, then the output and final (C, n) from
    a random carried state."""
    s = _setup()
    rl, tl = _branch("mlstm", 0)
    h = s["cfg"].n_heads
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, s["cfg"].d_model)).astype(np.float32)
    seen, rseen = {}, {}
    out = tssm.mlstm_chunked(tl, torch.as_tensor(x), h,
                             collect_cb=lambda n, a: seen.__setitem__(n, a))
    want = rssm.mlstm_chunked(rl, jnp.asarray(x), h,
                              collect_cb=lambda n, a: rseen.__setitem__(n, a))
    _close(out, want, "out")
    _close(seen["mlstm_out"], rseen["mlstm_out"], "mlstm_out")
    _close(seen["mlstm_in"], rssm._mlstm_qkvg(rl, jnp.asarray(x), h)[6],
           "mlstm_in")
    hd = tl["wq"].shape[-1] // h
    st = {"C": rng.standard_normal((2, h, hd, hd)).astype(np.float32) * 0.1,
          "n": rng.standard_normal((2, h, hd)).astype(np.float32)}
    out, new = tssm.mlstm_chunked(
        tl, torch.as_tensor(x), h, return_state=True,
        state={k: torch.as_tensor(v) for k, v in st.items()})
    want, rnew = rssm.mlstm_chunked(
        rl, jnp.asarray(x), h, return_state=True,
        state={k: jnp.asarray(v) for k, v in st.items()})
    _close(out, want, "seeded out")
    for key in ("C", "n"):
        _close(new[key], rnew[key], f"final {key}")


def test_slstm_scan_and_recurrent_steps_match():
    """Layer 3's sLSTM scan (output, statistic) from the zero state and its
    final state from a random one, then three sLSTM and three mLSTM decode
    steps with their states."""
    s = _setup()
    h, d = s["cfg"].n_heads, s["cfg"].d_model
    rl, tl = _branch("slstm", 3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    seen, rseen = {}, {}
    out = tssm.slstm_scan(tl, torch.as_tensor(x), h,
                          collect_cb=lambda n, a: seen.__setitem__(n, a))
    _close(out, rssm.slstm_scan(
        rl, jnp.asarray(x), h,
        collect_cb=lambda n, a: rseen.__setitem__(n, a)), "scan")
    _close(seen["slstm_out"], rseen["slstm_out"], "slstm_out")
    hd = d // h
    st0 = [rng.standard_normal((2, h, hd)).astype(np.float32) * 0.5
           for _ in range(3)] + [rng.standard_normal((2, h, hd))
                                 .astype(np.float32)]
    rout, rst = rxlstm._slstm_scan_final(rl, jnp.asarray(x), h,
                                         [jnp.asarray(a) for a in st0])
    tout, tst = tssm.slstm_scan_final(tl, torch.as_tensor(x), h,
                                      [torch.as_tensor(a) for a in st0])
    _close(tout, rout, "final out")
    for i in range(4):
        _close(tst[i], rst[i], f"final state {i}")
    rml, tml = _branch("mlstm", 1)
    hdm = tml["wq"].shape[-1] // h
    rmst = {"C": jnp.zeros((2, h, hdm, hdm)), "n": jnp.zeros((2, h, hdm))}
    tmst = tssm.mlstm_state_init(2, h, hdm, "cpu")
    for i in range(3):
        xi = rng.standard_normal((2, 1, d)).astype(np.float32)
        rout, rst = rssm.slstm_step(rl, jnp.asarray(xi), rst, h)
        tout, tst = tssm.slstm_step(tl, torch.as_tensor(xi), tst, h)
        _close(tout, rout, f"slstm step {i}")
        for j in range(4):
            _close(tst[j], rst[j], f"slstm step {i} state {j}")
        rout, rmst = rssm.mlstm_step(rml, jnp.asarray(xi), rmst, h)
        tout, tmst = tssm.mlstm_step(tml, torch.as_tensor(xi), tmst, h)
        _close(tout, rout, f"mlstm step {i}")
        for key in ("C", "n"):
            _close(tmst[key], rmst[key], f"mlstm step {i} {key}")


# -- the model ---------------------------------------------------------------

def test_init_tree_and_bridge_carry_both_branches():
    """The port's init tree has repro's key paths and shapes (both branches
    in every layer); from_numpy_tree carries repro's float and packed trees
    across leaf for leaf; the head widths and the sLSTM layers."""
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
    assert [s["tm"]._is_slstm(l) for l in range(4)] == \
        [bool(f) for f in s["rm"]._slstm_flags()]
    cache = s["tm"].init_cache(2, 16, device="cpu")
    assert tuple(cache["mlstm"]["C"].shape) == (4, 2, 4, 64, 64)
    assert [tuple(a.shape) for a in cache["slstm"]] == [(4, 2, 4, 32)] * 4
    assert float(cache["slstm"][3].max()) == -1e9
    full = build_model(ARCHS[ARCH])
    assert full._d_inner // full.cfg.n_heads == 512
    assert full.cfg.d_model // full.cfg.n_heads == 256


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_forward_logits_and_stats_match(kind):
    """T 70: one whole chunk and a padded one in every mLSTM layer; the
    statistics of both branches in every layer."""
    s = _setup()
    rp, tp = s[kind]
    toks = np.random.default_rng(4).integers(0, s["cfg"].vocab_size, (2, 70)) \
        .astype(np.int32)
    rl, raux = s["rm"].forward(rp, {"tokens": jnp.asarray(toks)},
                               collect_stats=True)
    tl, taux = s["tm"].forward(tp, {"tokens": torch.as_tensor(toks)},
                               collect_stats=True)
    _close(tl, rl, "logits")
    _close_stats(taux["stats"], raux["stats"])
    assert set(taux["stats"]) == {"xin", "m_qkv", "m_out", "s_out"}


def test_calibration_stats_match():
    """run_calibration over the setup's batch gives repro's statistics."""
    s = _setup()
    stats = run_calibration(s["tm"].forward, s["float"][1],
                            [{"tokens": s["toks"]}])
    _close_stats(stats, s["stats"][0])


def test_packed_quantization_matches_per_site():
    """FAQ α, codes, scales, zeros and act_scale of every site: the port's
    FAQ on repro's statistics gives repro's packed tree; "fake" mode's
    dequantized float leaves give the packed model's logits."""
    s = _setup()
    rq = s["packed"][0]
    tq, rep = quantize_model(s["float"][1], s["tm"].quant_site_map(),
                             s["stats"][1], method="faq",
                             spec=QuantSpec(**SPEC), mode="packed")
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
    assert not isinstance(tq["blocks"]["mlstm"]["w_gates"], QuantizedTensor)
    tf, _ = quantize_model(s["float"][1], s["tm"].quant_site_map(),
                           s["stats"][1], method="faq",
                           spec=QuantSpec(**SPEC), mode="fake")
    batch = {"tokens": torch.as_tensor(s["toks"])}
    np.testing.assert_allclose(_np(s["tm"].forward(tf, batch)[0]),
                               _np(s["tm"].forward(tq, batch)[0]), atol=1e-4)


def test_prefill_and_decode_match():
    """A 70-token prompt (the mLSTM's tail padded) then 6 decode steps on
    the packed weights: logits and every state leaf against repro's each
    step; the first decode against a forward over prompt + token
    (tests/test_models_smoke.py's check) and the last against a forward
    over the whole sequence."""
    s = _setup()
    cfg, rm, tm = s["cfg"], s["rm"], s["tm"]
    rp, tp = s["packed"]
    rng = np.random.default_rng(5)
    b, t = 2, 70
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    rl, rc = jax.jit(rm.prefill)(rp, jnp.asarray(toks), rm.init_cache(b, 80))
    tl, tc = tm.prefill(tp, torch.as_tensor(toks),
                        tm.init_cache(b, 80, device="cpu"))
    _close(tl, rl, "prefill")
    full, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    assert float((tl[:, 0] - full[:, -1]).abs().max()) < 1e-4
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
            lf, _ = tm.forward(tp, {"tokens": torch.as_tensor(
                np.concatenate(seq, 1))})
            assert float((tl[:, 0] - lf[:, -1]).abs().max()) < 1e-3
    for key in ("C", "n"):
        _close(tc["mlstm"][key], rc["mlstm"][key], key)
    for i in range(4):
        _close(tc["slstm"][i], rc["slstm"][i], f"slstm {i}")
    full, _ = tm.forward(tp, {"tokens": torch.as_tensor(np.concatenate(seq,
                                                                       1))})
    _close(tl[:, 0], _np(full[:, -1]), "decode vs forward")


def _r_tf_logits(m, p, seq, t):
    """repro: the prefill over ``seq[:, :t]`` and a decode step fed each
    later token, beside a forward over ``seq``: (decode, forward) logits
    at positions t-1.., (N, V) f32 each."""
    v = m.cfg.vocab_size
    lg, c = jax.jit(m.prefill)(p, jnp.asarray(seq[:, :t]),
                               m.init_cache(1, seq.shape[1] + 1))
    rows = [lg[0, 0]]
    step = jax.jit(m.decode_step)
    for i in range(t, seq.shape[1]):
        lg, c = step(p, c, jnp.asarray(seq[:, i:i + 1]))
        rows.append(lg[0, 0])
    full = jax.jit(m.forward)(p, {"tokens": jnp.asarray(seq)})[0][0, t - 1:]
    f32 = lambda a: np.asarray(jnp.asarray(a)[..., :v].astype(jnp.float32))
    return f32(jnp.stack(rows)), f32(full)


def _t_tf_logits(m, p, seq, t):
    """:func:`_r_tf_logits` for the port."""
    v = m.cfg.vocab_size
    with torch.no_grad():
        lg, c = m.prefill(p, torch.as_tensor(seq[:, :t]),
                          m.init_cache(1, seq.shape[1] + 1, device="cpu"))
        rows = [lg[0, 0]]
        for i in range(t, seq.shape[1]):
            lg, c = m.decode_step(p, c, torch.as_tensor(seq[:, i:i + 1]))
            rows.append(lg[0, 0])
        full = m.forward(p, {"tokens": torch.as_tensor(seq)})[0][0, t - 1:]
    f32 = lambda a: a[..., :v].float().numpy()
    return f32(torch.stack(rows)), f32(full)


# chip_smoke.py's tie tolerance, and its limit on the bf16 decode's rounding
# noise over the bf16 forward's (XLSTM_BF16_NOISE_RATIO there)
TIE_TOL = 4 * 2.0 ** -5
BF16_NOISE_RATIO = 1.25


def test_bf16_decode_drift_is_the_references():
    """In bf16 the recurrent decode and the chunked forward round the same
    function differently, and over xlstm-350m's 24 layers the reference's
    own two part by more than TIE_TOL, so a bf16 decode cannot be held
    greedy up to TIE_TOL against a bf16 forward.  At tiny() width and 24
    layers in bf16, repro's seed-0 weights, a 200-token prompt and 31
    teacher-forced decode steps, each package also run with f32
    activations on the same (bf16-valued) weights:

    - the reference's decode and forward differ by more than TIE_TOL;
    - the port's bf16 rounding noise (RMS of bf16 - f32 logits) is within
      BF16_NOISE_RATIO of the reference's, for decode and for forward;
    - in both packages the decode's noise is within BF16_NOISE_RATIO of
      the forward's: the limit chip_smoke.py holds the card's bf16 decode
      to at full width;
    - the port's bf16 decode is nearer the reference's bf16 decode than
      the reference's is to its own f32 run.

    Readings over seeds 0-3 (this test: seed 0): reference decode vs
    forward 0.24-0.62, port 0.04-0.42; noise port / reference 0.91-1.15;
    decode / forward noise 0.99-1.02 (reference), 1.00 (port); port -
    reference over reference - f32 0.51-0.82."""
    rcfg = R_ARCHS[ARCH].tiny().scaled(n_layers=24, dtype="bfloat16")
    tcfg = ARCHS[ARCH].tiny().scaled(n_layers=24, dtype="bfloat16")
    rm, rm32 = r_build(rcfg), r_build(rcfg.scaled(dtype="float32"))
    tm, tm32 = build_model(tcfg), build_model(tcfg.scaled(dtype="float32"))
    rp = rm.init(jax.random.PRNGKey(0))
    to32 = lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a
    tp = from_numpy_tree(_to_np(rp), "cpu")
    tp32 = jax.tree_util.tree_map(
        lambda a: a.float() if a.dtype == torch.bfloat16 else a, tp)
    seq = np.random.default_rng(0).integers(0, rcfg.vocab_size, (1, 231)) \
        .astype(np.int32)
    r16 = _r_tf_logits(rm, rp, seq, 200)
    r32 = _r_tf_logits(rm32, jax.tree_util.tree_map(to32, rp), seq, 200)
    t16 = _t_tf_logits(tm, tp, seq, 200)
    t32 = _t_tf_logits(tm32, tp32, seq, 200)
    rms = lambda a, b: float(np.sqrt(np.mean((a - b) ** 2)))
    # (decode, forward) noise of each package's bf16 run against its f32
    r_noise = [rms(a, b) for a, b in zip(r16, r32)]
    t_noise = [rms(a, b) for a, b in zip(t16, t32)]
    r_drift = float(np.abs(r16[0] - r16[1]).max())
    assert r_drift > TIE_TOL, r_drift
    for what, t, r in zip(("decode", "forward"), t_noise, r_noise):
        assert 1 / BF16_NOISE_RATIO <= t / r <= BF16_NOISE_RATIO, (what, t, r)
    for noise in (r_noise, t_noise):
        assert noise[0] <= BF16_NOISE_RATIO * noise[1], noise
    assert rms(t16[0], r16[0]) <= r_noise[0], (rms(t16[0], r16[0]), r_noise)


def test_one_train_step_loss_matches_reference():
    """Loss through both recurrences, and gradients reaching the mLSTM's
    gates and the sLSTM's recurrent weights."""
    s = _setup()
    rp, tp = s["float"]
    toks = s["toks"]
    batch = {"tokens": toks, "labels": toks}
    r_loss, r_aux = r_trainer.make_loss_fn(s["rm"], 0.01)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, aux = make_loss_fn(s["tm"], 0.01)(
        tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    _close(aux["ce"], r_aux["ce"], "ce")
    _close(loss, r_loss, "loss")
    for kind, name in (("mlstm", "w_gates"), ("mlstm", "wq"),
                       ("slstm", "r"), ("slstm", "w_in")):
        grad = tp["blocks"][kind][name].grad
        assert grad is not None and float(grad.abs().sum()) > 0, name


def test_quantize_other_families_mirror():
    """tests/test_quant_e2e.py::test_quantize_other_families for xlstm: FAQ
    at g 32 in "fake" mode, then a finite forward and a report per site."""
    s = _setup()
    stats = run_calibration(s["tm"].forward, s["float"][1],
                            [{"tokens": s["toks"]}])
    qp, rep = quantize_model(s["float"][1], s["tm"].quant_site_map(), stats,
                             method="faq", spec=QuantSpec(bits=4,
                                                          group_size=32),
                             mode="fake")
    logits, _ = s["tm"].forward(qp, {"tokens": torch.as_tensor(s["toks"])})
    assert bool(torch.isfinite(logits[..., :s["cfg"].vocab_size]).all())
    assert sorted(rep) == sorted("/".join(p)
                                 for p in s["tm"].quant_site_map())


def test_list_cache_ops_write_and_merge_slots():
    """write_slot / merge_slots walk the mlstm dict and the slstm list with
    the batch on axis 1 of every leaf but ``len``."""
    tm = _setup()["tm"]
    big = tm.init_cache(3, 24, device="cpu")
    one = tm.init_cache(1, 24, device="cpu")
    for _, leaf in leaves_with_keys(one):
        leaf.fill_(7)
    write_slot(big, one, 1)
    keys = [k for k, _ in leaves_with_keys(big)]
    assert "['slstm'][3]" in keys and "['mlstm']['C']" in keys
    for key, leaf in leaves_with_keys(big):
        rows = leaf if leaf.dim() == 1 else leaf.transpose(0, 1)
        assert bool((rows[1] == 7).all()), key
        assert not bool((rows[0] == 7).any()), key
    new = tm.init_cache(3, 24, device="cpu")
    for _, leaf in leaves_with_keys(new):
        leaf.fill_(3)
    merge_slots(big, new, torch.tensor([True, False, False]))
    for key, leaf in leaves_with_keys(big):
        rows = leaf if leaf.dim() == 1 else leaf.transpose(0, 1)
        assert bool((rows[0] == 3).all()) and bool((rows[1] == 7).all()), key
        assert not bool(((rows[2] == 3) | (rows[2] == 7)).any()), key


# -- serving -----------------------------------------------------------------

def test_serve_tokens_match_reference_engine():
    """Six requests of 5 and 70 tokens at 4 slots (slots freed and
    re-admitted while others decode), on the packed weights: the same
    greedy tokens as repro's engine."""
    s = _setup()
    rq, tq = s["packed"]
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, s["cfg"].vocab_size, size=n), m)
            for i, (n, m) in enumerate([(5, 9), (70, 4), (5, 6), (70, 8),
                                        (5, 3), (70, 5)])]
    kw = dict(n_slots=4, max_len=96)
    rres = RServeEngine(s["rm"], rq, **kw).serve(
        [RRequest(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
    tres = ServeEngine(s["tm"], tq, device="cpu", **kw).serve(
        [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
    for i, _, m in reqs:
        assert len(tres[i]) == m
        np.testing.assert_array_equal(tres[i], np.asarray(rres[i]))


def test_single_admission_serves_as_generate_and_spec_paged_decline():
    """No prompt_len prefill: the engine admits one request at a time and
    serve == generate; spec is declined and paged=True serves from the
    dense state, with the same tokens."""
    s = _setup()
    tm, tp = s["tm"], s["float"][1]
    assert not tm.supports_spec() and not tm.supports_paged()
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, s["cfg"].vocab_size,
                                               size=5 + 4 * i),
                    max_new_tokens=3 + i) for i in range(3)]
    mk = lambda: [Request(rid=r.rid, prompt=r.prompt,
                          max_new_tokens=r.max_new_tokens) for r in reqs]
    eng = ServeEngine(tm, tp, n_slots=2, max_len=48, device="cpu")
    assert not eng._supports_plen
    assert type(eng._admission.strategies[0]).__name__ == "SingleAdmission"
    batched = eng.serve(mk())
    for r in reqs:
        np.testing.assert_array_equal(batched[r.rid], eng.generate(r))
    spec = ServeEngine(tm, tp, n_slots=2, max_len=48, device="cpu",
                       spec=SpecConfig(k=3, draft=self_int8_draft(tm, tp)))
    assert spec._spec is None and not spec.metrics()["spec"]
    paged = ServeEngine(tm, tp, n_slots=2, max_len=48, device="cpu",
                        paged=True)
    assert not paged.paged
    for out in (spec.serve(mk()), paged.serve(mk())):
        for r in reqs:
            np.testing.assert_array_equal(out[r.rid], batched[r.rid])


def test_quantize_and_serve_clis_on_cpu():
    qparams, report = quantize_cli.main(["--arch", ARCH, "--tiny", "--device",
                                         "cpu", "--calib-n", "2"])
    assert isinstance(qparams["blocks"]["slstm"]["w_in"], QuantizedTensor)
    assert "blocks/mlstm/down_proj" in report
    out = serve_cli.main(["--arch", ARCH, "--tiny", "--requests", "2",
                          "--new-tokens", "4", "--calib-n", "2",
                          "--device", "cpu"])
    assert sorted(out) == [0, 1]
    assert all(len(v) == 4 and (np.asarray(v) < 512).all()
               for v in out.values())
