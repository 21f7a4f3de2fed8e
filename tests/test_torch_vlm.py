"""The VLM family in the port (``repro_torch.models.vlm``, M-RoPE in
``models/common.py``) against repro's on the CPU: qwen2-vl-2b at
``tiny()`` (4 layers, d_model 128, 4/2 heads of 32, 8 stub patches, f32),
repro's weights crossed to the port as numpy arrays by
``bridge.from_numpy_tree``.

Held at atol = rtol = 1e-4 (f32 sums in another order): M-RoPE with three
different position rows (hd 32 and qwen2-vl's hd 128 sections), and
through a model's attention; whole-model logits over the token positions
and every site's statistics with patches prepended, float and packed;
prefill with patches and decode; one train step's loss.  Held exactly:
FAQ α and packed codes per site, greedy serving tokens at 1 and 2 slots
against repro's engine, spec declined.
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
from repro.models import common as rcommon
from repro.models.dense import DenseLM as RDenseLM
from repro.models.registry import build_model as r_build
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.train import trainer as r_trainer
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, QuantizedTensor, quantize_model
from repro_torch.launch import quantize as quantize_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common as tcommon
from repro_torch.models.dense import DenseLM
from repro_torch.models.registry import build_model
from repro_torch.serve.draft import self_int8_draft
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig
from repro_torch.train.trainer import make_loss_fn

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen2-vl-2b"
SPEC = dict(bits=4, group_size=64)


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


def _positions3(b, t, seed):
    """Three different (B, T) id rows: temporal, height, width."""
    rng = np.random.default_rng(seed)
    return np.stack([np.broadcast_to(np.arange(t), (b, t)),
                     rng.integers(0, 7, (b, t)),
                     rng.integers(0, 11, (b, t))]).astype(np.int32)


_SETUP = {}


def _setup():
    """repro's tiny VLM, its float and FAQ-packed weights (calibrated with
    patches) and statistics, and the port's model on the same arrays."""
    if not _SETUP:
        cfg = R_ARCHS[ARCH].tiny()
        rm = r_build(cfg)
        rp = rm.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24))
                 .astype(np.int32),
                 "patches": (rng.standard_normal((2, cfg.patch_len,
                                                  cfg.d_model)) * 0.1)
                 .astype(np.float32)}
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


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- M-RoPE ------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24)),
                                         (32, None)])
def test_apply_rope_matches(hd, sections):
    """Three different id rows rotate their own sections; the same row
    three times is standard RoPE."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = _positions3(2, 9, hd) if sections else _positions3(2, 9, hd)[0]
    want = rcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              mrope_sections=sections)
    got = tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                             mrope_sections=sections)
    _close(got, want, "rope")
    if sections:
        text = np.broadcast_to(pos[0], pos.shape).copy()
        same = tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(text),
                                  1e6, mrope_sections=sections)
        plain = tcommon.apply_rope(torch.as_tensor(x),
                                   torch.as_tensor(pos[0]), 1e6)
        assert torch.equal(same, plain)
        assert not np.allclose(_np(got), _np(plain), atol=1e-3)


def test_mrope_positions_through_the_attention():
    """A dense forward with (3, B, T) ids of three different rows in the
    batch, sections (4, 6, 6) over hd/2 = 16: the sections reach both
    rotations of every layer."""
    cfg = R_ARCHS[ARCH].tiny().scaled(family="dense", mrope_sections=(4, 6, 6))
    rm = RDenseLM(cfg)
    rp = rm.init(jax.random.PRNGKey(1))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)) \
        .astype(np.int32)
    batch = {"tokens": toks, "positions": _positions3(2, 12, 3)}
    want, _ = rm.forward(rp, _j(batch))
    tm = DenseLM(ARCHS[ARCH].tiny().scaled(family="dense",
                                           mrope_sections=(4, 6, 6)))
    tp = from_numpy_tree(_to_np(rp), "cpu")
    _close(tm.forward(tp, _t(batch))[0], want, "logits")
    text = dict(batch, positions=np.broadcast_to(
        batch["positions"][0], (3, 2, 12)).copy())
    _close(tm.forward(tp, _t(text))[0], tm.forward(tp, _t(dict(
        tokens=toks)))[0], "text ids")


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float", "packed"])
def test_forward_logits_and_stats_match(kind):
    """Patches prepended: logits over the 24 token positions, statistics
    over all 32 positions."""
    s = _setup()
    rp, tp = s[kind]
    rl, raux = s["rm"].forward(rp, _j(s["batch"]), collect_stats=True)
    tl, taux = s["tm"].forward(tp, _t(s["batch"]), collect_stats=True)
    assert tuple(tl.shape[:2]) == (2, 24)
    _close(tl, rl, "logits")
    _close_stats(taux["stats"], raux["stats"])
    assert s["tm"].quant_site_map() == s["rm"].quant_site_map()


def test_prefill_with_patches_and_decode_match():
    """prefill(patches=...) and three decode steps on the packed weights
    against repro's, the cache included; the first decode's logits against
    a forward over patches + tokens."""
    s = _setup()
    cfg, rm, tm = s["cfg"], s["rm"], s["tm"]
    rp, tp = s["packed"]
    toks, patches = s["batch"]["tokens"], s["batch"]["patches"]
    b, n = toks.shape[0], toks.shape[1] + cfg.patch_len
    rl, rc = rm.prefill(rp, jnp.asarray(toks), rm.init_cache(b, n + 8),
                        patches=jnp.asarray(patches))
    tl, tc = tm.prefill(tp, torch.as_tensor(toks),
                        tm.init_cache(b, n + 8, device="cpu"),
                        patches=torch.as_tensor(patches))
    _close(tl, rl, "prefill")
    assert _np(tc["len"]).tolist() == [n, n]
    fl, _ = tm.forward(tp, _t(s["batch"]))
    _close(tl[:, 0], _np(fl[:, -1]), "prefill vs forward")
    rng = np.random.default_rng(5)
    seq = [toks]
    for i in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        seq.append(nxt)
        rl, rc = rm.decode_step(rp, rc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(nxt))
        _close(tl, rl, f"decode {i}")
        if i == 0:
            fl, _ = tm.forward(tp, _t(dict(s["batch"],
                                           tokens=np.concatenate(seq, 1))))
            _close(tl[:, 0], _np(fl[:, -1]), "decode vs forward")
    for key in ("k", "v"):
        _close(tc[key], rc[key], key)


def test_one_train_step_loss_matches_reference():
    s = _setup()
    rp, tp = s["float"]
    batch = dict(s["batch"], labels=s["batch"]["tokens"])
    r_loss, _ = r_trainer.make_loss_fn(s["rm"], 0.01)(rp, _j(batch))
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, _ = make_loss_fn(s["tm"], 0.01)(tp, _t(batch))
    loss.backward()
    _close(loss, r_loss, "loss")
    assert float(tp["blocks"]["wq"].grad.abs().sum()) > 0


def test_packed_quantization_matches_per_site():
    s = _setup()
    rq = s["packed"][0]
    tq, rep = quantize_model(s["float"][1], s["tm"].quant_site_map(),
                             s["stats"][1], method="faq",
                             spec=QuantSpec(**SPEC), mode="packed")
    for path in s["tm"].quant_site_map():
        name = "/".join(path)
        got, want = tq[path[0]][path[1]], rq[path[0]][path[1]]
        assert isinstance(got, QuantizedTensor) and got.packed
        want_alpha = np.asarray(s["report"][name]["alpha"])
        np.testing.assert_array_equal(
            _np(rep[name]["alpha"]).reshape(want_alpha.shape), want_alpha)
        np.testing.assert_array_equal(_np(got.codes), np.asarray(want.codes))
        for field in ("scale", "zero", "act_scale"):
            _close(getattr(got, field), getattr(want, field), name + field)


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("n_slots", [1, 2])
def test_serve_tokens_match_reference_engine(n_slots):
    s = _setup()
    rq, tq = s["packed"]
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, s["cfg"].vocab_size, size=n), m)
            for i, (n, m) in enumerate([(5, 6), (17, 4), (5, 7)])]
    kw = dict(n_slots=n_slots, max_len=32)
    rres = RServeEngine(s["rm"], rq, **kw).serve(
        [RRequest(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
    tres = ServeEngine(s["tm"], tq, device="cpu", **kw).serve(
        [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
    for i, _, m in reqs:
        assert len(tres[i]) == m
        np.testing.assert_array_equal(tres[i], np.asarray(rres[i]))


def test_single_admission_spec_and_paged_decline():
    """The VLM's prefill takes no prompt_len: one request at a time at its
    exact length, serve == generate; spec and paged=True serve plainly
    from the dense cache with the same tokens; an int8 KV cache is
    refused."""
    s = _setup()
    tm, tp = s["tm"], s["float"][1]
    assert not tm.supports_spec() and not tm.supports_paged()
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, s["cfg"].vocab_size,
                                               size=4 + 5 * i),
                    max_new_tokens=3 + i) for i in range(3)]
    mk = lambda: [Request(rid=r.rid, prompt=r.prompt,
                          max_new_tokens=r.max_new_tokens) for r in reqs]
    eng = ServeEngine(tm, tp, n_slots=2, max_len=32, device="cpu")
    assert type(eng._admission.strategies[0]).__name__ == "SingleAdmission"
    plain = eng.serve(mk())
    for r in reqs:
        np.testing.assert_array_equal(plain[r.rid], eng.generate(r))
    spec = ServeEngine(tm, tp, n_slots=2, max_len=32, device="cpu",
                       spec=SpecConfig(k=3, draft=self_int8_draft(tm, tp)))
    paged = ServeEngine(tm, tp, n_slots=2, max_len=32, device="cpu",
                        paged=True)
    assert spec._spec is None and not paged.paged
    for out in (spec.serve(mk()), paged.serve(mk())):
        for r in reqs:
            np.testing.assert_array_equal(out[r.rid], plain[r.rid])
    with pytest.raises(NotImplementedError, match="VLM"):
        build_model(ARCHS[ARCH].tiny().scaled(kv_cache_bits=8))


def test_quantize_and_serve_clis_on_cpu():
    qparams, report = quantize_cli.main(["--arch", ARCH, "--tiny", "--device",
                                         "cpu", "--calib-n", "2"])
    assert isinstance(qparams["blocks"]["wq"], QuantizedTensor)
    assert "blocks/w_down" in report
    out = serve_cli.main(["--arch", ARCH, "--tiny", "--requests", "2",
                          "--new-tokens", "4", "--calib-n", "2",
                          "--device", "cpu"])
    assert sorted(out) == [0, 1]
    assert all(len(v) == 4 and (np.asarray(v) < 512).all()
               for v in out.values())
