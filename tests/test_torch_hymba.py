"""The hybrid family in the port (``repro_torch.models.hymba`` and the
Mamba half of ``repro_torch.models.ssm``) against repro's on the CPU:
hymba-1.5b at ``tiny()`` (4 layers, d_model 128, 4/2 heads of 32, d_inner
256, ssm_state 8, window 16, f32), repro's weights crossed to the port as
numpy arrays by ``bridge.from_numpy_tree``.

Held at atol = rtol = 1e-4 (f32 sums in another order): block-local
window attention (window 16, T 40 and 64, padding included) and the
windowed chunked path; ``mamba_scan``, ``mamba_step`` and
``_mamba_scan_final`` with their states; whole-model logits and every
site's statistics, float and packed; prefill and decode past the window
(the ring wraps) with the ring, Mamba state and conv tail; one train
step's loss.  Held exactly: FAQ α and packed codes per site, greedy
serving tokens at 1 and 2 slots against repro's engine, serve ==
``generate`` through the exact-length admission, spec declined.
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
from repro.models import hymba as rhymba
from repro.models import ssm as rssm
from repro.models.registry import build_model as r_build
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.train import trainer as r_trainer
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, QuantizedTensor, quantize_model
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.launch import quantize as quantize_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import build_model
from repro_torch.serve.cache_ops import merge_slots, write_slot
from repro_torch.serve.draft import self_int8_draft
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig
from repro_torch.train.trainer import make_loss_fn

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "hymba-1.5b"
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
    """repro's tiny hymba, its float and FAQ-packed weights and statistics,
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


# -- primitives --------------------------------------------------------------

@pytest.mark.parametrize("t", [40, 64])
def test_local_window_attention_matches(t):
    """Window 16 at T 40 (padded to 48) and 64, GQA 4/2; chunked_attention
    dispatches T > 2w to the block-local path, T <= 2w masks the window."""
    rng = np.random.default_rng(t)
    q = rng.standard_normal((2, t, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 32)).astype(np.float32)
    want = rcommon.local_window_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), 16)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    _close(tcommon.local_window_attention(tq, tk, tv, 16), want, "local")
    _close(tcommon.chunked_attention(tq, tk, tv, window=16), want, "chunked")
    short = slice(0, 32)
    _close(tcommon.chunked_attention(tq[:, short], tk[:, short],
                                     tv[:, short], window=16, chunk=8),
           rcommon.chunked_attention(jnp.asarray(q[:, short]),
                                     jnp.asarray(k[:, short]),
                                     jnp.asarray(v[:, short]), window=16,
                                     chunk=8), "masked window")


def test_mamba_scan_step_and_final_state_match():
    """The Mamba branch of layer 1: the scan (output, both statistics), the
    seeded scan's final state and conv tail, then three decode steps from
    it, each with its state."""
    s = _setup()
    rp, tp = s["float"]
    rl = {k: v[1] for k, v in rp["blocks"]["mamba"].items()}
    tl = {k: v[1] for k, v in tp["blocks"]["mamba"].items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, s["cfg"].d_model)).astype(np.float32)
    seen = {}
    out = tssm.mamba_scan(tl, torch.as_tensor(x),
                          collect_cb=lambda n, a: seen.__setitem__(n, a))
    _close(out, rssm.mamba_scan(rl, jnp.asarray(x)), "scan")
    ru = rssm._mamba_gates(rl, jnp.asarray(x))[0]
    _close(seen["mamba_x"], ru, "mamba_x")
    rseen = {}
    rssm.mamba_scan(rl, jnp.asarray(x),
                    collect_cb=lambda n, a: rseen.__setitem__(n, a))
    _close(seen["mamba_out"], rseen["mamba_out"], "mamba_out")
    d_in, n_s = tl["a_log"].shape
    st0 = {"h": rng.standard_normal((2, d_in, n_s)).astype(np.float32) * 0.1,
           "conv": rng.standard_normal((2, 3, d_in)).astype(np.float32)}
    rout, rst = rhymba._mamba_scan_final(
        rl, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st0.items()})
    tout, tst = tssm.mamba_scan_final(
        tl, torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in st0.items()})
    _close(tout, rout, "final out")
    for key in ("h", "conv"):
        _close(tst[key], rst[key], f"final {key}")
    for i in range(3):
        xi = rng.standard_normal((2, 1, s["cfg"].d_model)).astype(np.float32)
        rout, rst = rssm.mamba_step(rl, jnp.asarray(xi), rst)
        tout, tst = tssm.mamba_step(tl, torch.as_tensor(xi), tst)
        _close(tout, rout, f"step {i}")
        for key in ("h", "conv"):
            _close(tst[key], rst[key], f"step {i} {key}")


# -- the model ---------------------------------------------------------------

def test_init_tree_and_bridge_carry_the_nested_mamba_branch():
    """The port's init tree has repro's key paths and shapes (the nested
    ``blocks/mamba`` branch); from_numpy_tree carries repro's float and
    packed trees across leaf for leaf."""
    s = _setup()
    tp = s["tm"].init(0, device="cpu")
    for port_tree, ref_tree in ((tp, s["float"][0]), (s["float"][1],
                                                      s["float"][0]),
                                (s["packed"][1], s["packed"][0])):
        want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
        got = dict(leaves_with_keys(port_tree))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        if port_tree is not tp:
            for key, leaf in got.items():
                assert np.array_equal(_np(leaf), want[key]), key
    assert isinstance(s["packed"][1]["blocks"]["mamba"]["x_proj"],
                      QuantizedTensor)
    assert not isinstance(s["packed"][1]["blocks"]["mamba"]["dt_proj"],
                          QuantizedTensor)
    assert s["tm"].quant_site_map() == s["rm"].quant_site_map()


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_forward_logits_and_stats_match(kind):
    """T 40 > 2 x window: the attention half runs block-locally."""
    s = _setup()
    rp, tp = s[kind]
    toks = np.random.default_rng(4).integers(0, s["cfg"].vocab_size, (2, 40)) \
        .astype(np.int32)
    rl, raux = s["rm"].forward(rp, {"tokens": jnp.asarray(toks)},
                               collect_stats=True)
    tl, taux = s["tm"].forward(tp, {"tokens": torch.as_tensor(toks)},
                               collect_stats=True)
    _close(tl, rl, "logits")
    _close_stats(taux["stats"], raux["stats"])
    assert set(taux["stats"]) == {"attn_in", "attn_out", "mamba_x",
                                  "mamba_out", "mlp_in", "mlp_down"}


def test_prefill_and_decode_past_the_window_match():
    """A 20-token prompt into a 16-slot ring (its first 4 positions drop),
    then 14 decode steps (the ring wraps again), on the packed weights:
    logits, ring K/V, Mamba state and conv tail against repro's each step;
    the last decode logits against a forward over the whole sequence."""
    s = _setup()
    cfg, rm, tm = s["cfg"], s["rm"], s["tm"]
    rp, tp = s["packed"]
    rng = np.random.default_rng(5)
    b, t, max_len = 2, 20, 40
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    r_decode = jax.jit(rm.decode_step)
    rl, rc = jax.jit(rm.prefill)(rp, jnp.asarray(toks),
                                 rm.init_cache(b, max_len))
    tc = tm.init_cache(b, max_len, device="cpu")
    assert tc["k"].shape[3] == 16 and tc["mamba"]["h"].dtype == torch.float32
    tl, tc = tm.prefill(tp, torch.as_tensor(toks), tc)
    _close(tl, rl, "prefill")
    seq = [toks]
    for i in range(14):
        nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        seq.append(nxt)
        rl, rc = r_decode(rp, rc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(nxt))
        _close(tl, rl, f"decode {i}")
        np.testing.assert_array_equal(_np(tc["len"]), np.asarray(rc["len"]))
    for key in ("k", "v"):
        _close(tc[key], rc[key], key)
    for key in ("h", "conv"):
        _close(tc["mamba"][key], rc["mamba"][key], key)
    full, _ = tm.forward(tp, {"tokens": torch.as_tensor(np.concatenate(seq,
                                                                       1))})
    _close(tl[:, 0], _np(full[:, -1]), "decode vs forward")


def test_one_train_step_loss_matches_reference():
    """Loss through the Mamba loop, and gradients reaching its parameters."""
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
    for name in ("in_proj", "x_proj", "dt_proj", "a_log", "conv_w"):
        grad = tp["blocks"]["mamba"][name].grad
        assert grad is not None and float(grad.abs().sum()) > 0, name


def test_packed_quantization_matches_per_site():
    """FAQ α, codes, scales, zeros and act_scale of every site, the
    nested Mamba paths included: the port's FAQ on repro's statistics
    gives repro's packed tree."""
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
    assert "blocks/mamba/out_proj" in rep
    # "fake" mode walks the same nested paths: its dequantized float leaves
    # give the packed model's logits (tests/test_quant_e2e.py's check)
    tf, _ = quantize_model(s["float"][1], s["tm"].quant_site_map(),
                           s["stats"][1], method="faq",
                           spec=QuantSpec(**SPEC), mode="fake")
    assert not isinstance(tf["blocks"]["mamba"]["x_proj"], QuantizedTensor)
    batch = {"tokens": torch.as_tensor(s["toks"])}
    np.testing.assert_allclose(_np(s["tm"].forward(tf, batch)[0]),
                               _np(s["tm"].forward(tq, batch)[0]), atol=1e-4)


def test_nested_cache_ops_write_and_merge_slots():
    """write_slot / merge_slots walk the nested mamba state with the batch
    on axis 1 of every leaf but ``len``."""
    tm = _setup()["tm"]
    big = tm.init_cache(3, 24, device="cpu")
    one = tm.init_cache(1, 24, device="cpu")
    for _, leaf in leaves_with_keys(one):
        leaf.fill_(7)
    write_slot(big, one, 1)
    for key, leaf in leaves_with_keys(big):
        rows = leaf if leaf.dim() == 1 else leaf.transpose(0, 1)
        assert bool((rows[1] == 7).all()) and not bool(rows[0].any()), key
    new = tm.init_cache(3, 24, device="cpu")
    for _, leaf in leaves_with_keys(new):
        leaf.fill_(3)
    merge_slots(big, new, torch.tensor([True, False, False]))
    for key, leaf in leaves_with_keys(big):
        rows = leaf if leaf.dim() == 1 else leaf.transpose(0, 1)
        assert bool((rows[0] == 3).all()) and bool((rows[1] == 7).all()), key
        assert not bool(rows[2].any()), key


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("n_slots", [1, 2])
def test_serve_tokens_match_reference_engine(n_slots):
    """Prompts of 5 and 20 tokens into a 16-slot ring (the long ones wrap
    it at prefill, the short ones while decoding), on the packed weights:
    the same greedy tokens as repro's engine."""
    s = _setup()
    rq, tq = s["packed"]
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, s["cfg"].vocab_size, size=n), m)
            for i, (n, m) in enumerate([(5, 14), (20, 4), (5, 6), (20, 8)])]
    kw = dict(n_slots=n_slots, max_len=40)
    rres = RServeEngine(s["rm"], rq, **kw).serve(
        [RRequest(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
    tres = ServeEngine(s["tm"], tq, device="cpu", **kw).serve(
        [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
    for i, _, m in reqs:
        assert len(tres[i]) == m
        np.testing.assert_array_equal(tres[i], np.asarray(rres[i]))


def test_single_admission_serves_as_generate_and_spec_paged_decline():
    """No prompt_len prefill: the engine admits one request at a time
    (tests/test_serve.py's fallback case) and serve == generate; spec is
    declined (tests/test_spec.py) and paged=True serves from the dense
    cache, with the same tokens; an int8 KV cache is refused."""
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
    with pytest.raises(NotImplementedError, match="hybrid"):
        build_model(ARCHS[ARCH].tiny().scaled(kv_cache_bits=8))


def test_quantize_and_serve_clis_on_cpu(capsys):
    qparams, report = quantize_cli.main(["--arch", ARCH, "--tiny", "--device",
                                         "cpu", "--calib-n", "2"])
    assert isinstance(qparams["blocks"]["mamba"]["out_proj"], QuantizedTensor)
    assert "blocks/mamba/x_proj" in report
    out = serve_cli.main(["--arch", ARCH, "--tiny", "--requests", "2",
                          "--new-tokens", "4", "--calib-n", "2",
                          "--device", "cpu"])
    assert sorted(out) == [0, 1]
    assert all(len(v) == 4 and (np.asarray(v) < 512).all()
               for v in out.values())
