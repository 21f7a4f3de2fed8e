"""The MoE family in the port (``repro_torch.models.moe``) against repro's
on the CPU: qwen2-moe-a2.7b and llama4-maverick-400b-a17b at ``tiny()``
(4 layers, d_model 128, 8 experts padded to 16, top-2, f32), repro's
weights crossed to the port as numpy arrays.

Held, at atol = rtol = 1e-4 (f32 sums in another order): routing,
dispatch, combine and the MoE FFN (outputs, aux loss, the mlp_down
statistic) at capacity factors 1.25, 0.5 (tokens dropped) and 16; whole-
model logits, every site's statistics and moe_aux, float and packed;
prefill, decode and a T = 3 verify burst; quant_matmul_experts' plain
version; one train step's loss.  Held exactly: the expert ids and
dispatch slots (with exact router ties, the lower index first, as
``jax.lax.top_k``), the packed codes and α per (layer, expert), greedy
serving tokens at 1 and 2 slots, speculative == plain at 1 slot, and the
packed checkpoint bit for bit in both directions.
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
from repro.core.quantizer import QuantizedTensor as RQT
from repro.dist import checkpoint as r_ckpt
from repro.kernels.ops import quant_matmul_experts as r_qmm_experts
from repro.models import moe as rmoe
from repro.models.registry import build_model as r_build
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.train import trainer as r_trainer
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ARCHS
from repro_torch.core import (QuantSpec, QuantizedTensor, quantize_model,
                              quantize_groupwise, run_calibration)
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.kernels import ops
from repro_torch.kernels.ref import quant_matmul_experts_ref
from repro_torch.launch import quantize as quantize_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build_model
from repro_torch.serve.draft import self_int8_draft
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig
from repro_torch.train.trainer import make_loss_fn

TOL = dict(atol=1e-4, rtol=1e-4)
MOE = ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b")
SPEC = dict(bits=4, group_size=64)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: these tests run small torch ops in
    loops, and under pytest-xdist several workers each spinning a full
    thread pool on the same cores made them ~50x slower."""
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


_SETUPS = {}


def _setup(arch):
    """repro's tiny model, its float and FAQ-packed weights and statistics,
    and the port's model on the same numpy arrays (built once per arch)."""
    if arch not in _SETUPS:
        cfg = R_ARCHS[arch].tiny()
        rm = r_build(cfg)
        rp = rm.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)) \
            .astype(np.int32)
        rs = r_run_calibration(rm.forward, rp, [{"tokens": jnp.asarray(toks)}])
        rq, rrep = r_quantize_model(rp, rm.quant_site_map(), rs, method="faq",
                                    spec=RSpec(**SPEC), mode="packed")
        _SETUPS[arch] = dict(
            cfg=cfg, rm=rm, tm=build_model(ARCHS[arch].tiny()), toks=toks,
            float=(rp, from_numpy_tree(_to_np(rp), "cpu")),
            packed=(rq, from_numpy_tree(_to_np(rq), "cpu")),
            stats=(rs, from_numpy_tree(_to_np(rs), "cpu")), report=rrep)
    return _SETUPS[arch]


# -- the MoE FFN's pieces ---------------------------------------------------

@pytest.mark.parametrize("factor", [1.25, 0.5, 16.0])
@pytest.mark.parametrize("arch", MOE)
def test_route_dispatch_combine_and_ffn_match(arch, factor):
    s = _setup(arch)
    cfg = s["cfg"].scaled(moe_capacity_factor=factor)
    rp, tp = s["float"]
    lay = lambda tree: {k: v[1] for k, v in tree["blocks"].items()}
    rl, tl = lay(rp), lay(tp)
    x = np.random.default_rng(1).standard_normal((2, 12, cfg.d_model)) \
        .astype(np.float32)
    xf = x.reshape(-1, cfg.d_model)
    k, e_pad = cfg.experts_per_token, rl["router"].shape[-1]
    cap = tmoe._capacity(24, k, cfg.n_experts, factor)
    assert cap == rmoe._capacity(24, k, cfg.n_experts, factor)
    rprobs, rtopi, raux = rmoe._route(jnp.asarray(xf), rl["router"],
                                      cfg.n_experts, k)
    probs, topi, aux = tmoe._route(torch.as_tensor(xf), tl["router"],
                                   cfg.n_experts, k)
    np.testing.assert_array_equal(_np(topi), np.asarray(rtopi))
    assert int(topi.max()) < cfg.n_experts          # pad experts masked
    _close(probs, rprobs, "probs")
    _close(aux, raux, "aux")
    rd = rmoe._dispatch(jnp.asarray(xf), rtopi, rprobs, e_pad, cap)
    td = tmoe._dispatch(torch.as_tensor(xf), topi, probs, e_pad, cap)
    for name, got, want in zip(("buf", "dest", "keep", "src", "gate"), td, rd):
        _close(got, want, name)
    if factor == 0.5:
        assert float(td[2].min()) == 0.0                # tokens dropped
    out = np.random.default_rng(2).standard_normal(
        (e_pad, cap, cfg.d_model)).astype(np.float32)
    _close(tmoe._combine(torch.as_tensor(out), *td[1:], 24, cfg.d_model),
           rmoe._combine(jnp.asarray(out), *rd[1:], 24, cfg.d_model),
           "combine")
    ry, raux2, rst = rmoe.moe_ffn_local(
        jnp.asarray(x), rl["router"], rl["wg_exp"], rl["wu_exp"],
        rl["wd_exp"], cfg, collect=True)
    ty, taux2, tst = tmoe.moe_ffn_local(
        torch.as_tensor(x), tl["router"], tl["wg_exp"], tl["wu_exp"],
        tl["wd_exp"], cfg, collect=True)
    _close(ty, ry, "y")
    _close(taux2, raux2, "aux")
    _close_stats(tst, rst)


def test_router_ties_pick_the_lower_expert_as_top_k_does():
    """Exact ties among the logits (a column copied into another, and rows
    of equal logits) resolve to the lower expert index, as
    ``jax.lax.top_k``; pad experts never win."""
    cfg = ARCHS["qwen2-moe-a2.7b"].tiny()
    e_pad = tmoe.padded_experts(cfg.n_experts)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((cfg.d_model, e_pad)).astype(np.float32)
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 1]
    x = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
    x[:4] = 0.0                                      # every logit ties
    for k in (2, 4):
        _, ri, _ = rmoe._route(jnp.asarray(x), jnp.asarray(w),
                               cfg.n_experts, k)
        _, ti, _ = tmoe._route(torch.as_tensor(x), torch.as_tensor(w),
                               cfg.n_experts, k)
        np.testing.assert_array_equal(_np(ti), np.asarray(ri))
        assert _np(ti)[0].tolist() == list(range(k))


def test_capacity_is_the_reference_float_formula():
    for n, k, e, f in [(1, 4, 60, 1.25), (4, 4, 60, 1.25), (8192, 4, 60, 1.25),
                       (2048, 4, 60, 1.25), (24, 2, 8, 0.5), (7, 1, 128, 16.0)]:
        assert tmoe._capacity(n, k, e, f) == rmoe._capacity(n, k, e, f)
    assert tmoe._capacity(1, 4, 60, 1.25) == 1
    assert tmoe._capacity(8192, 4, 60, 1.25) == 683
    assert tmoe.padded_experts(60) == 64 and tmoe.padded_experts(8) == 16


# -- the model --------------------------------------------------------------

def test_init_tree_matches_reference_shapes():
    for arch in MOE:
        s = _setup(arch)
        tp = s["tm"].init(0, device="cpu")
        want = {jax.tree_util.keystr(k): v.shape for k, v in
                jax.tree_util.tree_flatten_with_path(s["float"][0])[0]}
        got = {k: tuple(v.shape) for k, v in leaves_with_keys(tp)}
        assert got == want
        assert s["tm"].quant_site_map() == s["rm"].quant_site_map()


@pytest.mark.parametrize("kind", ["float", "packed"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_stats_and_aux_match(arch, kind):
    s = _setup(arch)
    rp, tp = s[kind]
    toks = np.random.default_rng(4).integers(0, s["cfg"].vocab_size, (2, 20)) \
        .astype(np.int32)
    rl, raux = s["rm"].forward(rp, {"tokens": jnp.asarray(toks)},
                               collect_stats=True)
    tl, taux = s["tm"].forward(tp, {"tokens": torch.as_tensor(toks)},
                               collect_stats=True)
    _close(tl, rl, "logits")
    _close(taux["moe_aux"], raux["moe_aux"], "moe_aux")
    _close_stats(taux["stats"], raux["stats"])
    assert set(taux["stats"]) == {"attn_in", "attn_out", "mlp_in",
                                  "mlp_down", "shared_down"}


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_and_verify_burst_match(arch):
    """At capacity factor 16 (no drops; tests/test_models_smoke.py's
    setting): bucket-padded prefill, two decode steps and a T = 3 verify
    burst (routed per position) against repro's on the packed weights."""
    s = _setup(arch)
    cfg = s["cfg"].scaled(moe_capacity_factor=16.0)
    rm, tm = r_build(cfg), build_model(cfg)
    rp, tp = s["packed"]
    rng = np.random.default_rng(5)
    b, t, slen = 2, 12, 32
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    plen = np.array([12, 7], np.int32)
    rl, rc = rm.prefill(rp, jnp.asarray(toks), rm.init_cache(b, slen),
                        prompt_len=jnp.asarray(plen))
    tl, tc = tm.prefill(tp, torch.as_tensor(toks),
                        tm.init_cache(b, slen, device="cpu"),
                        prompt_len=torch.as_tensor(plen))
    _close(tl, rl, "prefill")
    for step_t in (1, 1, 3):
        nxt = rng.integers(0, cfg.vocab_size, (b, step_t)).astype(np.int32)
        rl, rc = rm.decode_step(rp, rc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(nxt))
        _close(tl, rl, f"decode T={step_t}")
        np.testing.assert_array_equal(_np(tc["len"]), np.asarray(rc["len"]))
    for key in ("k", "v"):
        _close(tc[key], rc[key], key)
    # without a prompt length, prefill's last logits are forward's last
    fl, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    pl, _ = tm.prefill(tp, torch.as_tensor(toks),
                       tm.init_cache(b, slen, device="cpu"))
    _close(pl[:, 0], _np(fl[:, -1]), "prefill vs forward")


@pytest.mark.parametrize("arch", MOE)
def test_packed_quantization_matches_per_layer_and_expert(arch):
    """Codes, scales, zeros, act_scale and α of every (layer, expert):
    the port's FAQ on repro's statistics gives repro's packed tree."""
    s = _setup(arch)
    rq = s["packed"][0]
    tq, rep = quantize_model(s["float"][1], s["tm"].quant_site_map(),
                             s["stats"][1], method="faq",
                             spec=QuantSpec(**SPEC), mode="packed")
    for path in s["tm"].quant_site_map():
        name = "/".join(path)
        got, want = tq[path[0]][path[1]], rq[path[0]][path[1]]
        assert isinstance(got, QuantizedTensor) and got.packed
        want_alpha = np.asarray(s["report"][name]["alpha"])   # (L, E or 1)
        np.testing.assert_array_equal(
            _np(rep[name]["alpha"]).reshape(want_alpha.shape), want_alpha)
        np.testing.assert_array_equal(_np(got.codes), np.asarray(want.codes))
        for field in ("scale", "zero", "act_scale"):
            _close(getattr(got, field), getattr(want, field), name + field)
        want_loss = np.asarray(s["report"][name]["loss"])
        _close(_np(rep[name]["loss"]).reshape(want_loss.shape), want_loss,
               name)
    n_layers, e_pad = s["cfg"].n_layers, 16
    assert tq["blocks"]["wd_exp"].codes.shape[:2] == (n_layers, e_pad)
    assert rep["blocks/wg_exp"]["alpha"].shape == (n_layers, e_pad)


@pytest.mark.parametrize("act", [False, True], ids=["plain", "act_scale"])
def test_quant_matmul_experts_plain_matches_reference(act):
    rng = np.random.default_rng(6)
    e, c, k, n = 5, 3, 128, 96
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    a = (rng.random((e, k)) + 0.5).astype(np.float32) if act else None
    tq = quantize_groupwise(torch.as_tensor(w), QuantSpec(**SPEC),
                            act_scale=None if a is None
                            else torch.as_tensor(a), pack=True)
    rq = RQT(codes=jnp.asarray(_np(tq.codes)), scale=jnp.asarray(_np(tq.scale)),
             zero=jnp.asarray(_np(tq.zero)), spec=RSpec(**SPEC), n_in=k,
             packed=True, act_scale=None if a is None else jnp.asarray(a))
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    want = np.asarray(r_qmm_experts(jnp.asarray(x), rq))
    _close(ops.quant_matmul_experts(torch.as_tensor(x), tq), want, "ops")
    _close(quant_matmul_experts_ref(torch.as_tensor(x), tq), want, "ref")


def test_one_train_step_loss_matches_reference():
    s = _setup("qwen2-moe-a2.7b")
    rp, tp = s["float"]
    toks = s["toks"]
    batch = {"tokens": toks, "labels": toks}
    r_loss, r_aux = r_trainer.make_loss_fn(s["rm"], 0.01)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, aux = make_loss_fn(s["tm"], 0.01)(
        tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    for key in ("ce", "moe_aux"):
        _close(aux[key], r_aux[key], key)
    _close(loss, r_loss, "loss")
    grad = tp["blocks"]["wg_exp"].grad
    assert grad is not None and float(grad.abs().sum()) > 0
    assert tp["blocks"]["router"].grad.abs().sum() > 0


# -- serving ----------------------------------------------------------------

def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, 20))),
             int(rng.integers(3, 9))) for i in range(n)]


@pytest.mark.parametrize("n_slots", [1, 2])
def test_serve_tokens_match_reference_engine(n_slots):
    s = _setup("qwen2-moe-a2.7b")
    rq, tq = s["packed"]
    reqs = _requests(s["cfg"], 4, seed=7)
    kw = dict(n_slots=n_slots, max_len=48)
    rres = RServeEngine(s["rm"], rq, **kw).serve(
        [RRequest(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
    tres = ServeEngine(s["tm"], tq, device="cpu", **kw).serve(
        [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
    for i, _, m in reqs:
        assert len(tres[i]) == m
        np.testing.assert_array_equal(tres[i], np.asarray(rres[i]))


def test_spec_matches_plain_at_one_slot_and_paged_falls_back():
    """Self-int8 speculative decode == plain decode at n_slots = 1 (the
    verify span routes per position); paged=True serves from the dense
    cache, as the reference's MoE does."""
    s = _setup("qwen2-moe-a2.7b")
    tm, tq = s["tm"], s["packed"][1]
    assert tm.supports_spec() and not tm.supports_paged()
    reqs = _requests(s["cfg"], 3, seed=8)
    mk = lambda: [Request(rid=i, prompt=p, max_new_tokens=m)
                  for i, p, m in reqs]
    plain = ServeEngine(tm, tq, n_slots=1, max_len=48, device="cpu")
    spec = ServeEngine(tm, tq, n_slots=1, max_len=48, device="cpu",
                       spec=SpecConfig(k=3, draft=self_int8_draft(
                           tm, tq, s["stats"][1])))
    res_p, res_s = plain.serve(mk()), spec.serve(mk())
    for i, _, _ in reqs:
        np.testing.assert_array_equal(res_s[i], res_p[i])
    assert spec.metrics()["spec_cycles"] > 0
    paged = ServeEngine(tm, tq, n_slots=1, max_len=48, device="cpu",
                        paged=True)
    assert not paged.paged and paged.metrics()["paged"] is False
    res_g = paged.serve(mk())
    for i, _, _ in reqs:
        np.testing.assert_array_equal(res_g[i], res_p[i])


def test_packed_moe_checkpoint_crosses_both_packages(tmp_path):
    s = _setup("qwen2-moe-a2.7b")
    rq, tq = s["packed"]
    ckpt.save(str(tmp_path / "t"), 0, {"qparams": tq})
    back = r_ckpt.restore(str(tmp_path / "t"), 0, {"qparams": rq})["qparams"]
    r_ckpt.save(str(tmp_path / "r"), 0, {"qparams": rq})
    mine = ckpt.restore(str(tmp_path / "r"), 0, {"qparams": tq},
                        device="cpu")["qparams"]
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(rq)[0]}
    for tree in (_to_np(back), mine):
        got = (leaves_with_keys(tree) if tree is mine else
               [(jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]])
        assert len(got) == len(want)
        for key, leaf in got:
            assert np.array_equal(_np(leaf), want[key]), key
    assert mine["blocks"]["wu_exp"].codes.dim() == 4
    for name in ("data.bin", "manifest.json"):
        assert (tmp_path / "r" / "step_00000000" / name).read_bytes() == \
            (tmp_path / "t" / "step_00000000" / name).read_bytes(), name


def test_quantize_and_serve_clis_on_cpu(tmp_path, capsys):
    """--arch qwen2-moe-a2.7b through both CLIs: the packed tree the
    quantize CLI writes has (L, E, ...) expert leaves and restores in the
    reference; the serve CLI serves a checkpoint of repro's weights."""
    qparams, _ = quantize_cli.main(["--arch", "qwen2-moe-a2.7b", "--tiny",
                                    "--device", "cpu", "--calib-n", "2",
                                    "--out", str(tmp_path / "q")])
    assert "saved to" in capsys.readouterr().out
    rq = _setup("qwen2-moe-a2.7b")["packed"][0]
    back = r_ckpt.restore(str(tmp_path / "q"), 0, {"qparams": rq})
    codes = np.asarray(back["qparams"]["blocks"]["wd_exp"].codes)
    assert codes.shape == tuple(rq["blocks"]["wd_exp"].codes.shape)
    np.testing.assert_array_equal(codes,
                                  _np(qparams["blocks"]["wd_exp"].codes))
    r_ckpt.save(str(tmp_path / "p"), 3,
                {"params": _setup("qwen2-moe-a2.7b")["float"][0]})
    out = serve_cli.main(["--arch", "qwen2-moe-a2.7b", "--tiny",
                          "--requests", "2", "--new-tokens", "4",
                          "--calib-n", "2", "--ckpt-dir", str(tmp_path / "p"),
                          "--device", "cpu"])
    assert "loaded checkpoint step 3" in capsys.readouterr().out
    assert sorted(out) == [0, 1]
    assert all(len(v) == 4 and (np.asarray(v) < 512).all()
               for v in out.values())
