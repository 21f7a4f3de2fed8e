"""The whole slice — calibrate, FAQ alpha search, int4 pack, serve — in
the port against repro on the same numpy weights and calibration batches.

Bars: the per-site, per-layer alpha the search picks is identical; the
greedy ServeEngine tokens are identical to repro's ServeEngine (chunked
prefill on and off, 2 and 3 slots) and to the port's own ``generate``.
Calibration statistics agree to atol = rtol = 1e-4 (model-level sums in
a different order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.core import QuantSpec as JSpec
from repro.core import quantize_model as j_quantize_model
from repro.core import run_calibration as j_run_calibration
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.data.synthetic import calibration_batches as j_calibration_batches
from repro.models.registry import build_model as j_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import from_numpy_tree
from repro_torch.core import QuantSpec, quantize_model, run_calibration
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                        calibration_batches)
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine

PROMPT_LENS = (5, 17, 40, 9)
NEW_TOKENS = 6


@pytest.fixture(scope="module")
def slice_run():
    cfg = ARCHS["llama3-8b"].tiny()
    jm = j_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    calib = calibration_batches(data, 4, 32, batch_size=2)
    js = j_run_calibration(jm.forward, jp,
                           [{k: jnp.asarray(v) for k, v in b.items()}
                            for b in calib])
    jq, jrep = j_quantize_model(jp, jm.quant_site_map(), js, method="faq",
                                spec=JSpec(bits=4, group_size=64),
                                mode="packed")
    tm = build_model(cfg)
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ts = run_calibration(tm.forward, tp, calib)
    tq, trep = quantize_model(tp, tm.quant_site_map(), ts, method="faq",
                              spec=QuantSpec(bits=4, group_size=64),
                              mode="packed")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    return dict(cfg=cfg, jm=jm, jq=jq, jrep=jrep, js=js, tm=tm, tq=tq,
                trep=trep, ts=ts, prompts=prompts, calib=calib)


def test_data_copy_is_exact():
    ours, theirs = SyntheticLM(DataConfig(vocab_size=300)), \
        JSyntheticLM(JDataConfig(vocab_size=300))
    for i in (0, 7, 123):
        np.testing.assert_array_equal(ours.sequence(i, 20),
                                      theirs.sequence(i, 20))
    np.testing.assert_array_equal(ours.batch(3, 2, 8)["tokens"],
                                  theirs.batch(3, 2, 8)["tokens"])
    for a, b in zip(calibration_batches(ours, 5, 6, batch_size=2),
                    j_calibration_batches(theirs, 5, 6, batch_size=2)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_calibration_stats_match(slice_run):
    for site, st in slice_run["js"].items():
        for key, ref in st.items():
            np.testing.assert_allclose(
                slice_run["ts"][site][key].numpy(), np.asarray(ref),
                atol=1e-4, rtol=1e-4)


def test_faq_alpha_identical_at_every_site(slice_run):
    jrep, trep = slice_run["jrep"], slice_run["trep"]
    assert set(trep) == set(jrep)
    for path, rep in jrep.items():
        np.testing.assert_array_equal(trep[path]["alpha"].numpy(),
                                      np.asarray(rep["alpha"]).reshape(-1),
                                      err_msg=path)
        np.testing.assert_allclose(trep[path]["loss"].numpy(),
                                   np.asarray(rep["loss"]).reshape(-1),
                                   rtol=1e-4)
    # same alpha + same weights -> the same packed codes
    for name in ("wq", "w_down"):
        np.testing.assert_array_equal(
            slice_run["tq"]["blocks"][name].codes.numpy(),
            np.asarray(slice_run["jq"]["blocks"][name].codes))


@pytest.mark.parametrize("n_slots", [2, 3])
@pytest.mark.parametrize("chunk", ["auto", 0])
def test_greedy_serve_token_identical_to_reference(slice_run, n_slots,
                                                   chunk):
    kw = dict(n_slots=n_slots, max_len=64, prefill_chunk=chunk)
    jeng = JServeEngine(slice_run["jm"], slice_run["jq"], **kw)
    teng = ServeEngine(slice_run["tm"], slice_run["tq"], device="cpu", **kw)
    assert teng.buckets == jeng.buckets
    assert teng.prefill_chunk == jeng.prefill_chunk
    prompts = slice_run["prompts"]
    jres = jeng.serve([JRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                       for i, p in enumerate(prompts)])
    tres = teng.serve([Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                       for i, p in enumerate(prompts)])
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]))
    m, jm = teng.metrics(), jeng.metrics()
    for key in ("tokens_generated", "decode_steps", "prefill_batches",
                "chunked_admissions", "fill_steps", "completed"):
        assert m[key] == jm[key], key
    if chunk == "auto":
        assert m["chunked_admissions"] == 1       # the 40-token prompt
    # and the port's own single-request generate agrees
    for i, p in enumerate(prompts):
        g = teng.generate(Request(rid=100 + i, prompt=p,
                                  max_new_tokens=NEW_TOKENS))
        np.testing.assert_array_equal(g, tres[i])


def test_single_admission_for_models_without_prompt_len(slice_run):
    """A model whose prefill takes no prompt_len is admitted one exact-
    length request at a time, with chunking off."""
    tm = slice_run["tm"]

    class NoPromptLen:
        cfg = tm.cfg
        forward, decode_step, init_cache = (tm.forward, tm.decode_step,
                                            tm.init_cache)

        def prefill(self, params, tokens, cache):
            return tm.prefill(params, tokens, cache)

    eng = ServeEngine(NoPromptLen(), slice_run["tq"], n_slots=2, max_len=64,
                      device="cpu")
    assert eng.prefill_chunk is None
    ref = ServeEngine(tm, slice_run["tq"], n_slots=2, max_len=64,
                      device="cpu")
    prompts = slice_run["prompts"]
    res = eng.serve([Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                     for i, p in enumerate(prompts)])
    assert eng.metrics()["prefill_batches"] == len(prompts)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(res[i], ref.generate(
            Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)))


def test_deadlines_and_zero_budget_follow_the_clock(slice_run):
    now = [0.0]
    eng = ServeEngine(slice_run["tm"], slice_run["tq"], n_slots=2,
                      max_len=64, device="cpu", clock=lambda: now[0])
    p = slice_run["prompts"]

    def tick(rid, tok):
        now[0] += 1.0

    reqs = [Request(rid=0, prompt=p[0], max_new_tokens=4, deadline=-1.0),
            Request(rid=1, prompt=p[1], max_new_tokens=0),
            Request(rid=2, prompt=p[3], max_new_tokens=20, deadline=2.5,
                    on_token=tick)]
    res = eng.serve(reqs)
    assert len(res[0]) == 0 and reqs[0].outcome == "expired"
    assert len(res[1]) == 0 and reqs[1].outcome == "completed"
    assert reqs[2].outcome == "truncated" and 0 < len(res[2]) < 20
    m = eng.metrics()
    assert (m["expired"], m["truncated"], m["completed"]) == (1, 1, 1)


@pytest.mark.parametrize("option", ["mesh"])
def test_unported_engine_options_raise(slice_run, option):
    with pytest.raises(NotImplementedError, match=option):
        ServeEngine(slice_run["tm"], slice_run["tq"], device="cpu",
                    **{option: True})


def _serve_with(slice_run, **option):
    """Serve the slice's prompts on an engine built with ``option`` and on
    a plain one; returns (engine, tokens, plain tokens)."""
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(slice_run["prompts"])]
    kw = dict(n_slots=2, max_len=64, device="cpu")
    plain = ServeEngine(slice_run["tm"], slice_run["tq"], **kw).serve(reqs())
    eng = ServeEngine(slice_run["tm"], slice_run["tq"], **kw, **option)
    return eng, eng.serve(reqs()), plain


def test_engine_serves_with_slo(slice_run):
    from repro_torch.serve import SLOAdmission, SLOConfig
    eng, out, plain = _serve_with(slice_run, slo=SLOConfig(seed=0))
    assert isinstance(eng.slo, SLOAdmission)
    for rid in plain:
        np.testing.assert_array_equal(out[rid], plain[rid])
    assert eng.slo._inflight == {"default": 0}     # released at finish


def test_engine_serves_with_faults(slice_run):
    from repro_torch.serve import FaultConfig, FaultInjector
    inj = FaultInjector(FaultConfig(preempt_at=(2,)))
    eng, out, plain = _serve_with(slice_run, faults=inj)
    for rid in plain:
        np.testing.assert_array_equal(out[rid], plain[rid])
    m = eng.metrics()
    assert m["faults"]["forced_preempts"] == m["preempted"] == 1


def test_engine_serves_with_tracer_and_registry(slice_run, tmp_path):
    from repro_torch.obs import MetricsRegistry, Tracer, validate_trace
    reg, tracer = MetricsRegistry(), Tracer()
    eng, out, plain = _serve_with(slice_run, tracer=tracer, registry=reg)
    for rid in plain:
        np.testing.assert_array_equal(out[rid], plain[rid])
    assert eng.registry is reg and tracer.clock is eng.clock
    assert reg.snapshot()["serve.completed"] == len(plain)
    assert validate_trace(eng.export_trace(tmp_path / "t.json")) == []


def test_engine_serves_with_profile(slice_run):
    from torch.profiler import profile
    with profile() as prof:
        eng, out, plain = _serve_with(slice_run, profile=True)
    for rid in plain:
        np.testing.assert_array_equal(out[rid], plain[rid])
    names = {e.key for e in prof.key_averages()}
    assert {"admit", "decode_step", "sampler_sync"} <= names


def test_launch_serve_cli_on_cpu(capsys):
    results = launch_serve.main(["--tiny", "--device", "cpu", "--requests",
                                 "2", "--new-tokens", "3", "--calib-n", "2",
                                 "--calib-len", "16"])
    assert sorted(results) == [0, 1]
    assert all(len(v) == 3 for v in results.values())
    assert "faq int4 packed, cpu" in capsys.readouterr().out


def test_launch_serve_cli_paged_on_cpu(capsys):
    results = launch_serve.main(["--tiny", "--device", "cpu", "--requests",
                                 "3", "--new-tokens", "3", "--calib-n", "2",
                                 "--calib-len", "16", "--paged",
                                 "--page-size", "8"])
    assert sorted(results) == [0, 1, 2]
    assert all(len(v) == 3 for v in results.values())
    assert "paged: page_size=8" in capsys.readouterr().out


def test_sampler_masks_match_reference():
    from repro.serve import sampler as jsampler
    from repro_torch.serve import sampler as tsampler
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 50)).astype(np.float32)
    top_k = np.array([0, 1, 5, 50], np.int32)
    top_p = np.array([0.0, 0.3, 0.9, 1.0], np.float32)
    np.testing.assert_array_equal(
        tsampler._apply_top_k(torch.as_tensor(logits),
                              torch.as_tensor(top_k)).numpy(),
        np.asarray(jsampler._apply_top_k(jnp.asarray(logits),
                                         jnp.asarray(top_k))))
    np.testing.assert_array_equal(
        tsampler._apply_top_p(torch.as_tensor(logits),
                              torch.as_tensor(top_p)).numpy(),
        np.asarray(jsampler._apply_top_p(jnp.asarray(logits),
                                         jnp.asarray(top_p))))
    # greedy rows take the argmax; a sampling row restricted to its top-1
    # token must draw it
    temps = torch.tensor([0.0, 0.7, 0.0, 1.3])
    gen = torch.Generator().manual_seed(0)
    out = tsampler.sample_tokens(torch.as_tensor(logits), temps,
                                 torch.tensor([0, 1, 0, 1],
                                              dtype=torch.int32), gen)
    np.testing.assert_array_equal(out.numpy(), logits.argmax(-1))


def test_temperature_sampling_follows_the_softmax():
    """Gumbel-max draws land on tokens with the softmax's frequencies."""
    from repro_torch.serve import sampler as tsampler
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.2, 1e-9]]))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([
        tsampler.sample_tokens(logits, torch.tensor([1.0]), None, gen)
        for _ in range(4000)]).reshape(-1)
    freq = torch.bincount(draws.long(), minlength=4).float() / len(draws)
    torch.testing.assert_close(freq, torch.tensor([0.5, 0.3, 0.2, 0.0]),
                               atol=0.03, rtol=0)
