"""Open-loop traffic in the port: seeded trace generation, the arrival
feed, the injectable clock seam, run_traffic's records and percentiles,
and the same trace, tokens, outcomes and registry deltas as repro's
``Scheduler.run_traffic`` on the same inputs and fake clock (dense and
paged, with and without SLO admission).

Mirrors tests/test_traffic.py on the CPU (every kernel runs its plain
version).  Weights are repro's tiny llama3-8b (4 layers, d_model 128,
f32), crossed to the port as numpy arrays.  Bars: traces equal (same
numpy draws), greedy tokens and every outcome identical, registry deltas
equal counter for counter (the reference's jit trace counters aside) and
equal floats where the fake clock makes them deterministic.
"""
import jax
import numpy as np
import pytest

from repro.configs import ARCHS
from repro.models.registry import build_model as j_build
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SLOConfig as JSLOConfig
from repro.serve import TrafficConfig as JTrafficConfig
from repro.serve import make_trace as j_make_trace
from repro_torch.bridge import from_numpy_tree
from repro_torch.models.registry import build_model
from repro_torch.serve import (ArrivalFeed, Request, Scheduler, ServeEngine,
                               SLOConfig, TrafficConfig, make_trace,
                               summarize)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def fp_setup():
    cfg = ARCHS["llama3-8b"].tiny()
    jm = j_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, build_model(cfg), tp, jm, jp


def _ticker(dt):
    tick = {"t": 0.0}

    def clock():
        tick["t"] += dt
        return tick["t"]
    return clock


# -- trace generation ---------------------------------------------------------

def test_make_trace_seeded_and_shaped():
    cfg = TrafficConfig(n_requests=50, rate=20.0, seed=3)
    t1, t2 = make_trace(cfg), make_trace(cfg)
    assert len(t1) == 50
    assert t1[0][0] == 0.0                      # first arrival at t=0
    offs = [t for t, _ in t1]
    assert offs == sorted(offs)
    for (a, ra), (b, rb) in zip(t1, t2):        # same seed -> same trace
        assert a == b
        np.testing.assert_array_equal(ra.prompt, rb.prompt)
    lens = [len(r.prompt) for _, r in t1]
    assert max(lens) <= cfg.prompt_len_max and min(lens) >= 1
    assert len(set(lens)) > 3                   # long-tail, not constant


def test_make_trace_bursty_and_shared_prefix():
    cfg = TrafficConfig(n_requests=24, process="bursty", burst_size=6,
                        rate=30.0, shared_prefix_frac=1.0, seed=1)
    trace = make_trace(cfg)
    offs = [t for t, _ in trace]
    assert len(set(offs)) == 4                  # 24/6 bursts
    firsts = {tuple(r.prompt[:cfg.prefix_len]) for _, r in trace}
    assert 1 <= len(firsts) <= cfg.n_prefixes
    with pytest.raises(ValueError):
        make_trace(TrafficConfig(process="weibull"))


@pytest.mark.parametrize("kw", [
    dict(n_requests=40, rate=20.0, seed=3, deadline_s=0.3),
    dict(n_requests=24, process="bursty", burst_size=6, rate=30.0,
         shared_prefix_frac=1.0, seed=1),
    dict(n_requests=12, rate=5.0, prompt_len_median=300,
         prompt_len_max=700, vocab_size=4096, shared_prefix_frac=0.0,
         max_new_tokens=32, seed=0)])
def test_make_trace_equals_reference(kw):
    """The same config gives repro's trace: offsets, prompts, budgets and
    relative deadlines (the port draws the same numpy values in the same
    order)."""
    ours, theirs = make_trace(TrafficConfig(**kw)), \
        j_make_trace(JTrafficConfig(**kw))
    assert len(ours) == len(theirs)
    for (a, ra), (b, rb) in zip(ours, theirs):
        assert a == b and ra.rid == rb.rid
        np.testing.assert_array_equal(ra.prompt, rb.prompt)
        assert ra.prompt.dtype == rb.prompt.dtype
        assert (ra.max_new_tokens, ra.rel_deadline) == \
            (rb.max_new_tokens, rb.rel_deadline)


# -- arrival feed -------------------------------------------------------------

def test_arrival_feed_releases_by_clock():
    reqs = [Request(rid=i, prompt=np.ones(4, np.int32)) for i in range(3)]
    arrivals = {}
    feed = ArrivalFeed([(0.0, reqs[0]), (1.0, reqs[1]), (2.5, reqs[2])],
                       record=lambda rid, t: arrivals.__setitem__(rid, t))
    assert feed.pending() and feed.next_time() is None  # not anchored yet
    assert [r.rid for r in feed.poll(10.0)] == [0]      # anchors t0=10
    assert feed.next_time() == 11.0
    assert feed.poll(10.5) == []
    assert [r.rid for r in feed.poll(12.9)] == [1, 2]
    assert not feed.pending() and feed.next_time() is None
    assert arrivals == {0: 10.0, 1: 11.0, 2: 12.5}


def test_arrival_feed_edf_orders_same_poll():
    reqs = [Request(rid=i, prompt=np.ones(4, np.int32)) for i in range(3)]
    reqs[0].deadline = 9.0
    reqs[2].deadline = 5.0          # tightest deadline, latest offset
    feed = ArrivalFeed([(0.5, reqs[0]), (0.6, reqs[1]), (0.7, reqs[2])])
    assert feed.poll(10.0) == []                        # anchors t0=10
    assert [r.rid for r in feed.poll(20.0)] == [2, 0, 1]


# -- percentile report --------------------------------------------------------

def test_summarize_percentiles():
    records = {i: dict(arrival=0.0, admit=0.01 * i, first=0.02 + 0.01 * i,
                       end=0.10 + 0.01 * i, tokens=5)
               for i in range(20)}
    rep = summarize(records)
    assert rep["submitted"] == rep["completed"] == 20
    assert rep["tokens"] == 100
    for key in ("ttft_ms", "queue_delay_ms", "per_token_ms"):
        dist = rep[key]
        assert np.isfinite([dist["p50"], dist["p95"], dist["p99"]]).all()
        assert dist["p50"] <= dist["p95"] <= dist["p99"]
    assert rep["ttft_ms"]["p50"] == pytest.approx(115.0)


# -- clock seam ---------------------------------------------------------------

def test_injected_clock_drives_deadlines(fp_setup):
    """One ``clock=`` seam end to end: a fake clock makes a mid-decode
    deadline expire deterministically, no monkeypatching."""
    cfg, m, params = fp_setup[:3]
    clock = _ticker(1.0)
    eng = ServeEngine(m, params, n_slots=1, max_len=64, clock=clock, **CPU)
    assert Scheduler(eng).clock is clock
    prompt = (np.arange(6) % cfg.vocab_size).astype(np.int32)
    ref = ServeEngine(m, params, n_slots=1, max_len=64, **CPU).serve(
        [Request(rid=1, prompt=prompt, max_new_tokens=30)])[1]
    out = eng.serve([Request(rid=0, prompt=prompt, max_new_tokens=30,
                             deadline=8.5)])[0]
    mm = eng.metrics()
    assert mm["truncated"] == 1 and mm["expired"] == 0
    assert 0 < len(out) < 30
    np.testing.assert_array_equal(out, ref[:len(out)])


# -- open-loop serving --------------------------------------------------------

def test_run_traffic_records_and_percentiles(fp_setup):
    cfg, m, params = fp_setup[:3]
    eng = ServeEngine(m, params, n_slots=2, max_len=64,
                      clock=_ticker(0.002), **CPU)
    tcfg = TrafficConfig(n_requests=10, rate=100.0, max_new_tokens=4,
                         prompt_len_median=6, prompt_len_max=20,
                         vocab_size=cfg.vocab_size, seed=7)
    res = Scheduler(eng).run_traffic(make_trace(tcfg))
    assert len(res) == 10
    rep = res.traffic
    assert rep["submitted"] == rep["completed"] == 10
    assert rep["tokens"] == 40
    for rec in res.records.values():
        assert rec["arrival"] is not None
        assert rec["admit"] >= rec["arrival"]
        assert rec["first"] >= rec["admit"]
        assert rec["end"] >= rec["first"]
        assert rec["tokens"] == 4
    for key in ("ttft_ms", "queue_delay_ms", "per_token_ms"):
        dist = rep[key]
        assert np.isfinite([dist["p50"], dist["p95"], dist["p99"]]).all()
        assert dist["p50"] <= dist["p95"] <= dist["p99"]


def test_run_traffic_greedy_matches_closed_loop(fp_setup):
    """Open-loop admission changes *when* requests run, never what they
    generate: greedy outputs match the closed-loop serve."""
    cfg, m, params = fp_setup[:3]
    tcfg = TrafficConfig(n_requests=8, rate=50.0, max_new_tokens=4,
                         vocab_size=cfg.vocab_size, seed=11)
    eng = ServeEngine(m, params, n_slots=2, max_len=64, **CPU)
    res = Scheduler(eng).run_traffic(make_trace(tcfg))
    closed = ServeEngine(m, params, n_slots=2, max_len=64, **CPU).serve(
        [Request(rid=100 + r.rid, prompt=r.prompt,
                 max_new_tokens=r.max_new_tokens)
         for _, r in make_trace(tcfg)])
    for t, r in make_trace(tcfg):
        np.testing.assert_array_equal(res[r.rid], closed[100 + r.rid])


# -- the port against repro ---------------------------------------------------

@pytest.mark.parametrize("slo", [False, True], ids=["plain", "slo"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_run_traffic_equals_reference(fp_setup, paged, slo):
    """One trace and one fake clock through both schedulers: equal
    tokens, outcomes, per-request records (same clock reads, so the same
    stamps) and registry deltas.  The SLO run overloads one tenant's quota
    and sheds with seeded retries, so every branch of admission runs."""
    cfg, m, params, jm, jp = fp_setup
    kw = dict(n_requests=12, rate=400.0, max_new_tokens=5,
              prompt_len_median=8, prompt_len_max=24,
              vocab_size=cfg.vocab_size, seed=5,
              deadline_s=0.12 if slo else None)
    ekw = dict(n_slots=2, max_len=64, paged=paged, page_size=8)
    scfg = dict(retry_base_s=0.01, seed=0, quotas={"b": 40})

    def tenants(trace):
        for i, (_, r) in enumerate(trace):
            r.tenant = "ab"[i % 2]
        return trace

    eng = ServeEngine(m, params, clock=_ticker(0.002), **ekw, **CPU,
                      slo=SLOConfig(**scfg) if slo else None)
    ours = Scheduler(eng).run_traffic(tenants(make_trace(
        TrafficConfig(**kw))))
    jeng = JServeEngine(jm, jp, clock=_ticker(0.002), **ekw,
                        slo=JSLOConfig(**scfg) if slo else None)
    theirs = JScheduler(jeng).run_traffic(tenants(j_make_trace(
        JTrafficConfig(**kw))))
    assert sorted(ours) == sorted(theirs)
    for rid in theirs:
        np.testing.assert_array_equal(ours[rid], np.asarray(theirs[rid]))
    assert ours.records == theirs.records
    assert ours.summary == theirs.summary
    assert ours.traffic["outcomes"] == theirs.traffic["outcomes"]
    extra = set(theirs.registry_delta) - set(ours.registry_delta)
    assert all(k.startswith("serve.jit_traces{") for k in extra), extra
    for key, val in ours.registry_delta.items():
        assert val == theirs.registry_delta[key], key
    s = ours.summary
    assert (s["completed"] + s["expired"] + s["truncated"] + s["shed"]
            == 12)
    if slo:
        assert s["shed_retried"] >= 1 and s["completed"] < 12
