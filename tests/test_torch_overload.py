"""Overload response in the port: SLO-aware admission (shed / retry /
quota / fairness), page-pool backpressure with preemption, and
resume-by-recompute bit identity; the SLO layer's seeded decisions equal
repro's.  Everything timing-sensitive runs on the injected fake clock.

Mirrors tests/test_overload.py on the CPU (every kernel runs its plain
version).  Weights are repro's tiny llama3-8b (4 layers, d_model 128,
f32), crossed to the port as numpy arrays.
"""
import jax
import numpy as np
import pytest

from repro.configs import ARCHS
from repro.models.registry import build_model as j_build
from repro.serve import Request as JRequest
from repro.serve import SLOAdmission as JSLOAdmission
from repro.serve import SLOConfig as JSLOConfig
from repro_torch.bridge import from_numpy_tree
from repro_torch.models.registry import build_model
from repro_torch.serve import (FaultConfig, FaultInjector, Request,
                               Scheduler, ServeEngine, SLOAdmission,
                               SLOConfig, request_tokens)
from repro_torch.serve.overload import pick_victim
from repro_torch.serve.slots import SlotTable, effective_prompt

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def fp_setup():
    cfg = ARCHS["llama3-8b"].tiny()
    jp = j_build(cfg).init(jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, build_model(cfg), tp


def _ticker(dt=0.001):
    tick = {"t": 0.0}

    def clock():
        tick["t"] += dt
        return tick["t"]
    return tick, clock


def _prompt(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, n).astype(np.int32)


# -- SLOAdmission unit behavior -----------------------------------------------

def test_request_tokens_constant_across_progress():
    """The admission cost never changes as a request emits tokens, so
    quota acquire/release stays symmetric through preempt/resume."""
    r = Request(rid=0, prompt=np.ones(10, np.int32), max_new_tokens=6)
    before = request_tokens(r)
    r.out_tokens = [1, 2, 3]
    assert request_tokens(r) == before == 16


def test_slo_estimate_and_shed_gate():
    slo = SLOAdmission(SLOConfig(margin=1.0, window=8, pct=100.0))
    assert slo.estimate() == 0.0
    for d in (0.1, 0.2, 0.3):
        slo.observe(d)
    assert slo.estimate() == pytest.approx(0.3)
    req = Request(rid=0, prompt=np.ones(4, np.int32))
    req.deadline = 10.0
    assert not slo.should_shed(req, now=9.5)    # 9.5 + 0.3 <= 10
    assert slo.should_shed(req, now=9.8)        # 9.8 + 0.3 > 10
    req.deadline = None
    assert not slo.should_shed(req, now=1e9)    # no SLO, never shed


def test_slo_retry_after_seeded_and_exponential():
    a, b = (SLOAdmission(SLOConfig(retry_base_s=0.1, seed=5))
            for _ in range(2))
    req = Request(rid=0, prompt=np.ones(4, np.int32))
    req.retries = 1
    r1, r2 = a.retry_after(req), a.retry_after(req)
    assert r1 != r2
    assert [r1, r2] == [b.retry_after(req), b.retry_after(req)]
    req.retries = 3
    assert 0.2 <= a.retry_after(req) < 0.6


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_slo_decisions_equal_reference(seed):
    """The same observations, submissions and retries give repro's
    estimates, shed decisions, fairness keys, quota answers and seeded
    retry-after sequence, value for value."""
    kw = dict(margin=1.5, window=6, pct=90.0, retry_base_s=0.03,
              quota_tokens=40, quotas={"vip": 90}, weights={"heavy": 3.0},
              seed=seed)
    ours, theirs = SLOAdmission(SLOConfig(**kw)), \
        JSLOAdmission(JSLOConfig(**kw))
    rng = np.random.default_rng(seed)
    got, want = [], []
    for i in range(40):
        d = float(rng.exponential(0.05))
        tenant = ("heavy", "light", "vip")[i % 3]
        n, budget = int(rng.integers(1, 30)), int(rng.integers(1, 12))
        retries = 1 + i % 4
        for slo, req_cls, out in ((ours, Request, got),
                                  (theirs, JRequest, want)):
            slo.observe(d)
            req = req_cls(rid=i, prompt=np.ones(n, np.int32),
                          max_new_tokens=budget, tenant=tenant,
                          deadline=1.0 + 0.01 * i, retries=retries)
            out.append((slo.estimate(), slo.should_shed(req, 0.95 + 0.01 * i),
                        slo.fair_key(req), slo.quota_ok(req),
                        slo.retry_after(req)))
            if i % 5 == 0:
                slo.acquire(req)
    assert got == want


def test_slo_quota_and_fairness():
    slo = SLOAdmission(SLOConfig(quota_tokens=40, quotas={"vip": 200},
                                 weights={"heavy": 4.0}))
    small = Request(rid=0, prompt=np.ones(10, np.int32), max_new_tokens=6,
                    tenant="t1")
    assert slo.quota_ok(small)
    slo.acquire(small)
    assert slo.quota_ok(small)          # 16 + 16 = 32 <= 40
    slo.acquire(small)
    assert not slo.quota_ok(small)      # 32 + 16 > 40
    slo.release(small)
    assert slo.quota_ok(small)
    vip = Request(rid=1, prompt=np.ones(100, np.int32), max_new_tokens=6,
                  tenant="vip")
    assert slo.quota_ok(vip)            # per-tenant override
    heavy = Request(rid=2, prompt=np.ones(10, np.int32), max_new_tokens=6,
                    tenant="heavy")
    light = Request(rid=3, prompt=np.ones(10, np.int32), max_new_tokens=6,
                    tenant="light")
    keys = [(slo.fair_key(heavy), "h") for _ in range(4)]
    keys += [(slo.fair_key(light), "l") for _ in range(4)]
    ordered = [tag for _, tag in sorted(keys, key=lambda kv: kv[0])]
    assert ordered.index("l") < len(keys) - 1
    assert ordered[-1] == "l"           # light's vtime grows 4x faster


def test_pick_victim_excludes_pressure_slot():
    st = SlotTable(3, "cpu")
    for s in range(3):
        st.bind(Request(rid=s, prompt=np.ones(2, np.int32),
                        max_new_tokens=4), s)
    st.req[0].deadline = 5.0
    st.req[1].deadline = 9.0
    st.req[2].deadline = None           # latest (inf) -> victim
    assert pick_victim(st) == 2
    assert pick_victim(st, exclude=2) == 1
    st.clear(1)
    st.clear(0)
    assert pick_victim(st, exclude=2) == 2      # sole slot stays eligible


# -- scheduler integration ----------------------------------------------------

def test_submit_rejects_duplicate_rid(fp_setup):
    cfg, m, params = fp_setup
    sch = Scheduler(ServeEngine(m, params, n_slots=1, max_len=32, **CPU))
    sch.submit(Request(rid=7, prompt=_prompt(cfg, 4), max_new_tokens=1))
    with pytest.raises(ValueError, match="rid 7 is already queued"):
        sch.submit(Request(rid=7, prompt=_prompt(cfg, 4), max_new_tokens=1))
    res = sch.run()
    assert len(res[7]) == 1
    sch.submit(Request(rid=7, prompt=_prompt(cfg, 4), max_new_tokens=1))


def test_deadline_exactly_at_admit_boundary(fp_setup):
    """Expiry is strict `>`: a request whose deadline equals the clock at
    the admission check still admits; past the deadline it expires before
    any work."""
    cfg, m, params = fp_setup
    box = {"t": 5.0}
    eng = ServeEngine(m, params, n_slots=1, max_len=32,
                      clock=lambda: box["t"], **CPU)
    out = eng.serve([Request(rid=0, prompt=_prompt(cfg, 4),
                             max_new_tokens=2, deadline=5.0)])
    m1 = eng.metrics()
    assert m1["expired"] == 0 and m1["completed"] == 1
    assert len(out[0]) == 2
    box["t"] = 5.0 + 1e-6
    out = eng.serve([Request(rid=1, prompt=_prompt(cfg, 4),
                             max_new_tokens=2, deadline=5.0)])
    m2 = eng.metrics()
    assert m2["expired"] == 1 and len(out[1]) == 0


def test_slo_sheds_doomed_request(fp_setup):
    cfg, m, params = fp_setup
    _, clock = _ticker(dt=0.01)
    slo = SLOAdmission(SLOConfig(margin=1.0))
    for _ in range(8):
        slo.observe(5.0)                # queue-delay estimate: 5 s
    eng = ServeEngine(m, params, n_slots=1, max_len=32, clock=clock,
                      slo=slo, **CPU)
    req = Request(rid=0, prompt=_prompt(cfg, 4), max_new_tokens=2)
    req.deadline = 2.0                  # < now + 5s estimate: doomed
    res = eng.serve([req])
    m1 = eng.metrics()
    assert m1["shed"] == 1 and m1["completed"] == 0
    assert res[0].size == 0 and req.outcome == "shed"
    assert eng.registry.snapshot()["serve.shed_by_tenant{tenant=default}"] \
        == 1


def test_run_traffic_overload_accounting_and_retries(fp_setup):
    from repro_torch.serve import TrafficConfig, make_trace
    cfg, m, params = fp_setup
    _, clock = _ticker(dt=0.004)
    eng = ServeEngine(m, params, n_slots=1, max_len=64, clock=clock,
                      slo=SLOConfig(retry_base_s=0.02), **CPU)
    tcfg = TrafficConfig(n_requests=12, rate=500.0, max_new_tokens=4,
                         prompt_len_median=6, prompt_len_max=20,
                         vocab_size=cfg.vocab_size, deadline_s=0.25,
                         seed=11)
    res = Scheduler(eng).run_traffic(make_trace(tcfg))
    s, rep = res.summary, res.traffic
    assert (s["completed"] + s["shed"] + s["expired"] + s["truncated"]
            == rep["submitted"] == 12)
    assert sum(rep["outcomes"].values()) == 12
    assert s["expired"] + s["shed"] >= 1        # the overload actually bit
    for key in ("ttft_ms", "queue_delay_ms", "survivor_ttft_ms"):
        assert all(np.isfinite(list(rep[key].values())))


def test_quota_defers_tenant_but_completes_everyone(fp_setup):
    cfg, m, params = fp_setup
    slo = SLOConfig(quotas={"bulk": 20})   # one 4+6-token request at a time
    eng = ServeEngine(m, params, n_slots=2, max_len=32, slo=slo, **CPU)
    reqs = [Request(rid=i, prompt=_prompt(cfg, 4, seed=i),
                    max_new_tokens=6, tenant="bulk") for i in range(3)]
    res = eng.serve(reqs)
    assert all(len(res[i]) == 6 for i in range(3))
    assert eng.metrics()["completed"] == 3
    assert eng.slo._inflight["bulk"] == 0   # symmetric acquire/release


def test_oversized_tenant_request_sheds_terminally(fp_setup):
    cfg, m, params = fp_setup
    eng = ServeEngine(m, params, n_slots=1, max_len=64,
                      slo=SLOConfig(quota_tokens=8), **CPU)
    req = Request(rid=0, prompt=_prompt(cfg, 10), max_new_tokens=4)
    res = eng.serve([req])
    assert res[0].size == 0 and req.outcome == "shed"
    assert eng.metrics()["shed"] == 1


# -- preempt + resume bit-identity --------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_preempt_resume_bit_identical(fp_setup, paged):
    """Forced preemptions (the dense cache has no page pressure of its
    own) re-queue and resume requests; greedy outputs match the
    uninterrupted run bit for bit on both cache kinds."""
    cfg, m, params = fp_setup
    reqs = lambda: [Request(rid=i, prompt=_prompt(cfg, 6 + 3 * i, seed=i),
                            max_new_tokens=10) for i in range(3)]
    ref = ServeEngine(m, params, n_slots=2, max_len=64, paged=paged,
                      **CPU).serve(reqs())
    faults = FaultInjector(FaultConfig(preempt_at=(2, 5, 9, 14)))
    eng = ServeEngine(m, params, n_slots=2, max_len=64, paged=paged,
                      faults=faults, **CPU)
    out = eng.serve(reqs())
    met = eng.metrics()
    assert met["preempted"] >= 1 and met["resumed"] == met["preempted"]
    assert met["faults"]["forced_preempts"] == met["preempted"]
    for i in range(3):
        np.testing.assert_array_equal(out[i], ref[i])


@pytest.fixture(scope="module")
def packed_setup(fp_setup):
    """FAQ int4 packed serving weights and their calibration statistics."""
    from repro_torch.core import QuantSpec, quantize_model, run_calibration
    cfg, m, params = fp_setup
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32))
             .astype(np.int32)}
    stats = run_calibration(m.forward, params, [batch])
    qp, _ = quantize_model(params, m.quant_site_map(), stats, method="faq",
                           spec=QuantSpec(bits=4, group_size=64),
                           mode="packed")
    return qp, stats


@pytest.mark.parametrize("paged", [False, True])
def test_preempt_resume_bit_identical_spec(fp_setup, packed_setup, paged):
    """Same bit identity under speculative decoding: preemption resets
    the victim's draft state; the resumed slot re-prefills the draft from
    the effective prompt."""
    from repro_torch.serve.draft import self_int8_draft
    from repro_torch.serve.spec import SpecConfig
    cfg, m, _ = fp_setup
    qp, stats = packed_setup
    mk_spec = lambda: SpecConfig(k=3, draft=self_int8_draft(m, qp, stats))
    reqs = lambda: [Request(rid=i, prompt=_prompt(cfg, 5 + 2 * i, seed=i),
                            max_new_tokens=8) for i in range(2)]
    ref = ServeEngine(m, qp, n_slots=2, max_len=64, paged=paged,
                      spec=mk_spec(), **CPU).serve(reqs())
    eng = ServeEngine(m, qp, n_slots=2, max_len=64, paged=paged,
                      spec=mk_spec(),
                      faults=FaultInjector(FaultConfig(preempt_at=(1, 4))),
                      **CPU)
    out = eng.serve(reqs())
    assert eng.metrics()["preempted"] >= 1
    for i in range(2):
        np.testing.assert_array_equal(out[i], ref[i])


def test_refcount_audit_after_preempt_storm(fp_setup):
    cfg, m, params = fp_setup
    faults = FaultInjector(FaultConfig(preempt_at=tuple(range(1, 40, 2))))
    eng = ServeEngine(m, params, n_slots=3, max_len=64, paged=True,
                      page_size=8, faults=faults, **CPU)
    reqs = [Request(rid=i, prompt=_prompt(cfg, 4 + 5 * i, seed=i),
                    max_new_tokens=9) for i in range(5)]
    res = eng.serve(reqs)
    assert all(len(res[i]) == 9 for i in range(5))
    assert eng.metrics()["preempted"] >= 5
    pool = eng._stepper.pool
    assert pool.ref[pool.TRASH] == 1
    held = {p for p in range(1, pool.n_pages) if pool.ref[p] > 0}
    assert held == set(pool.index.values())
    assert all(pool.ref[p] == 1 for p in held)
    assert len(pool.free) == pool.n_pages - 1 - len(held)


def test_effective_prompt_resume_semantics():
    r = Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                max_new_tokens=8)
    np.testing.assert_array_equal(effective_prompt(r), r.prompt)
    r.out_tokens = [9, 8]
    np.testing.assert_array_equal(effective_prompt(r), r.prompt)
    r.resume = True
    np.testing.assert_array_equal(effective_prompt(r),
                                  np.array([1, 2, 3, 4, 9, 8], np.int32))


# -- summarize hardening ------------------------------------------------------

def test_summarize_empty_and_zero_completion_records():
    from repro_torch.serve import summarize
    rep = summarize({})
    assert rep["submitted"] == rep["completed"] == 0
    assert rep["tokens_per_s"] == 0.0
    for key in ("ttft_ms", "queue_delay_ms", "per_token_ms",
                "survivor_ttft_ms"):
        assert rep[key] == dict(p50=0.0, p95=0.0, p99=0.0, mean=0.0, n=0)
    rep = summarize({0: dict(arrival=1.0, admit=None, first=None, end=2.0,
                             tokens=0, outcome="shed"),
                     1: dict(arrival=1.0, admit=None, first=None, end=None,
                             tokens=0, outcome=None)})
    assert rep["submitted"] == 2 and rep["completed"] == 1
    assert rep["outcomes"] == {"shed": 1}
    vals = [v for d in (rep["ttft_ms"], rep["per_token_ms"],
                        rep["survivor_ttft_ms"]) for v in d.values()]
    assert all(np.isfinite(vals))
