"""Chaos in the port: the serve loop survives deterministic injected
faults.  Under seeded allocation failures, stalls, forced preemptions and
arrival bursts, serve() never raises, survivors stay bit-identical to the
uninterrupted run, every injected fault is counted in
``metrics()["faults"]``, and a chaos run equals repro's on the same
inputs and schedule.

Mirrors tests/test_chaos.py on the CPU (every kernel runs its plain
version) but for its checkpoint test: the port has no checkpoint writer
yet, so ``FaultInjector.ckpt_hook`` is held on its own.  Weights are
repro's tiny llama3-8b (4 layers, d_model 128, f32), crossed to the port
as numpy arrays.
"""
import jax
import numpy as np
import pytest

from repro.configs import ARCHS
from repro.models.registry import build_model as j_build
from repro.serve import FaultConfig as JFaultConfig
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TrafficConfig as JTrafficConfig
from repro.serve import make_trace as j_make_trace
from repro.serve.faults import burstify as j_burstify
from repro_torch.bridge import from_numpy_tree
from repro_torch.models.registry import build_model
from repro_torch.serve import (FaultConfig, FaultInjector, Request,
                               Scheduler, ServeEngine, SLOConfig,
                               TrafficConfig, make_trace)
from repro_torch.serve.faults import burstify

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def fp_setup():
    cfg = ARCHS["llama3-8b"].tiny()
    jm = j_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, build_model(cfg), tp, jm, jp


def _ticker(dt=0.001):
    tick = {"t": 0.0}

    def clock():
        tick["t"] += dt
        return tick["t"]
    return tick, clock


def _reqs(cfg, n=4, new_tokens=8, cls=Request):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           6 + 3 * i).astype(np.int32),
                max_new_tokens=new_tokens) for i in range(n)]


def _audit_pool(pool):
    """Every held page is exactly the set of index-registered pages and
    each carries refcount 1; everything else is on the free list."""
    held = int((np.asarray(pool.ref[1:]) > 0).sum())
    assert held == len(set(pool.index.values()))
    assert all(pool.ref[p] == 1 for p in pool.index.values())
    assert len(pool.free) == pool.n_pages - 1 - held


PAGED = dict(n_slots=2, max_len=64, paged=True, page_size=8, n_pages=24)


# -- page-allocation faults ---------------------------------------------------

def test_alloc_fault_storm_survivors_bit_identical(fp_setup):
    """Vetoed allocations look like pool exhaustion and route through
    backpressure (preempt -> retry); greedy outputs match the fault-free
    run bit for bit and every veto is counted."""
    cfg, m, params = fp_setup[:3]
    ref = ServeEngine(m, params, **PAGED, **CPU).serve(_reqs(cfg))
    inj = FaultInjector(FaultConfig(alloc_fail_at=(0, 2, 5),
                                    alloc_fail_every=4, alloc_fail_max=8))
    eng = ServeEngine(m, params, **PAGED, faults=inj, **CPU)
    out = eng.serve(_reqs(cfg))
    met = eng.metrics()
    assert met["faults"]["alloc_failures"] >= 4
    assert met["pressure_events"] >= 1
    assert met["completed"] == len(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid])
    _audit_pool(eng._stepper.pool)


def test_alloc_fail_every_liveness_cap(fp_setup):
    """alloc_fail_every=1 vetoes *every* allocation; the alloc_fail_max
    cap guarantees the storm ends and all requests still finish."""
    cfg, m, params = fp_setup[:3]
    inj = FaultInjector(FaultConfig(alloc_fail_every=1, alloc_fail_max=6))
    eng = ServeEngine(m, params, **PAGED, faults=inj, **CPU)
    out = eng.serve(_reqs(cfg, n=3))
    met = eng.metrics()
    assert met["faults"]["alloc_failures"] == 6
    assert met["completed"] == 3
    assert all(len(out[r]) == 8 for r in out)


def test_pool_exhausted_unreachable_under_chaos(fp_setup):
    """Tiny pool + allocation storm + forced preemptions: serve() never
    raises; every request reaches exactly one terminal outcome and the
    pool's refcounts reconcile afterwards."""
    cfg, m, params = fp_setup[:3]
    inj = FaultInjector(FaultConfig(alloc_fail_at=(1, 3, 4),
                                    alloc_fail_every=3, alloc_fail_max=12,
                                    preempt_at=tuple(range(2, 30, 5))))
    eng = ServeEngine(m, params, n_slots=3, max_len=64, paged=True,
                      page_size=8, n_pages=8, faults=inj, **CPU)
    n = 5
    out = eng.serve(_reqs(cfg, n=n))
    met = eng.metrics()
    terminal = (met["completed"] + met["shed"] + met["expired"]
                + met["truncated"])
    assert terminal == n == len(out)
    assert met["faults"]["alloc_failures"] >= 3
    _audit_pool(eng._stepper.pool)


def test_chaos_run_equals_reference(fp_setup):
    """The pool-exhaustion chaos schedule through repro's engine: the same
    tokens, outcomes, fault counts and pool counters."""
    cfg, m, params, jm, jp = fp_setup
    fkw = dict(alloc_fail_at=(1, 3, 4), alloc_fail_every=3,
               alloc_fail_max=12, preempt_at=tuple(range(2, 30, 5)))
    ekw = dict(n_slots=3, max_len=64, paged=True, page_size=8, n_pages=8)
    ours = ServeEngine(m, params, **ekw, **CPU,
                       faults=FaultInjector(FaultConfig(**fkw)))
    theirs = JServeEngine(jm, jp, **ekw,
                          faults=JFaultInjector(JFaultConfig(**fkw)))
    out = ours.serve(_reqs(cfg, n=5))
    jout = theirs.serve(_reqs(cfg, n=5, cls=JRequest))
    for rid in jout:
        np.testing.assert_array_equal(out[rid], np.asarray(jout[rid]))
    mm, jmm = ours.metrics(), theirs.metrics()
    assert mm["faults"] == jmm["faults"]
    for key in ("completed", "shed", "expired", "truncated", "preempted",
                "resumed", "pressure_events", "decode_steps",
                "prefill_batches", "prefix_hits", "page_allocs",
                "cow_copies", "page_evictions", "pages_peak"):
        assert mm[key] == jmm[key], key


# -- stalls -------------------------------------------------------------------

def test_stall_burns_fake_clock_and_is_counted(fp_setup):
    cfg, m, params = fp_setup[:3]
    tick, clock = _ticker(dt=0.001)

    def advance(dt):
        tick["t"] += dt

    inj = FaultInjector(FaultConfig(stall_at=(1, 3), stall_s=0.5),
                        advance=advance)
    eng = ServeEngine(m, params, n_slots=2, max_len=64, clock=clock,
                      faults=inj, **CPU)
    eng.serve(_reqs(cfg, n=2, new_tokens=4))
    met = eng.metrics()
    assert met["faults"]["stalls"] == 2
    assert met["serve_time_s"] >= 1.0       # two 0.5 s stalls landed


def test_stalled_run_expires_requests_against_deadline(fp_setup):
    cfg, m, params = fp_setup[:3]
    tick, clock = _ticker(dt=0.001)
    inj = FaultInjector(FaultConfig(stall_at=(2,), stall_s=60.0),
                        advance=lambda dt: tick.__setitem__(
                            "t", tick["t"] + dt))
    eng = ServeEngine(m, params, n_slots=1, max_len=64, clock=clock,
                      faults=inj, **CPU)
    reqs = _reqs(cfg, n=3, new_tokens=4)
    for r in reqs:
        r.deadline = 30.0                   # < the 60 s injected hang
    out = eng.serve(reqs)
    met = eng.metrics()
    assert met["faults"]["stalls"] == 1
    assert met["expired"] + met["truncated"] >= 1
    assert (met["completed"] + met["expired"] + met["truncated"]
            + met["shed"]) == 3 == len(out)


# -- forced preemption + bursts ----------------------------------------------

def test_bursty_chaos_traffic_accounting(fp_setup):
    cfg, m, params = fp_setup[:3]
    _, clock = _ticker(dt=0.002)
    fcfg = FaultConfig(seed=3, burst_every=3, burst_span=4,
                       preempt_at=tuple(range(4, 40, 7)))
    inj = FaultInjector(fcfg)
    eng = ServeEngine(m, params, **PAGED, clock=clock,
                      slo=SLOConfig(seed=1), faults=inj, **CPU)
    tcfg = TrafficConfig(n_requests=10, rate=200.0, max_new_tokens=4,
                         prompt_len_median=8, prompt_len_max=24,
                         vocab_size=cfg.vocab_size, seed=5)
    trace = burstify(make_trace(tcfg), fcfg)
    res = Scheduler(eng).run_traffic(trace)
    s = res.summary
    assert (s["completed"] + s["shed"] + s["expired"] + s["truncated"]
            == res.traffic["submitted"] == 10)
    assert s["preempted"] == s["resumed"]
    _audit_pool(eng._stepper.pool)


def test_burstify_deterministic_and_order_preserving():
    fcfg = FaultConfig(seed=9, burst_every=3, burst_span=4)
    tcfg = TrafficConfig(n_requests=16, rate=50.0, seed=2)
    a = burstify(make_trace(tcfg), fcfg)
    b = burstify(make_trace(tcfg), fcfg)
    assert [t for t, _ in a] == [t for t, _ in b]
    assert [r.rid for _, r in a] == [r.rid for _, r in b]
    base = make_trace(tcfg)
    assert len(a) == len(base)
    assert sorted(r.rid for _, r in a) == sorted(r.rid for _, r in base)
    times = [t for t, _ in a]
    assert times == sorted(times)
    assert any(t1 == t2 for t1, t2 in zip(times, times[1:]))


@pytest.mark.parametrize("seed,every,span", [(9, 3, 4), (0, 2, 5),
                                             (3, 5, 2)])
def test_burstify_equals_reference(seed, every, span):
    fkw = dict(seed=seed, burst_every=every, burst_span=span)
    tkw = dict(n_requests=30, rate=50.0, seed=seed + 1)
    ours = burstify(make_trace(TrafficConfig(**tkw)), FaultConfig(**fkw))
    theirs = j_burstify(j_make_trace(JTrafficConfig(**tkw)),
                        JFaultConfig(**fkw))
    assert [(t, r.rid) for t, r in ours] == [(t, r.rid) for t, r in theirs]


def test_ckpt_hook_fails_scheduled_writes_only():
    """The checkpoint seam on its own (the port's checkpoint writer comes
    later): scheduled write indices raise OSError, the others pass, and
    each failure is counted."""
    inj = FaultInjector(FaultConfig(ckpt_fail_at=(1, 3)))
    failed = []
    for i in range(5):
        try:
            inj.ckpt_hook()
        except OSError as e:
            assert "injected checkpoint" in str(e)
            failed.append(i)
    assert failed == [1, 3]
    assert inj.counts["ckpt_failures"] == 2
    assert inj.metrics()["ckpt_writes"] == 5


# -- metrics surface ----------------------------------------------------------

def test_fault_metrics_surface_in_engine_metrics(fp_setup):
    cfg, m, params = fp_setup[:3]
    inj = FaultInjector(FaultConfig(alloc_fail_at=(0,), preempt_at=(2,)))
    eng = ServeEngine(m, params, **PAGED, faults=inj, **CPU)
    eng.serve(_reqs(cfg, n=2, new_tokens=4))
    f = eng.metrics()["faults"]
    for key in ("alloc_failures", "stalls", "forced_preempts",
                "ckpt_failures", "alloc_calls", "loop_iters",
                "ckpt_writes"):
        assert key in f
    assert f["alloc_calls"] > 0 and f["loop_iters"] > 0
    assert f["alloc_failures"] == 1
    assert eng.registry.snapshot()["faults.alloc_failures"] == 1
