"""The port's observability layer (``repro_torch.obs``, ``serve/instrument``)
against repro's: registry semantics, the engine's metrics key set, span
tracing determinism, the bounded trace ring, and the same spans and
registry deltas as repro's engine on the same trace and fake clock.

Mirrors tests/test_obs.py on the CPU (every kernel runs its plain
version).  Weights are repro's tiny llama3-8b (4 layers, d_model 128,
f32), crossed to the port as numpy arrays.  The JAX-only part of the
reference's surface (jit compile / retrace events, ``serve.jit_traces``)
has no counterpart: eager PyTorch traces nothing, so the port reports
``retrace_count`` 0 and an empty ``retrace_by_entry``.  Timestamps of
the two engines' traces are not compared, only names, tracks, arguments
and nesting.
"""
import json

import jax
import numpy as np
import pytest

from repro.configs import ARCHS
from repro.models.registry import build_model as j_build
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TrafficConfig as JTrafficConfig
from repro.serve import make_trace as j_make_trace
from repro_torch.bridge import from_numpy_tree
from repro_torch.models.registry import build_model
from repro_torch.obs import (DEFAULT_MS_EDGES, Histogram, MetricsRegistry,
                             Tracer, check_span_nesting, dist_ms,
                             never_nan_percentile, validate_trace)
from repro_torch.serve import (FaultConfig, FaultInjector, Request,
                               Scheduler, ServeEngine, TrafficConfig,
                               make_trace)

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
    return clock


# -- registry primitives ------------------------------------------------------

def test_counter_gauge_histogram_snapshot_delta():
    r = MetricsRegistry()
    c = r.counter("serve.tokens")
    c.inc(5)
    r.gauge("pool.in_use").set(7)
    h = r.histogram("serve.step_ms")
    for x in (0.5, 3.0, 30.0, 3000.0):
        h.observe(x)
    snap = r.snapshot()
    assert snap["serve.tokens"] == 5
    assert snap["pool.in_use"] == 7
    assert snap["serve.step_ms"]["count"] == 4
    c.inc(2)
    h.observe(1.0)
    r.gauge("pool.in_use").set(3)
    d = r.delta(snap)
    # counters and histograms subtract; gauges report current
    assert d["serve.tokens"] == 2
    assert d["pool.in_use"] == 3
    assert d["serve.step_ms"]["count"] == 1
    assert sum(d["serve.step_ms"]["counts"]) == 1


def test_labels_qualify_names_and_kinds_clash():
    r = MetricsRegistry()
    r.counter("serve.shed_by_tenant", tenant="a").inc()
    r.counter("serve.shed_by_tenant", tenant="b").inc(2)
    snap = r.snapshot()
    assert snap["serve.shed_by_tenant{tenant=a}"] == 1
    assert snap["serve.shed_by_tenant{tenant=b}"] == 2
    with pytest.raises(TypeError):
        r.gauge("serve.shed_by_tenant", tenant="a")


def test_metric_group_mapping_protocol_and_rebind():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    g = r1.group("faults").init(stalls=0, preempts=0)
    g["stalls"] += 3
    assert dict(g) == {"stalls": 3, "preempts": 0}
    assert "stalls" in g and len(g) == 2
    assert sorted(g.keys()) == ["preempts", "stalls"]
    g.rebind(r2)
    g["preempts"] += 1
    assert r2.snapshot()["faults.preempts"] == 1
    assert r2.snapshot()["faults.stalls"] == 3  # value survives the move


def test_counter_preserves_value_type():
    r = MetricsRegistry()
    g = r.group("serve").init(steps=0, serve_time_s=0.0)
    g["steps"] += 1
    g["serve_time_s"] += 0.25
    assert isinstance(g["steps"], int)
    assert isinstance(g["serve_time_s"], float)


# -- shared percentile math ---------------------------------------------------

def test_never_nan_percentile_hardening():
    assert never_nan_percentile([], 99) == 0.0
    assert never_nan_percentile([float("nan"), float("inf")], 50) == 0.0
    xs = list(range(1, 101))
    assert never_nan_percentile(xs, 50) == float(np.percentile(xs, 50))


def test_dist_ms_frozen_shape():
    assert dist_ms([]) == dict(p50=0.0, p95=0.0, p99=0.0, mean=0.0, n=0)
    d = dist_ms([0.1, 0.2, 0.3])
    assert set(d) == {"p50", "p95", "p99", "mean", "n"} and d["n"] == 3
    assert d["p50"] == pytest.approx(200.0)


def test_histogram_buckets_and_percentile():
    h = Histogram.from_samples([0.5, 2.0, 8.0, 40.0, 999.0, 50_000.0])
    s = h.snapshot()
    assert s["count"] == 6 and s["counts"][-1] == 1     # overflow bucket
    assert len(s["counts"]) == len(DEFAULT_MS_EDGES) + 1
    assert 0.0 < h.percentile(50) <= 1000.0
    assert h.percentile(0) >= 0.0
    with pytest.raises(ValueError):
        Histogram(edges=(5.0, 1.0))


# -- the metrics surface ------------------------------------------------------

FROZEN_SUMMARY_KEYS = {
    "requests", "completed", "expired", "truncated", "shed", "preempted",
    "resumed", "tokens_generated", "tokens_per_s", "tokens_per_step",
    "tokens_per_step_by_request", "spec",
}

FROZEN_METRIC_KEYS = {
    "tokens_generated", "decode_steps", "prefill_batches", "completed",
    "expired", "truncated", "shed", "shed_retried", "preempted", "resumed",
    "admitted", "pressure_events", "serve_time_s", "prefill_calls",
    "prefill_traces", "decode_traces", "retrace_count", "paged", "buckets",
    "spec", "faults", "prefill_chunk", "chunked_admissions",
    "tokens_per_step", "tokens_per_s",
}


def _three(cls):
    return [cls(rid=i, prompt=np.arange(1, 7, dtype=np.int32),
                max_new_tokens=4) for i in range(3)]


def test_engine_metrics_keys_and_summary_frozen(fp_setup):
    cfg, m, params = fp_setup[:3]
    eng = ServeEngine(m, params, n_slots=2, max_len=64, **CPU)
    sched = Scheduler(eng)
    for r in _three(Request):
        sched.submit(r)
    res = sched.run()
    mm = eng.metrics()
    missing = FROZEN_METRIC_KEYS - set(mm)
    assert not missing, f"frozen metrics keys went missing: {missing}"
    assert FROZEN_SUMMARY_KEYS == set(res.summary)
    assert res.summary["completed"] == 3
    assert res.summary["tokens_generated"] == 12
    assert res.registry_delta["serve.completed"] == 3
    assert res.registry_delta["serve.tokens_generated"] == 12
    assert sum(mm["retrace_by_entry"].values()) == mm["retrace_count"]


def test_metrics_and_summary_equal_reference(fp_setup):
    """The same three requests through repro's Scheduler: the same metric
    keys, summary and every shared registry counter; the reference's only
    extra keys are its jit trace counters."""
    from repro.serve import Request as JRequest
    cfg, m, params, jm, jp = fp_setup
    out = {}
    for name, eng, req_cls, sch_cls in (
            ("port", ServeEngine(m, params, n_slots=2, max_len=64, **CPU),
             Request, Scheduler),
            ("ref", JServeEngine(jm, jp, n_slots=2, max_len=64), JRequest,
             JScheduler)):
        sched = sch_cls(eng)
        for r in _three(req_cls):
            sched.submit(r)
        res = sched.run()
        out[name] = (eng.metrics(), res)
    (pm, pres), (jmm, jres) = out["port"], out["ref"]
    assert set(pm) == set(jmm)
    skip = {"serve_time_s", "tokens_per_s"}
    for key in FROZEN_METRIC_KEYS - skip - {"prefill_traces",
                                            "decode_traces"}:
        assert pm[key] == jmm[key], key
    for key in FROZEN_SUMMARY_KEYS - {"tokens_per_s"}:
        assert pres.summary[key] == jres.summary[key], key
    extra = set(jres.registry_delta) - set(pres.registry_delta)
    assert all(k.startswith("serve.jit_traces{") for k in extra), extra
    for key, val in pres.registry_delta.items():
        if key != "serve.serve_time_s":
            assert val == jres.registry_delta[key], key
    for rid in pres:
        np.testing.assert_array_equal(pres[rid], np.asarray(jres[rid]))


def test_summary_is_delta_not_lifetime(fp_setup):
    cfg, m, params = fp_setup[:3]
    eng = ServeEngine(m, params, n_slots=2, max_len=64, **CPU)
    sched = Scheduler(eng)
    for run in range(2):
        sched.submit(Request(rid=run, prompt=np.arange(1, 5, dtype=np.int32),
                             max_new_tokens=3))
        s = sched.run().summary
        assert s["completed"] == 1 and s["tokens_generated"] == 3


# -- span tracing -------------------------------------------------------------

def _tcfg(cfg, cls=TrafficConfig):
    return cls(n_requests=8, rate=100.0, max_new_tokens=4,
               prompt_len_median=6, prompt_len_max=20,
               vocab_size=cfg.vocab_size, seed=7)


def _traced_run(cfg, m, params, *, capacity=8192):
    tracer = Tracer(capacity=capacity)
    eng = ServeEngine(m, params, n_slots=2, max_len=64, clock=_ticker(),
                      tracer=tracer, **CPU)
    Scheduler(eng).run_traffic(make_trace(_tcfg(cfg)))
    return eng, tracer


def test_trace_export_deterministic_bytes(tmp_path, fp_setup):
    cfg, m, params = fp_setup[:3]
    paths = []
    for i in range(2):
        eng, _ = _traced_run(cfg, m, params)
        p = tmp_path / f"trace{i}.json"
        eng.export_trace(p)
        paths.append(p)
    b0, b1 = paths[0].read_bytes(), paths[1].read_bytes()
    assert b0 == b1, "fake-clock trace export must be byte-identical"
    obj = json.loads(b0)
    assert validate_trace(obj) == []
    names = {e["name"] for e in obj["traceEvents"]}
    assert {"queue", "prefill", "decode", "arrival", "retire"} <= names


def _shape(events):
    """A trace's events without their timestamps."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_trace_equals_reference_but_for_timestamps(fp_setup):
    """The same trace and fake clock through repro's engine: the same
    events (names, tracks, arguments) in the same order, both nesting.
    The reference's jit compile events have no counterpart; they also read
    the fake clock, so the trace arrives at once (rate 1e6: every request
    is due at the second poll) to keep the schedule independent of them."""
    cfg, m, params, jm, jp = fp_setup
    tracer = Tracer()
    eng = ServeEngine(m, params, n_slots=2, max_len=64, clock=_ticker(),
                      tracer=tracer, **CPU)
    fast = dict(rate=1e6, shared_prefix_frac=0.0)
    tcfg = _tcfg(cfg)
    Scheduler(eng).run_traffic(make_trace(
        TrafficConfig(**{**tcfg.workload(), **fast})))
    from repro.obs import Tracer as JTracer
    jtracer = JTracer()
    jeng = JServeEngine(jm, jp, n_slots=2, max_len=64, clock=_ticker(),
                        tracer=jtracer)
    JScheduler(jeng).run_traffic(j_make_trace(
        JTrafficConfig(**{**tcfg.workload(), **fast})))
    ours, theirs = tracer.events(), jtracer.events()
    assert check_span_nesting(ours) == [] == check_span_nesting(theirs)
    theirs = [e for e in theirs if e.get("cat") != "jit"]
    assert _shape(ours) == json.loads(json.dumps(_shape(theirs)))
    meta = [e for e in tracer.to_json()["traceEvents"] if e["ph"] == "M"]
    jmeta = [e for e in jtracer.to_json()["traceEvents"] if e["ph"] == "M"]
    assert meta == jmeta


def test_spans_nest_across_preempt_resume(fp_setup):
    """A forced preemption closes the decode span and the resume opens a
    fresh queue/prefill/decode triple; all spans stay balanced."""
    cfg, m, params = fp_setup[:3]
    tracer = Tracer()
    faults = FaultInjector(FaultConfig(preempt_at=(3,)))
    eng = ServeEngine(m, params, n_slots=2, max_len=64, clock=_ticker(),
                      tracer=tracer, faults=faults, **CPU)
    reqs = [Request(rid=i, prompt=np.arange(1, 8, dtype=np.int32),
                    max_new_tokens=6) for i in range(3)]
    eng.serve(reqs)
    assert eng.metrics()["preempted"] >= 1
    events = tracer.events()
    assert check_span_nesting(events) == []
    names = [e["name"] for e in events]
    assert "preempt" in names
    pre = [e for e in events if e["name"] == "preempt"][0]
    rid = pre["tid"]
    row = [e for e in events if e.get("tid") == rid]
    assert sum(1 for e in row if e["name"] == "queue") == 2
    outcomes = [e.get("args", {}).get("outcome")
                for e in row if e["name"] == "decode"]
    assert "preempt" in outcomes


def test_spans_cover_chunked_prefill(fp_setup):
    cfg, m, params = fp_setup[:3]
    tracer = Tracer()
    eng = ServeEngine(m, params, n_slots=2, max_len=64, clock=_ticker(),
                      tracer=tracer, prefill_chunk=8, **CPU)
    long_prompt = (np.arange(40) % cfg.vocab_size + 1).astype(np.int32)
    eng.serve([Request(rid=0, prompt=long_prompt, max_new_tokens=4)])
    assert eng.metrics()["chunked_admissions"] == 1
    events = tracer.events()
    assert check_span_nesting(events) == []
    names = [e["name"] for e in events]
    assert "chunked_admit" in names and "fill_done" in names
    fill_done = [e for e in events if e["name"] == "fill_done"][0]
    prefill = [e for e in events if e["name"] == "prefill"][0]
    assert prefill["ts"] + prefill["dur"] >= fill_done["ts"]


def test_trace_ring_bounded_under_storm(fp_setup):
    cfg, m, params = fp_setup[:3]
    eng, tracer = _traced_run(cfg, m, params, capacity=64)
    assert len(tracer.events()) <= 64
    assert tracer.dropped > 0
    obj = tracer.to_json()
    assert validate_trace(obj) == []
    assert obj["otherData"]["dropped"] == tracer.dropped
    assert check_span_nesting(tracer.events()) == []


def test_step_spans_and_histogram(fp_setup):
    cfg, m, params = fp_setup[:3]
    tracer = Tracer()
    eng = ServeEngine(m, params, n_slots=2, max_len=64, clock=_ticker(),
                      tracer=tracer, **CPU)
    eng.serve([Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=4)])
    phases = {e["name"] for e in tracer.events() if e.get("cat") == "step"}
    assert {"admit", "decode_step", "sampler_sync"} <= phases
    snap = eng.registry.snapshot()
    assert snap["serve.step_ms{phase=decode_step}"]["count"] \
        == eng.metrics()["decode_steps"]


def test_untraced_engine_has_no_trace_key(fp_setup, tmp_path):
    cfg, m, params = fp_setup[:3]
    eng = ServeEngine(m, params, n_slots=1, max_len=64, **CPU)
    eng.serve([Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                       max_new_tokens=2)])
    assert "trace" not in eng.metrics()
    with pytest.raises(ValueError):
        eng.export_trace(tmp_path / "never-written.json")


def test_no_compile_events_and_empty_retrace_by_entry(fp_setup):
    """The counterpart of the reference's compile-event test: eager
    PyTorch compiles nothing, so no jit events are traced, no
    ``serve.jit_traces`` counter exists, and the JIT keys read zero."""
    cfg, m, params = fp_setup[:3]
    tracer = Tracer()
    eng = ServeEngine(m, params, n_slots=2, max_len=64, clock=_ticker(),
                      tracer=tracer, **CPU)
    eng.serve([Request(rid=i, prompt=np.arange(1, 6 + i, dtype=np.int32),
                       max_new_tokens=3) for i in range(2)])
    assert not [e for e in tracer.events() if e.get("cat") == "jit"]
    assert not [k for k in eng.registry.snapshot() if "jit" in k]
    mm = eng.metrics()
    assert mm["retrace_count"] == 0 and mm["retrace_by_entry"] == {}
    assert mm["prefill_traces"] == mm["decode_traces"] == 0
    assert mm["prefill_calls"] == mm["prefill_batches"] == 1


def test_launch_serve_cli_trace_and_validator(tmp_path, capsys):
    """The CLI's overload, fault and trace flags on the CPU, and the
    exported trace through ``python -m repro_torch.obs``."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs.__main__ import main as obs_main
    path = tmp_path / "trace.json"
    results = launch_serve.main([
        "--tiny", "--device", "cpu", "--requests", "3", "--new-tokens", "4",
        "--calib-n", "2", "--calib-len", "16", "--paged", "--deadline-s",
        "60", "--fault-alloc-at", "0,3", "--fault-preempt-at", "4",
        "--trace-out", str(path), "--profile-dir", str(tmp_path / "prof")])
    assert all(len(v) == 4 for v in results.values())
    out = capsys.readouterr().out
    assert "'alloc_failures': 2" in out and "'forced_preempts': 1" in out
    assert (tmp_path / "prof" / "trace.json").exists()
    assert obs_main([str(path)]) == 0
    assert "OK: schema valid, spans balanced" in capsys.readouterr().out
    assert obs_main([]) == 2
