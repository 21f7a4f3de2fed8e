"""Serve-side observability glue, the port of ``repro/serve/instrument.py``.

The engine's serve loop stays thin; everything it does to *observe
itself* lives here as free functions over the engine + request state,
the same pattern as :mod:`.overload`:

* **request lifecycle** — :func:`enqueued` / :func:`bound` /
  :func:`first_token` / :func:`retired` (+ :func:`preempted` /
  :func:`shed` / :func:`settled`) stamp the request's phase-boundary
  times and emit its swimlane spans: ``queue`` (enqueue → slot bind),
  ``prefill`` (bind → first emitted token, covering chunked
  teacher-forcing), ``decode`` (first token → retire/preempt).  A
  preemption closes the decode span and restarts the clock, so a
  twice-preempted request renders as three queue/prefill/decode
  triples on one row.
* **engine step loop** — :func:`step_span` wraps one admit pass,
  decode step, spec cycle, or sampler sync as an engine-track span and
  feeds the phase-labeled ``serve.step_ms`` histogram; with
  ``ServeEngine(profile=True)`` the same step also runs inside a named
  ``torch.profiler`` region (:func:`repro_torch.obs.annotation`).
* **pages** — :func:`page_event` marks alloc / copy-on-write / trim /
  pressure instants with a pages-in-use counter track.
* **metrics digest** — :func:`collect_metrics` is the body of
  ``ServeEngine.metrics()``: the reference's key set, assembled from the
  registry-backed groups.  Its JIT keys (``prefill_traces``,
  ``decode_traces``, ``retrace_count``, ``retrace_by_entry``) read zero
  and empty: eager PyTorch traces and compiles nothing.

Every timestamp is read through ``eng.clock`` — the injectable seam —
and nothing here touches a device tensor: tracing adds no host transfer
and no device synchronisation to the serve path.  With ``eng.tracer is
None`` (and ``profile`` off) every hook is a cheap early return.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

from repro_torch.obs import PID_REQUESTS, annotation


# ---------------------------------------------------------------------------
# Request lifecycle
# ---------------------------------------------------------------------------

def enqueued(eng, req):
    """Request entered the engine's queue (directly or via the arrival
    feed): open its swimlane and stamp the queue-span start."""
    tr = eng.tracer
    if tr is None:
        return
    req.t_enqueue = req.arrival if req.arrival is not None else eng.clock()
    tr.thread_name(PID_REQUESTS, req.rid, f"req {req.rid}")
    tr.instant("arrival", pid=PID_REQUESTS, tid=req.rid, cat="lifecycle",
               args=dict(tenant=req.tenant, resume=bool(req.resume)))


def bound(eng, req, s: int):
    """Slot granted: close the queue span, start the prefill phase."""
    tr = eng.tracer
    if tr is None:
        return
    now = eng.clock()
    if req.t_enqueue is not None:
        tr.complete("queue", req.t_enqueue, now, pid=PID_REQUESTS,
                    tid=req.rid, cat="lifecycle",
                    args=dict(slot=s, resume=bool(req.resume)))
    req.t_bind, req.t_first = now, None


def first_token(eng, req):
    """First emitted token: close the prefill span (for chunked or
    prefix-hit admissions this includes the teacher-forced fill steps —
    the whole time the request occupied a slot without emitting)."""
    req.t_first = eng.clock()
    tr = eng.tracer
    if tr is not None and req.t_bind is not None:
        tr.complete("prefill", req.t_bind, req.t_first, pid=PID_REQUESTS,
                    tid=req.rid, cat="lifecycle")


def fill_done(eng, req):
    """A chunked / prefix-hit admission finished teacher-forcing its
    prompt tail (the next sampled token is real output)."""
    tr = eng.tracer
    if tr is not None:
        tr.instant("fill_done", pid=PID_REQUESTS, tid=req.rid,
                   cat="lifecycle")


def retired(eng, req, outcome: str):
    """Terminal outcome from a slot: close the decode span."""
    tr = eng.tracer
    if tr is None:
        return
    now = eng.clock()
    start = req.t_first if req.t_first is not None else req.t_bind
    if start is not None:
        tr.complete("decode", start, now, pid=PID_REQUESTS, tid=req.rid,
                    cat="lifecycle",
                    args=dict(outcome=outcome,
                              tokens=len(req.out_tokens or [])))
    tr.instant("retire", pid=PID_REQUESTS, tid=req.rid, cat="lifecycle",
               args=dict(outcome=outcome))


def preempted(eng, req, s: int):
    """Evicted mid-flight: close the decode span as a preemption and
    restart the request's queue clock — the resume renders as a fresh
    queue/prefill/decode triple on the same row."""
    tr = eng.tracer
    if tr is None:
        return
    now = eng.clock()
    start = req.t_first if req.t_first is not None else req.t_bind
    if start is not None:
        tr.complete("decode", start, now, pid=PID_REQUESTS, tid=req.rid,
                    cat="lifecycle",
                    args=dict(outcome="preempt",
                              tokens=len(req.out_tokens or [])))
    tr.instant("preempt", pid=PID_REQUESTS, tid=req.rid, cat="lifecycle",
               args=dict(slot=s))
    req.t_enqueue, req.t_bind, req.t_first = now, None, None


def shed(eng, req, retried: bool):
    """Admission-time shed (terminal or retried), tenant-labeled."""
    eng.registry.counter("serve.shed_by_tenant", tenant=req.tenant).inc()
    tr = eng.tracer
    if tr is not None:
        tr.instant("shed_retry" if retried else "shed", pid=PID_REQUESTS,
                   tid=req.rid, cat="lifecycle",
                   args=dict(tenant=req.tenant, retries=req.retries))


def settled(eng, req, outcome: str):
    """Terminal outcome without ever taking a slot (expiry at
    admission, zero-budget completion)."""
    tr = eng.tracer
    if tr is not None:
        tr.instant("settle", pid=PID_REQUESTS, tid=req.rid,
                   cat="lifecycle", args=dict(outcome=outcome))


# ---------------------------------------------------------------------------
# Engine step loop
# ---------------------------------------------------------------------------

@contextmanager
def step_span(eng, phase: str, **args):
    """Engine-track span around one step-loop phase (admit pass, decode
    step, spec cycle, sampler sync); the duration also lands in the
    phase-labeled ``serve.step_ms`` histogram.  With ``profile=True`` the
    phase runs inside a ``torch.profiler`` region of the same name.  A
    no-op (two attribute checks) when the engine has neither."""
    tr = eng.tracer
    if tr is None and not eng._profile:
        yield args
        return
    with annotation(phase) if eng._profile else nullcontext():
        if tr is None:
            yield args
            return
        t0 = eng.clock()
        try:
            yield args
        finally:
            t1 = eng.clock()
            tr.complete(phase, t0, t1, cat="step", args=args or None)
            eng.registry.histogram("serve.step_ms",
                                   phase=phase).observe((t1 - t0) * 1e3)


def page_event(eng, kind: str, **args):
    """Page-machinery instant (alloc / cow / trim / pressure) plus a
    pages-in-use counter sample for the Perfetto counter track."""
    tr = eng.tracer
    if tr is None:
        return
    tr.instant(kind, cat="pages", args=args or None)
    if eng.paged:
        tr.counter("pages_in_use",
                   {"pages": eng.pool.pages_in_use()})


def export_trace(eng, path) -> str:
    """Write the engine's trace as Chrome/Perfetto trace_event JSON."""
    if eng.tracer is None:
        raise ValueError("engine was built without a tracer — pass "
                         "tracer=repro_torch.obs.Tracer() to ServeEngine")
    return eng.tracer.export(path)


# ---------------------------------------------------------------------------
# Metrics digest (the body of ServeEngine.metrics())
# ---------------------------------------------------------------------------

def collect_metrics(eng) -> dict:
    """Assemble the engine's metrics from the registry-backed groups, with
    the reference's key set (``tests/test_obs.py``'s frozen keys)."""
    m = dict(eng._m)
    m["prefill_calls"] = eng._stepper.prefill_calls
    # eager PyTorch: no jit entry points, so nothing traces or retraces
    m["prefill_traces"] = 0
    m["prefill_traces_single"] = 0
    m["decode_traces"] = 0
    m["retrace_count"] = 0
    m["retrace_by_entry"] = {}
    m["paged"] = eng.paged
    m["mesh"] = dict(eng.mesh.shape) if eng.mesh is not None else None
    m["prefill_chunk"] = eng.prefill_chunk or 0
    if eng.paged:
        pool = eng.pool
        m["page_size"] = eng.page_size
        m["pages_total"] = eng.n_pages - 1       # minus the trash page
        m["pages_in_use"] = pool.pages_in_use()
        m["pages_peak"] = pool.in_use_peak
        m["page_bytes"] = eng.page_bytes()
        # peak_cache_bytes counts *pinned* pages (what a deployment would
        # size n_pages from); alloc_cache_bytes is the whole store
        m["peak_cache_bytes"] = pool.in_use_peak * eng.page_bytes()
        m["alloc_cache_bytes"] = sum(leaf.numel() * leaf.element_size()
                                     for leaf in eng._store.values())
        m["page_allocs"] = pool.alloc_count
        m["cow_copies"] = pool.cow_copies
        m["page_evictions"] = pool.evictions
        m["prefix_index_blocks"] = len(pool.index)
        m["prefix_lookups"] = pool.prefix_lookups
        m["prefix_block_hits"] = pool.prefix_block_hits
    m["buckets"] = list(eng.buckets)
    m["faults"] = (eng.faults.metrics()
                   if eng.faults is not None else None)
    m["spec"] = eng._spec is not None
    if eng._spec is not None:
        m.update(eng._spec.metrics())
        m["accept_rate"] = (m["accepted_tokens"]
                            / max(m["proposed_tokens"], 1))
        # share of emitted tokens the draft proposed (the rest are first
        # tokens and verify corrections or bonuses); counts the emitted
        # ones, since a burst cut by a budget accepts more than it emits
        m["draft_share"] = (m["emitted_draft_tokens"]
                            / max(m["tokens_generated"], 1))
    m["tokens_per_step"] = (m["tokens_generated"]
                            / max(m["decode_steps"], 1))
    dt = m["serve_time_s"]
    m["tokens_per_s"] = (m["tokens_generated"] / dt) if dt > 0 else 0.0
    if eng.tracer is not None:
        m["trace"] = dict(events=len(eng.tracer.events()),
                          dropped=eng.tracer.dropped,
                          capacity=eng.tracer.capacity)
    return m
