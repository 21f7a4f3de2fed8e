"""Admission scheduling in front of :class:`~repro_torch.serve.engine.ServeEngine`.

The port of ``repro/serve/scheduler.py``.

The engine drains a FIFO of requests; the scheduler decides the FIFO.
It keeps an earliest-deadline-first priority queue (requests without a
deadline sort last, FIFO among themselves), attaches per-request
streaming callbacks, and exposes the engine's metrics snapshot.

Deadline semantics (enforced by the engine, ordered by the scheduler):

* a request whose deadline has already passed when it would be admitted
  **expires** — empty output, counted in ``metrics()["expired"]``;
* a running request whose deadline passes mid-decode is **truncated** at
  the tokens produced so far (``metrics()["truncated"]``).
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional

import numpy as np

from .engine import Request, ServeEngine
from .loadgen import ArrivalFeed, summarize


class RunResult(dict):
    """``{rid: tokens}`` mapping plus a ``summary`` attribute.

    ``summary`` carries the run-level digest — completion/expiry/
    truncation counts, throughput, and (when the engine runs
    speculatively) ``accept_rate``/``tokens_per_step``/``draft_share``
    plus per-request ``tokens_per_step`` — so callers don't have to
    reach into engine-level counters.  The summary is computed as a
    delta over the engine's metrics registry; the raw
    qualified-name delta rides along as ``registry_delta``.  Traffic
    runs (:meth:`Scheduler.run_traffic`) additionally attach
    ``records`` — per-request arrival/admit/first-token/finish
    timestamps — and a ``traffic`` percentile report.
    """
    summary: dict = {}
    records: dict = {}
    traffic: dict = {}
    registry_delta: dict = {}


class Scheduler:
    """EDF admission queue over a ServeEngine."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self._heap: list = []
        self._seq = itertools.count()
        self._queued_rids: set = set()
        self.last_summary: dict = {}

    @property
    def clock(self):
        """The engine's injectable deadline clock (one seam end-to-end:
        deadlines, traffic timestamps, and serve timing all read it)."""
        return self.engine.clock

    def submit(self, request: Request, *,
               deadline: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               on_finish: Optional[Callable[[int, np.ndarray], None]] = None,
               ) -> int:
        """Queue a request; returns its rid.

        ``deadline`` is an absolute ``time.time()`` cutoff.  ``on_token``
        is called as ``on_token(rid, token)`` for every generated token
        (streaming); ``on_finish(rid, tokens)`` once on completion,
        expiry, truncation, or shed.

        Duplicate rids are rejected: results are keyed by rid, so a
        double-queued id would silently drop one request's output.

        With an SLO-enabled engine the EDF key gains a secondary
        weighted-fairness component (per-tenant virtual time): at equal
        deadlines a heavy tenant's backlog sorts behind a light
        tenant's submissions."""
        if request.rid in self._queued_rids:
            raise ValueError(
                f"rid {request.rid} is already queued — results are "
                "keyed by rid, so reuse would drop one request's output")
        if deadline is not None:
            request.deadline = deadline
        if on_token is not None:
            request.on_token = on_token
        if on_finish is not None:
            request.on_finish = on_finish
        key = request.deadline if request.deadline is not None else float("inf")
        fair = (self.engine.slo.fair_key(request)
                if self.engine.slo is not None else 0.0)
        heapq.heappush(self._heap, (key, fair, next(self._seq), request))
        self._queued_rids.add(request.rid)
        return request.rid

    def pending(self) -> int:
        return len(self._heap)

    def run(self) -> RunResult:
        """Drain the queue through the engine in EDF order.

        Returns a :class:`RunResult`: ``{rid: np.ndarray of generated
        tokens}`` whose ``summary`` attribute digests the run — overall
        and per-request ``tokens_per_step`` and, for speculative
        engines, ``accept_rate``/``draft_share`` — instead of leaving
        those buried in engine-level counters."""
        reqs = [heapq.heappop(self._heap)[-1] for _ in range(len(self._heap))]
        self._queued_rids.clear()
        snap0 = self.engine.registry.snapshot()
        out = RunResult()
        if reqs:
            out.update(self.engine.serve(reqs))
        m = self.engine.metrics()
        # engine counters are engine-lifetime cumulative; the summary
        # digests *this* run, so report one registry delta against the
        # pre-run snapshot (a reused Scheduler must not re-report
        # earlier runs)
        delta = self.engine.registry.delta(snap0)
        out.registry_delta = delta
        d = lambda key: delta.get("serve." + key, 0)
        rids = {r.rid for r in reqs}
        per_req = {rid: tps
                   for rid, tps in self.engine.request_summary().items()
                   if rid in rids}
        tokens, steps = d("tokens_generated"), d("decode_steps")
        dt = d("serve_time_s")
        out.summary = {
            "requests": len(reqs),
            "completed": d("completed"),
            "expired": d("expired"),
            "truncated": d("truncated"),
            "shed": d("shed"),
            "preempted": d("preempted"),
            "resumed": d("resumed"),
            "tokens_generated": tokens,
            "tokens_per_s": (tokens / dt) if dt > 0 else 0.0,
            "tokens_per_step": tokens / max(steps, 1),
            "tokens_per_step_by_request": per_req,
            "spec": m["spec"],
        }
        if m["spec"]:
            ds = lambda key: delta.get("spec." + key, 0)
            out.summary.update(
                accept_rate=(ds("accepted_tokens")
                             / max(ds("proposed_tokens"), 1)),
                draft_share=(ds("emitted_draft_tokens") / max(tokens, 1)),
                spec_cycles=ds("spec_cycles"),
                spec_k=m["spec_k"],
                draft_kind=m["draft_kind"])
        self.last_summary = out.summary
        return out

    def run_traffic(self, trace) -> RunResult:
        """Drive the engine with an open-loop arrival trace
        (``[(arrival_offset_s, Request)]``, e.g. from
        :func:`.loadgen.make_trace`).

        Unlike :meth:`run`, requests are *not* all admitted up front:
        an :class:`.loadgen.ArrivalFeed` releases each one as its
        arrival time passes on the engine clock, so queueing is real.
        Per-request arrival / admission / first-token / finish
        timestamps are recorded and digested into p50/p95/p99 TTFT,
        queue-delay, and per-token-latency percentiles
        (``result.traffic``, raw records on ``result.records``)."""
        clock = self.engine.clock
        records: dict = {}
        items = sorted(trace, key=lambda it: it[0])
        for offset, req in items:
            rec = records[req.rid] = dict(
                scheduled=float(offset), arrival=None, admit=None,
                first=None, end=None, tokens=0, outcome=None,
                retries=0, preempts=0)
            prev_admit = req.on_admit
            prev_token = req.on_token
            prev_finish = req.on_finish

            def on_admit(rid, _rec=rec, _p=prev_admit):
                # first admit only: a preempted-and-resumed request's
                # queue delay is measured to its original slot grant
                if _rec["admit"] is None:
                    _rec["admit"] = clock()
                if _p:
                    _p(rid)

            def on_token(rid, tok, _rec=rec, _p=prev_token):
                if _rec["first"] is None:
                    _rec["first"] = clock()
                _rec["tokens"] += 1
                if _p:
                    _p(rid, tok)

            def on_finish(rid, out, _rec=rec, _req=req, _p=prev_finish):
                _rec["end"] = clock()
                _rec["outcome"] = _req.outcome
                _rec["retries"] = _req.retries
                _rec["preempts"] = _req.preempts
                _rec["tokens"] = len(out)
                if _p:
                    _p(rid, out)

            req.on_admit = on_admit
            req.on_token = on_token
            req.on_finish = on_finish
        # the arrival timestamp is the FIRST release — a shed-retried
        # request re-enters the feed but its latency still counts from
        # the original arrival (the client has been waiting since then)
        feed = ArrivalFeed(
            items,
            record=lambda rid, t: (
                records[rid].__setitem__("arrival", t)
                if records[rid]["arrival"] is None else None))
        # closed-loop retry seam: a shed request re-arrives after the
        # engine's jittered retry-after, through the same feed
        for _, req in items:
            if req.on_shed is None:
                req.on_shed = (lambda r, after, _f=feed, _c=clock:
                               _f.push(_c() + after, r))
        snap0 = self.engine.registry.snapshot()
        out = RunResult()
        out.update(self.engine.serve((), feed=feed))
        m = self.engine.metrics()
        delta = self.engine.registry.delta(snap0)
        out.registry_delta = delta
        d = lambda key: delta.get("serve." + key, 0)
        tokens, steps = d("tokens_generated"), d("decode_steps")
        dt = d("serve_time_s")
        out.summary = {
            "requests": len(items),
            "completed": d("completed"),
            "expired": d("expired"),
            "truncated": d("truncated"),
            "shed": d("shed"),
            "shed_retried": d("shed_retried"),
            "preempted": d("preempted"),
            "resumed": d("resumed"),
            "pressure_events": d("pressure_events"),
            "tokens_generated": tokens,
            "tokens_per_s": (tokens / dt) if dt > 0 else 0.0,
            "tokens_per_step": tokens / max(steps, 1),
            "spec": m["spec"],
        }
        out.records = records
        out.traffic = summarize(records)
        self.last_summary = out.summary
        return out

    def metrics(self) -> dict:
        return self.engine.metrics()
