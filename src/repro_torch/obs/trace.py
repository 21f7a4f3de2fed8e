"""Ring-buffered span tracer with a Chrome/Perfetto trace_event exporter.

The port's copy of ``repro/obs/trace.py`` (no JAX there; the port
imports nothing of ``repro``): same events, same export bytes.

The serving stack's timeline questions — "why did this request's TTFT
blow past p99", "what did the engine do during the overload storm" —
need per-request and per-step *events*, not counters.  :class:`Tracer`
collects them into a bounded ring (a deque with ``maxlen``; an
overload storm evicts the oldest events instead of growing without
bound, and ``dropped`` counts the evictions) and exports the
`trace_event <https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
JSON that ``chrome://tracing`` / `Perfetto <https://ui.perfetto.dev>`_
render.

Determinism rule: the tracer reads time **only**
through its ``clock`` attribute, which the engine re-points at its own
injectable ``clock=`` seam on attach — under a fake clock two
identical runs export byte-identical JSON (sorted keys, compact
separators, timestamps anchored to the earliest event).  Nothing here
ever touches device values, so tracing adds no host transfer and no
device synchronisation to the serve path.

Event vocabulary:

* ``X`` (complete) spans — emitted *at close* with ``ts`` + ``dur``,
  so a ring-evicted span never leaves an unbalanced ``B``/``E`` pair;
* ``i`` (instant) — lifecycle edges (arrival, shed, preempt, resume,
  retire) and page events (eager PyTorch compiles nothing, so the
  reference's compile/retrace marks never occur here);
* ``C`` (counter) — numeric tracks (pages in use, queue depth);
* ``M`` (metadata) — process/thread names, generated fresh at export
  time from the name table (never ring-evicted).

Track layout: ``pid 1`` is the engine (step loop, tid 0); ``pid 2``
is the request swimlane — one tid per rid, so every request renders as
its own row of queue/prefill/decode spans.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

PID_ENGINE = 1
PID_REQUESTS = 2

_PROCESS_NAMES = {PID_ENGINE: "engine", PID_REQUESTS: "requests"}


class Tracer:
    """Bounded trace-event collector over an injectable clock."""

    def __init__(self, clock=None, capacity: int = 8192):
        self.clock = clock if clock is not None else time.time
        self.capacity = int(capacity)
        self._events = deque(maxlen=self.capacity)
        self.dropped = 0
        self._threads = {}            # (pid, tid) -> display name

    # -- recording -----------------------------------------------------------
    def _emit(self, ev: dict):
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    @contextmanager
    def span(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
             cat: str = "serve", args: Optional[dict] = None):
        """Complete-span context manager; yields the args dict so the
        body can attach results (accepted depth, group size, ...)."""
        t0 = self.clock()
        a = dict(args) if args else {}
        try:
            yield a
        finally:
            self.complete(name, t0, self.clock(), pid=pid, tid=tid,
                          cat=cat, args=a)

    def complete(self, name: str, t_start: float, t_end: float, *,
                 pid: int = PID_ENGINE, tid: int = 0, cat: str = "serve",
                 args: Optional[dict] = None):
        """One ``X`` event from two explicit clock stamps (for spans
        whose start was recorded on a request object)."""
        ev = dict(ph="X", name=name, cat=cat, pid=pid, tid=tid,
                  ts=float(t_start),
                  dur=max(float(t_end) - float(t_start), 0.0))
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
                cat: str = "serve", args: Optional[dict] = None):
        ev = dict(ph="i", s="t", name=name, cat=cat, pid=pid, tid=tid,
                  ts=float(self.clock()))
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, values: dict, *, pid: int = PID_ENGINE,
                tid: int = 0):
        self._emit(dict(ph="C", name=name, cat="counter", pid=pid,
                        tid=tid, ts=float(self.clock()),
                        args=dict(values)))

    def thread_name(self, pid: int, tid: int, name: str):
        self._threads[(pid, tid)] = name

    def events(self) -> list:
        """Recorded events with timestamps anchored to the *earliest*
        surviving event and converted to microseconds.  Anchoring at
        read time (not at record time) keeps every ts non-negative even
        though span starts can predate the first recorded event — a
        queue span's start is the request's arrival stamp, which the
        open-loop feed may place before the engine's first step event."""
        evs = list(self._events)
        if not evs:
            return []
        t0 = min(ev["ts"] for ev in evs)
        out = []
        for ev in evs:
            e = dict(ev, ts=round((ev["ts"] - t0) * 1e6, 3))
            if "dur" in e:
                e["dur"] = round(e["dur"] * 1e6, 3)
            out.append(e)
        return out

    # -- export --------------------------------------------------------------
    def to_json(self) -> dict:
        """The full trace object.  Metadata events are generated here —
        never stored in the ring — so process/thread names survive any
        amount of eviction."""
        meta = [dict(ph="M", name="process_name", pid=pid, tid=0, ts=0,
                     args=dict(name=label))
                for pid, label in sorted(_PROCESS_NAMES.items())]
        meta += [dict(ph="M", name="thread_name", pid=pid, tid=tid, ts=0,
                      args=dict(name=label))
                 for (pid, tid), label in sorted(self._threads.items())]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"capacity": self.capacity,
                              "dropped": self.dropped,
                              "recorded": len(self._events)}}

    def export(self, path) -> str:
        """Write the trace as deterministic JSON (sorted keys, compact
        separators): identical event streams produce byte-identical
        files, which the fake-clock determinism test asserts."""
        with open(path, "w") as f:
            f.write(json.dumps(self.to_json(), sort_keys=True,
                               separators=(",", ":")))
            f.write("\n")
        return str(path)


# ---------------------------------------------------------------------------
# Validation (tests + the CI obs-smoke job)
# ---------------------------------------------------------------------------

_REQUIRED = {"ph", "name", "pid", "tid", "ts"}
_PHASES = {"X", "i", "C", "M"}


def validate_trace(obj) -> list:
    """Schema-check a trace object (or a path to one) against the
    trace_event contract this module emits; returns a list of problem
    strings (empty == valid)."""
    if isinstance(obj, (str, bytes)):
        with open(obj) as f:
            obj = json.load(f)
    problems = []
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        missing = _REQUIRED - set(ev)
        if missing:
            problems.append(f"{where}: missing {sorted(missing)}")
            continue
        if ev["ph"] not in _PHASES:
            problems.append(f"{where}: unknown ph {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            problems.append(f"{where}: bad ts {ev['ts']!r}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) \
                    or ev["dur"] < 0:
                problems.append(f"{where}: X span needs dur >= 0")
        if ev["ph"] == "i" and ev.get("s") not in ("t", "p", "g"):
            problems.append(f"{where}: instant needs scope s in t/p/g")
        if ev["ph"] == "M" and "name" not in ev.get("args", {}):
            problems.append(f"{where}: metadata needs args.name")
        if ev["ph"] == "C" and not isinstance(ev.get("args"), dict):
            problems.append(f"{where}: counter needs an args dict")
    return problems


def check_span_nesting(events) -> list:
    """Per-(pid, tid) properly-nested check over ``X`` spans: two spans
    on one track must either nest or be disjoint (a partial overlap
    means a span closed across another's boundary — unbalanced
    instrumentation).  Returns violation strings."""
    tracks = {}
    for ev in events:
        if ev.get("ph") == "X":
            tracks.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    problems = []
    # Export rounds ts and dur to 0.001 us *independently*, so a span
    # end reconstructed as ts + dur and the adjacent span's start —
    # three roundings of two raw stamps — can disagree by up to
    # ~0.002 us even when the raw stamps are identical.  Anything
    # under that quantum is "touching", not crossing.
    eps = 2e-3
    for key, spans in sorted(tracks.items()):
        spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []                      # open spans' (end, name)
        for ev in spans:
            t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
            while stack and stack[-1][0] <= t0 + eps:
                stack.pop()
            if stack and t1 > stack[-1][0] + eps:
                problems.append(
                    f"track {key}: span {ev['name']!r} "
                    f"[{t0}, {t1}] crosses enclosing "
                    f"{stack[-1][1]!r} ending at {stack[-1][0]}")
            stack.append((t1, ev["name"]))
    return problems
