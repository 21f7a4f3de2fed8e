"""Open-loop load generation + latency-percentile reporting.

The port of ``repro/serve/loadgen.py``: the same numpy draws in the same
order, so a :class:`TrafficConfig` gives the reference's trace.

Closed-loop benchmarks (hand the engine N requests, divide by wall
time) hide exactly the failure modes production serving cares about:
queueing behind a long prefill, burst absorption, tail latency.  This
module generates *open-loop* traffic — arrivals follow a seeded random
process and do not wait for the engine — and reports the distribution
tails:

* :class:`TrafficConfig` + :func:`make_trace` — a reproducible trace of
  ``(arrival_offset_s, Request)`` pairs: Poisson or bursty arrivals,
  log-normal long-tail prompt lengths, and a shared-prefix mixture (a
  fraction of requests reuse one of ``n_prefixes`` common prefixes, the
  workload the paged prefix index monetizes).
* :class:`ArrivalFeed` — the open-loop valve: the engine's serve loop
  polls it with the engine clock and receives the requests whose
  arrival time has passed (same-time arrivals are released EDF-ordered).
* :func:`summarize` — p50/p95/p99 TTFT (arrival to first token),
  queue delay (arrival to slot admission), and per-token decode latency
  from the per-request timestamp records that
  :meth:`.scheduler.Scheduler.run_traffic` collects.

Everything is driven by the engine's injectable ``clock`` — tests run
traffic against a fake clock without monkeypatching.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.obs import Histogram, dist_ms
from .slots import Request


@dataclasses.dataclass
class TrafficConfig:
    """Seeded open-loop workload description."""
    n_requests: int = 100
    process: str = "poisson"       # "poisson" | "bursty"
    rate: float = 16.0             # mean arrivals per second
    burst_size: int = 8            # bursty: simultaneous arrivals per burst
    prompt_len_median: int = 12    # log-normal long-tail prompt lengths
    prompt_len_sigma: float = 0.6
    prompt_len_max: int = 48
    shared_prefix_frac: float = 0.5   # fraction reusing a common prefix
    n_prefixes: int = 4
    prefix_len: int = 16
    max_new_tokens: int = 8
    vocab_size: int = 256
    deadline_s: Optional[float] = None   # per-request SLO, relative to arrival
    seed: int = 0

    def workload(self) -> dict:
        """JSON-serializable record of the generated workload (to print
        or store next to the percentiles it produced)."""
        return dataclasses.asdict(self)


def _arrival_offsets(cfg: TrafficConfig, rng) -> np.ndarray:
    if cfg.process == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate, cfg.n_requests)
        times = np.cumsum(gaps)
    elif cfg.process == "bursty":
        # bursts of burst_size simultaneous arrivals; burst inter-arrival
        # keeps the same long-run rate as the Poisson process
        n_bursts = -(-cfg.n_requests // cfg.burst_size)
        gaps = rng.exponential(cfg.burst_size / cfg.rate, n_bursts)
        burst_t = np.cumsum(gaps)
        times = np.repeat(burst_t, cfg.burst_size)[:cfg.n_requests]
    else:
        raise ValueError(f"unknown arrival process: {cfg.process!r}")
    return times - times[0]        # first request arrives at t=0


def make_trace(cfg: TrafficConfig,
               rid_base: int = 0) -> List[Tuple[float, Request]]:
    """Generate the seeded trace: ``[(arrival_offset_s, Request)]``,
    sorted by arrival offset."""
    rng = np.random.default_rng(cfg.seed)
    times = _arrival_offsets(cfg, rng)
    prefixes = [rng.integers(1, cfg.vocab_size, cfg.prefix_len)
                .astype(np.int32) for _ in range(cfg.n_prefixes)]
    trace = []
    for i in range(cfg.n_requests):
        n = int(round(cfg.prompt_len_median
                      * math.exp(cfg.prompt_len_sigma
                                 * rng.standard_normal())))
        shared = (cfg.shared_prefix_frac > 0
                  and rng.random() < cfg.shared_prefix_frac)
        if shared:
            tail_n = max(1, min(n, cfg.prompt_len_max - cfg.prefix_len))
            pre = prefixes[int(rng.integers(cfg.n_prefixes))]
            tail = rng.integers(1, cfg.vocab_size, tail_n).astype(np.int32)
            prompt = np.concatenate([pre, tail])
        else:
            n = max(1, min(n, cfg.prompt_len_max))
            prompt = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        trace.append((float(times[i]),
                      Request(rid=rid_base + i, prompt=prompt,
                              max_new_tokens=cfg.max_new_tokens,
                              rel_deadline=cfg.deadline_s)))
    return trace


class ArrivalFeed:
    """Open-loop arrival valve for ``ServeEngine.serve(feed=...)``.

    The first ``poll(now)`` anchors the trace's t=0 at ``now``; each
    later poll releases every request whose absolute arrival time has
    passed (simultaneous arrivals EDF-ordered).  ``record`` (if given)
    is called with ``(rid, absolute_arrival_time)`` as each request is
    released — the arrival timestamp latency percentiles measure from.
    """

    def __init__(self, trace: List[Tuple[float, Request]],
                 record: Optional[Callable[[int, float], None]] = None):
        self._items = sorted(trace, key=lambda it: it[0])
        self._i = 0
        self.t0: Optional[float] = None
        self.record = record

    def poll(self, now: float) -> List[Request]:
        if self.t0 is None:
            self.t0 = now
        out = []
        while (self._i < len(self._items)
               and self.t0 + self._items[self._i][0] <= now):
            offset, req = self._items[self._i]
            self._i += 1
            t_arr = self.t0 + offset
            if req.arrival is None:
                # first release stamps arrival and resolves a relative
                # SLO into an absolute deadline; a shed-retried
                # re-release keeps both (the client has been waiting
                # since the original arrival)
                req.arrival = t_arr
                if req.rel_deadline is not None and req.deadline is None:
                    req.deadline = t_arr + req.rel_deadline
            if self.record is not None:
                self.record(req.rid, t_arr)
            out.append(req)
        # same-poll arrivals honor EDF ordering before hitting the FIFO
        out.sort(key=lambda r: (r.deadline if r.deadline is not None
                                else float("inf")))
        return out

    def push(self, t_abs: float, req: Request):
        """Re-schedule a request (shed retry-after): it re-enters the
        open loop at absolute time ``t_abs`` through the same valve —
        inserted past the cursor so the remaining tail stays sorted."""
        off = t_abs - self.t0 if self.t0 is not None else t_abs
        keys = [it[0] for it in self._items[self._i:]]
        j = self._i + bisect.bisect_right(keys, off)
        self._items.insert(j, (off, req))

    def pending(self) -> bool:
        return self._i < len(self._items)

    def next_time(self) -> Optional[float]:
        if self.t0 is None or not self.pending():
            return None
        return self.t0 + self._items[self._i][0]


def summarize(records: dict) -> dict:
    """Latency percentiles from per-request timestamp records
    (``{rid: {arrival, admit, first, end, tokens}}`` — absolute engine
    clock, as collected by :meth:`.scheduler.Scheduler.run_traffic`).

    * ``ttft_ms`` — arrival to first emitted token,
    * ``queue_delay_ms`` — arrival to slot admission (the open-loop
      queueing cost: prefill time is excluded),
    * ``per_token_ms`` — steady decode latency, (end - first) over the
      tokens after the first.

    Every percentile is zero (never NaN) on empty samples — the
    hardening lives in :func:`repro_torch.obs.never_nan_percentile` — so a fully shed overload run still
    produces a valid report.  ``outcomes`` tallies per-request terminal
    states (completed / expired / truncated / shed) plus shed-retry and
    preemption totals when the records carry them.  ``hists`` carries
    the same three distributions as fixed-bucket
    :class:`repro_torch.obs.Histogram` snapshots (mergeable across runs,
    unlike percentiles).
    """
    recs = list(records.values())
    done = [r for r in recs if r.get("end") is not None]
    ttft = [r["first"] - r["arrival"] for r in recs
            if r.get("first") is not None and r.get("arrival") is not None]
    queue_delay = [r["admit"] - r["arrival"] for r in recs
                   if r.get("admit") is not None
                   and r.get("arrival") is not None]
    per_token = [(r["end"] - r["first"]) / (r["tokens"] - 1) for r in done
                 if r.get("first") is not None and r.get("tokens", 0) > 1]
    tokens = sum(r.get("tokens", 0) for r in recs)
    ends = [r["end"] for r in done]
    starts = [r["arrival"] for r in recs if r.get("arrival") is not None]
    duration = (max(ends) - min(starts)) if ends and starts else 0.0
    outcomes: dict = {}
    for r in recs:
        o = r.get("outcome")
        if o is not None:
            outcomes[o] = outcomes.get(o, 0) + 1
    # survivors = requests that produced their full output despite the
    # overload; their tail TTFT is the headline SLO number
    surv_ttft = [r["first"] - r["arrival"] for r in recs
                 if r.get("outcome") == "completed"
                 and r.get("first") is not None
                 and r.get("arrival") is not None]
    return {
        "submitted": len(recs),
        "completed": len(done),
        "tokens": tokens,
        "duration_s": duration,
        "tokens_per_s": (tokens / duration) if duration > 0 else 0.0,
        "ttft_ms": dist_ms(ttft),
        "queue_delay_ms": dist_ms(queue_delay),
        "per_token_ms": dist_ms(per_token),
        "outcomes": outcomes,
        "survivor_ttft_ms": dist_ms(surv_ttft),
        "retries": sum(r.get("retries", 0) for r in recs),
        "preempts": sum(r.get("preempts", 0) for r in recs),
        "hists": {
            name: Histogram.from_samples(1e3 * x for x in xs).snapshot()
            for name, xs in (("ttft_ms", ttft),
                             ("queue_delay_ms", queue_delay),
                             ("per_token_ms", per_token))},
    }
