"""Overload response: SLO-aware shedding, quotas, and slot preemption.

The port of ``repro/serve/overload.py``.  The engine's serve loop stays
thin; everything it does *under pressure* lives here as free functions
over the engine + run state:

* :class:`SLOAdmission` — the admission-time SLO gate.  It keeps a
  sliding window of observed queue delays (admit − arrival, the same
  quantity :func:`.loadgen.summarize` reports percentiles of), and
  sheds a request at the head of the queue when
  ``now + margin · delay_estimate > deadline`` — the request is doomed;
  rejecting it early returns its slot time to requests that can still
  make their SLO.  Shed requests get a seeded, jittered, exponential
  ``retry-after`` surfaced to closed-loop clients via ``on_shed``;
  after ``retry_max`` re-arrivals the shed is terminal.  It also owns
  per-tenant in-flight token quotas (acquired at bind, released at
  finish/preempt) and the weighted-fairness virtual time the scheduler
  uses as a secondary heap key.
* :func:`pick_victim` / :func:`preempt_slot` — the backpressure
  response.  The victim is the active slot with the *latest* deadline
  (no deadline = infinitely late), breaking ties toward the fewest
  emitted tokens (least recompute lost).  Preemption registers the
  victim's full KV blocks in the paged prefix index before releasing
  its page refs, re-queues the request with ``resume=True`` in
  deadline order, and the next admission rebuilds its state — paged
  resumes prefix-hit the just-registered pages; dense resumes recompute
  via prefill.  Greedy outputs are bit-identical either way because the
  recomputed KV is exactly the KV that was released.
* :func:`relieve_pressure` — the engine's ``PagePressure`` handler:
  preempt one victim and let the loop retry.  A sole active slot that
  can never fit another page (its own length exceeds the pool) is
  truncated instead of self-preempting forever.
* :func:`shed_request` / :func:`never_admissible` — terminal-shed
  bookkeeping and the provably-unadmittable check behind the loop's
  no-progress guard (a request larger than the whole pool or its
  tenant's whole quota can never bind; waiting will not help).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from . import instrument
from .slots import effective_prompt, empty_tokens


def request_tokens(req) -> int:
    """Admission cost of a request in cache positions: its (effective)
    prompt plus everything it may still generate — what a bound slot
    can end up holding.  Quotas and capacity checks both use it."""
    emitted = len(req.out_tokens or [])
    return len(req.prompt) + emitted + max(req.max_new_tokens - emitted, 0)


@dataclasses.dataclass
class SLOConfig:
    """SLO-aware admission policy knobs."""
    margin: float = 1.0            # shed when now + margin*est > deadline
    window: int = 64               # queue-delay observations kept
    pct: float = 90.0              # window percentile used as the estimate
    retry_base_s: float = 0.05     # jittered exponential retry-after base
    retry_max: int = 3             # re-arrivals before a shed is terminal
    quota_tokens: int = 0          # per-tenant in-flight tokens (0 = off)
    quotas: dict = dataclasses.field(default_factory=dict)   # per-tenant
    weights: dict = dataclasses.field(default_factory=dict)  # fairness
    seed: int = 0


class SLOAdmission:
    """Queue-delay estimator + shed gate + tenant quotas + fair vtime."""

    def __init__(self, cfg: Optional[SLOConfig] = None):
        self.cfg = cfg or SLOConfig()
        self._delays = deque(maxlen=self.cfg.window)
        self._inflight: dict = {}      # tenant -> bound tokens
        self._vtime: dict = {}         # tenant -> virtual time
        self._rng = np.random.default_rng(self.cfg.seed)
        self._reg = None               # set by bind_registry at engine attach
        self._hist = None
        self._est = None

    def bind_registry(self, registry):
        """Attach the engine's metrics registry: queue delays land in a
        ``slo.queue_delay_ms`` histogram and the current estimate in a
        gauge, alongside the engine's own groups."""
        self._reg = registry
        self._hist = registry.histogram("slo.queue_delay_ms")
        self._est = registry.gauge("slo.queue_delay_est_s")

    # -- queue-delay estimate -------------------------------------------------
    def observe(self, delay_s: float):
        self._delays.append(max(float(delay_s), 0.0))
        if self._hist is not None:
            self._hist.observe(max(float(delay_s), 0.0) * 1e3)
            self._est.set(self.estimate())

    def estimate(self) -> float:
        if not self._delays:
            return 0.0
        return float(np.percentile(np.asarray(self._delays, np.float64),
                                   self.cfg.pct))

    def should_shed(self, req, now: float) -> bool:
        if req.deadline is None:
            return False
        return now + self.cfg.margin * self.estimate() > req.deadline

    def retry_after(self, req) -> float:
        """Seeded jittered exponential backoff for this shed (retries
        was already incremented, so the first retry uses the base)."""
        back = self.cfg.retry_base_s * (2.0 ** max(req.retries - 1, 0))
        return back * (0.5 + float(self._rng.random()))

    # -- per-tenant quotas ----------------------------------------------------
    def quota_for(self, tenant: str) -> int:
        return int(self.cfg.quotas.get(tenant, self.cfg.quota_tokens))

    def quota_ok(self, req) -> bool:
        q = self.quota_for(req.tenant)
        if q <= 0:
            return True
        return self._inflight.get(req.tenant, 0) + request_tokens(req) <= q

    def acquire(self, req):
        self._inflight[req.tenant] = (self._inflight.get(req.tenant, 0)
                                      + request_tokens(req))
        self._track_inflight(req.tenant)

    def release(self, req):
        left = self._inflight.get(req.tenant, 0) - request_tokens(req)
        self._inflight[req.tenant] = max(left, 0)
        self._track_inflight(req.tenant)

    def _track_inflight(self, tenant: str):
        if self._reg is not None:
            self._reg.gauge("slo.inflight_tokens",
                            tenant=tenant).set(self._inflight[tenant])

    # -- weighted fairness ----------------------------------------------------
    def fair_key(self, req) -> float:
        """Start-time fair queuing: each submission advances its
        tenant's virtual time by cost/weight; the pre-advance value is
        the request's secondary sort key, so a heavy tenant's backlog
        sorts behind a light tenant's at equal deadlines."""
        w = float(self.cfg.weights.get(req.tenant, 1.0))
        v = self._vtime.get(req.tenant, 0.0)
        self._vtime[req.tenant] = v + request_tokens(req) / max(w, 1e-9)
        return v


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

def _deadline(req) -> float:
    return req.deadline if req.deadline is not None else float("inf")


def pick_victim(st, exclude: Optional[int] = None) -> Optional[int]:
    """Latest-deadline active slot, ties toward fewest emitted tokens
    (least recompute thrown away), then the highest slot index.

    ``exclude`` names the slot whose allocation raised the pressure:
    preempting the requester itself frees nothing for anyone else —
    the loop would re-admit it and hit the same wall (a livelock, not
    backpressure) — so it is only eligible when it is the sole active
    slot."""
    cands = [s for s in range(st.n) if st.active[s]]
    if exclude is not None and len(cands) > 1:
        cands = [s for s in cands if s != exclude]
    if not cands:
        return None
    return max(cands, key=lambda s: (_deadline(st.req[s]),
                                     -len(st.req[s].out_tokens or []), s))


def preempt_slot(eng, run, s: int):
    """Release slot ``s`` and re-queue its request for a later resume.

    The stepper hook runs *before* the slot clears: the paged stepper
    registers every full KV block (prompt and generated tokens alike)
    in the prefix index under the effective-sequence hash chain, so the
    resume's prefix-hit admission maps the same physical pages back and
    only recomputes the partial tail block.  The request re-enters the
    queue in deadline order with ``resume=True``; its ``out_tokens``
    survive and admission treats prompt+out as the prompt."""
    st = run.st
    req = st.req[s]
    eng._m["preempted"] += 1
    req.preempts += 1
    instrument.preempted(eng, req, s)
    if eng.slo is not None:
        eng.slo.release(req)
    eng._stepper.preempt(st, s)
    st.clear(s)
    req.resume = True
    dl = _deadline(req)
    pos = next((i for i, r in enumerate(run.queue) if _deadline(r) > dl),
               len(run.queue))
    run.queue.insert(pos, req)


def relieve_pressure(eng, run, pressure) -> bool:
    """Handle one :class:`.pages.PagePressure` from a step or an
    admission reservation: preempt the victim and let the loop retry.
    Returns False only when there is nothing to preempt (pressure during
    admission with no active slots — the retry itself is the response,
    the fault or transient that vetoed the allocation has passed)."""
    eng._m["pressure_events"] += 1
    st = run.st
    victim = pick_victim(st, exclude=pressure.slot)
    if victim is None:
        return False
    if pressure.slot == victim and sum(st.active) == 1 \
            and eng._stepper.slot_overflows(st, victim):
        # sole active slot and its own sequence can no longer fit: a
        # self-preempt would resume into the same wall forever — cut it
        # at the tokens produced so far instead
        eng._finish(run, victim, counter="truncated")
        return True
    preempt_slot(eng, run, victim)
    return True


# ---------------------------------------------------------------------------
# Shedding
# ---------------------------------------------------------------------------

def shed_request(eng, req, results, terminal: bool = False) -> None:
    """Shed at admission time.  With retry budget left and an
    ``on_shed`` hook (the closed-loop client seam), the request is
    handed back with a jittered retry-after and re-enters through the
    arrival feed; otherwise — or when ``terminal`` says retrying can
    never help (the no-progress guard) — the shed is final: empty
    output (or the tokens already produced, for a resumed request),
    counted exactly once."""
    slo = eng.slo
    if (not terminal and slo is not None and req.on_shed is not None
            and req.retries < slo.cfg.retry_max):
        req.retries += 1
        eng._m["shed_retried"] += 1
        instrument.shed(eng, req, retried=True)
        req.on_shed(req, slo.retry_after(req))
        return
    out = (np.asarray(req.out_tokens, np.int32) if req.out_tokens
           else empty_tokens())
    req.outcome = "shed"
    results[req.rid] = out
    eng._m["shed"] += 1
    instrument.shed(eng, req, retried=False)
    if req.on_finish:
        req.on_finish(req.rid, out)


def never_admissible(eng, req) -> Optional[str]:
    """Reason this request can *never* bind (so waiting is pointless),
    or None.  Used by the serve loop's no-progress guard: with no slot
    active every quota is free and the pool is at its emptiest — if the
    request still cannot fit, it never will."""
    if eng.slo is not None:
        q = eng.slo.quota_for(req.tenant)
        if 0 < q < request_tokens(req):
            return (f"needs {request_tokens(req)} tokens > tenant "
                    f"{req.tenant!r} quota {q}")
    need = eng._stepper.pages_needed(len(effective_prompt(req)) + 1)
    if need is not None and not eng._stepper.fits_pool(need):
        return f"needs {need} pages > pool capacity"
    return None
