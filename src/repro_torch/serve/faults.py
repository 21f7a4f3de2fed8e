"""Deterministic fault injection for the serving stack.

The port of ``repro/serve/faults.py``.

Chaos testing the serve loop needs faults that are *reproducible*: the
same seed and schedule must fail the same allocation, stall the same
step, and burst the same arrivals on every run, so tests can assert
bit-identical survivor outputs and exact metric accounting.  Like the
engine's ``clock=`` seam, :class:`FaultInjector` is one injectable
object consulted at the stack's failure points:

* **page allocations** — :meth:`alloc_ok` is polled by
  :meth:`~.pages.PagePool.try_alloc`; a vetoed allocation looks exactly
  like pool exhaustion and routes through the engine's backpressure
  protocol (preempt → retry), so chaos runs exercise preemption even
  when the pool is sized generously;
* **slow / hung steps** — :meth:`on_loop` is called once per serve-loop
  iteration and burns the scheduled stall through ``advance`` (tests
  pass the fake clock's advance; the default sleeps real time);
* **forced preemptions** — :meth:`take_preempt` tells the engine to
  preempt its lowest-priority slot this iteration, driving the
  preempt/resume machinery on the *dense* cache kind too (which has no
  page pressure of its own);
* **checkpoint write errors** — :meth:`ckpt_hook` is the
  ``fault_hook=`` of a checkpoint writer (the reference's
  ``dist.checkpoint.save``; the port's arrives with its checkpoints) and
  raises ``OSError`` on scheduled write indices;
* **arrival bursts** — :func:`burstify` compresses seeded spans of a
  loadgen trace to simultaneous arrivals without changing any request.

Every trigger is counted in :meth:`metrics` (surfaced under the
engine's ``metrics()["faults"]``), so chaos tests can assert each
injected fault was actually consumed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.obs import MetricsRegistry


@dataclasses.dataclass
class FaultConfig:
    """Seeded fault schedule.  All indices are 0-based event counters
    (allocation calls, serve-loop iterations, checkpoint writes), so a
    schedule is deterministic regardless of wall time."""
    seed: int = 0
    alloc_fail_at: Tuple[int, ...] = ()    # allocation-call indices to veto
    alloc_fail_every: int = 0              # also veto every Nth call (0=off)
    alloc_fail_max: int = 64               # cap on *_every vetoes (liveness)
    stall_at: Tuple[int, ...] = ()         # serve-loop iterations to stall
    stall_s: float = 0.0                   # seconds per injected stall
    preempt_at: Tuple[int, ...] = ()       # iterations forcing a preemption
    ckpt_fail_at: Tuple[int, ...] = ()     # checkpoint writes to fail
    burst_every: int = 0                   # burstify: collapse every Nth gap
    burst_span: int = 4                    # arrivals merged per burst


class FaultInjector:
    """One deterministic fault source for a whole serve stack.

    ``advance`` is the time-burning hook for injected stalls: tests pass
    their fake clock's advance function; the default is ``time.sleep``
    (bounded by the schedule, never a clock *read*: the engine's clock
    seam is untouched).
    """

    def __init__(self, cfg: Optional[FaultConfig] = None, *,
                 advance: Optional[Callable[[float], None]] = None):
        self.cfg = cfg or FaultConfig()
        self.advance = advance if advance is not None else time.sleep
        self._alloc_calls = 0
        self._loop_iters = 0
        self._ckpt_writes = 0
        # registry-backed counter group (mapping-compatible with the
        # plain dict it replaces); an injector built standalone gets a
        # private registry and the engine rebinds it at attach time
        self.counts = MetricsRegistry().group("faults").init(
            alloc_failures=0, stalls=0, forced_preempts=0, ckpt_failures=0)

    # -- page allocations ----------------------------------------------------
    def alloc_ok(self) -> bool:
        """Polled by ``PagePool.try_alloc`` once per allocation attempt;
        False makes the attempt look like pool exhaustion."""
        i = self._alloc_calls
        self._alloc_calls += 1
        fail = i in self.cfg.alloc_fail_at
        if not fail and self.cfg.alloc_fail_every:
            fail = ((i + 1) % self.cfg.alloc_fail_every == 0
                    and self.counts["alloc_failures"]
                    < self.cfg.alloc_fail_max)
        if fail:
            self.counts["alloc_failures"] += 1
        return not fail

    # -- serve-loop iteration hooks ------------------------------------------
    def on_loop(self):
        """Called once per serve-loop iteration; burns any scheduled
        stall for this iteration through ``advance``."""
        i = self._loop_iters
        self._loop_iters += 1
        if i in self.cfg.stall_at and self.cfg.stall_s > 0:
            self.counts["stalls"] += 1
            self.advance(self.cfg.stall_s)

    def take_preempt(self) -> bool:
        """True when this iteration is scheduled to force-preempt (the
        engine picks the victim by its normal priority order).  Uses the
        iteration counter advanced by :meth:`on_loop`, so call order is
        on_loop() first, take_preempt() second, every iteration.  The
        count records *landed* preemptions, not scheduled ones — a
        schedule hit with no active slot injects nothing, so the engine
        reports back through :meth:`count_preempt` after it evicts."""
        return (self._loop_iters - 1) in self.cfg.preempt_at

    def count_preempt(self):
        self.counts["forced_preempts"] += 1

    # -- checkpoint writes ---------------------------------------------------
    def ckpt_hook(self):
        """A checkpoint writer's ``fault_hook=``; raises
        OSError on scheduled write indices (after the data payload is
        on disk, before the manifest promotes — the atomicity window
        the checkpoint protocol must survive)."""
        i = self._ckpt_writes
        self._ckpt_writes += 1
        if i in self.cfg.ckpt_fail_at:
            self.counts["ckpt_failures"] += 1
            raise OSError(f"injected checkpoint write failure #{i}")

    # -- observability -------------------------------------------------------
    def metrics(self) -> dict:
        return dict(self.counts,
                    alloc_calls=self._alloc_calls,
                    loop_iters=self._loop_iters,
                    ckpt_writes=self._ckpt_writes)


def burstify(trace, cfg: FaultConfig):
    """Compress seeded spans of a ``[(arrival_offset_s, Request)]``
    trace into simultaneous bursts: every ``burst_every``-th arrival
    pulls the following ``burst_span - 1`` arrivals onto its own
    timestamp.  Requests are untouched — only *when* they arrive
    changes, so greedy outputs stay comparable to the unbursted run."""
    if not cfg.burst_every:
        return list(trace)
    items = sorted(trace, key=lambda it: it[0])
    out, i = [], 0
    rng = np.random.default_rng(cfg.seed)
    while i < len(items):
        if (i // cfg.burst_every) and i % cfg.burst_every == 0:
            span = 1 + int(rng.integers(1, max(cfg.burst_span, 2)))
            t0 = items[i][0]
            for t, req in items[i:i + span]:
                out.append((t0, req))
            i += span
        else:
            out.append(items[i])
            i += 1
    return out
