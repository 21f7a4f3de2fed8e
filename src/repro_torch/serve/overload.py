"""Page-pool backpressure: preemption of a slot when a page allocation
cannot be satisfied.

A serve-path allocation that finds the pool exhausted raises
:class:`.pages.PagePressure`; the engine's serve loop catches it and calls
:func:`relieve_pressure`, which preempts a victim slot — publishing its
full KV blocks to the prefix index and re-queueing the request with
``resume=True`` — and lets the loop retry.  Throughput degrades; the loop
does not die.  (SLO shedding and tenant quotas, the other half of the
reference's overload layer, are not ported yet.)
"""
from __future__ import annotations

from typing import Optional


def _deadline(req) -> float:
    return req.deadline if req.deadline is not None else float("inf")


def pick_victim(st, exclude: Optional[int] = None) -> Optional[int]:
    """Latest-deadline active slot, ties toward fewest emitted tokens
    (least recompute thrown away), then the highest slot index.

    ``exclude`` names the slot whose allocation raised the pressure:
    preempting the requester itself frees nothing for anyone else (the
    loop would re-admit it and hit the same wall), so it is only eligible
    when it is the sole active slot."""
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
    registers every full KV block (prompt and generated tokens alike) in
    the prefix index under the effective-sequence hash chain, so the
    resume's prefix-hit admission maps the same physical pages back and
    only recomputes the partial tail block.  The request re-enters the
    queue in deadline order with ``resume=True``; its ``out_tokens``
    survive and admission treats prompt+out as the prompt."""
    st = run.st
    req = st.req[s]
    eng._m["preempted"] += 1
    req.preempts += 1
    eng._stepper.preempt(st, s)
    st.clear(s)
    req.resume = True
    dl = _deadline(req)
    pos = next((i for i, r in enumerate(run.queue) if _deadline(r) > dl),
               len(run.queue))
    run.queue.insert(pos, req)


def relieve_pressure(eng, run, pressure) -> bool:
    """Handle one :class:`.pages.PagePressure` from a step or an admission
    reservation: preempt the victim and let the loop retry.  Returns
    False only when there is nothing to preempt (pressure during admission
    with no active slot — the retry itself is the response)."""
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
