"""Slot-table state shared by the admission strategies and the stepper.

The serving engine is slot-based continuous batching: ``n_slots`` fixed
batch rows, each either free or bound to one in-flight :class:`Request`.
:class:`SlotTable` owns the *host-side* mirror of that binding — per-slot
request pointers, sampling policy rows, the host-tracked cache lengths,
the pending prompt tails of chunked and prefix-hit admissions, and the
per-slot prompt block hashes the paged prefix index keys on.  Device state
(the dense cache block or the page store) lives in the stepper
(:mod:`.stepper`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (T,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled
    top_p: float = 0.0           # 0 or >= 1 => disabled (nucleus)
    deadline: Optional[float] = None   # absolute engine-clock cutoff
    on_token: Optional[Callable[[int, int], None]] = None
    on_finish: Optional[Callable[[int, np.ndarray], None]] = None
    on_admit: Optional[Callable[[int], None]] = None
    out_tokens: Optional[list] = None
    preempts: int = 0            # times evicted from a slot
    resume: bool = False         # re-queued mid-flight; keep out_tokens
    outcome: Optional[str] = None    # completed|expired|truncated


def effective_prompt(req: Request) -> np.ndarray:
    """The token sequence admission must (re)build KV for: the prompt,
    plus — for a resumed preempted request — everything it already
    emitted.  Treating prompt+out as the prompt makes resume ordinary
    admission: prefill (or a prefix-index hit) recomputes the KV that was
    released, and the first sampled token continues the output stream."""
    p = np.asarray(req.prompt, np.int32)
    if req.resume and req.out_tokens:
        return np.concatenate([p, np.asarray(req.out_tokens, np.int32)])
    return p


def empty_tokens() -> np.ndarray:
    return np.zeros((0,), np.int32)


class SlotTable:
    """Host-side slot <-> request state.

    ``slot_len`` is the host mirror of each slot's valid cache length.
    ``fill[s]`` is the not-yet-prefilled prompt tail of a chunked or
    prefix-hit admission — while non-None the slot is teacher-forcing its
    prompt through the decode step and emits nothing.  ``hashes[s]`` keeps
    the prompt's block hashes for paged prefix-index registration.
    ``slot_last`` is the device tensor of each slot's last sampled token.
    """

    def __init__(self, n: int, device):
        self.n = n
        self.req: List[Optional[Request]] = [None] * n
        self.active = np.zeros(n, bool)
        self.temps = np.zeros(n, np.float32)
        self.top_k = np.zeros(n, np.int32)
        self.top_p = np.zeros(n, np.float32)
        self.slot_len = np.zeros(n, np.int64)
        self.fill: List[Optional[np.ndarray]] = [None] * n
        self.hashes: List[Optional[list]] = [None] * n
        self.slot_last = torch.zeros((n,), dtype=torch.int32, device=device)

    def free(self) -> List[int]:
        return [s for s in range(self.n) if self.req[s] is None]

    def any_active(self) -> bool:
        return bool(self.active.any())

    def bind(self, req: Request, s: int):
        """Bind a request to slot ``s`` (policy rows + request pointer;
        engine-level accounting stays in the engine).  A resumed preempted
        request keeps its emitted tokens: the finish checks and the token
        budget continue from where the eviction cut it."""
        if not req.resume:
            req.out_tokens = []
        self.req[s] = req
        self.active[s] = True
        self.temps[s] = req.temperature
        self.top_k[s] = req.top_k
        self.top_p[s] = req.top_p

    def clear(self, s: int):
        self.req[s] = None
        self.active[s] = False
        self.fill[s] = None
        self.hashes[s] = None

    def input_tokens(self) -> torch.Tensor:
        """Next decode-step input per slot: the last sampled token, with
        filling slots teacher-forced from their prompt tail.  Steady state
        (nothing filling) passes ``slot_last`` through on the device."""
        filling = [s for s in range(self.n)
                   if self.active[s] and self.fill[s] is not None]
        if not filling:
            return self.slot_last
        sl = self.slot_last.cpu().numpy().copy()
        for s in filling:
            sl[s] = self.fill[s][0]
        return torch.as_tensor(sl, device=self.slot_last.device)
