"""Optional ``torch.profiler`` hooks for the serving entry points.

The span tracer (:mod:`.trace`) answers *host-side* timeline questions;
when the question is "what is the card doing inside that span", the
PyTorch profiler is the tool.  This module is the thin seam between the
two, the counterpart of ``repro/obs/profile.py`` (``jax.profiler``):

* :func:`profile_session` — wrap a run in ``torch.profiler.profile``
  (host and, with a card, CUDA activity) and write its Chrome trace into
  ``logdir``.  ``logdir=None`` degrades to a no-op, so call sites never
  branch.
* :func:`annotation` — a named ``torch.profiler.record_function`` region
  around one engine step, so the profile shows which Python layer
  launched which kernels.  ``ServeEngine(profile=True)`` applies it to
  every admit pass, decode step and spec cycle.

Nothing here is on by default: profiling is opt-in per run
(``launch/serve.py --profile-dir``), and the no-op paths add a single
attribute check to the serve loop.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch


def profiler_available() -> bool:
    return hasattr(torch, "profiler")


@contextmanager
def profile_session(logdir=None):
    """Profile the enclosed block and write ``trace.json`` (Chrome trace
    format) into ``logdir``; yields the ``torch.profiler.profile`` object
    (its ``key_averages()`` and ``events()`` stay readable after the block)
    or None when ``logdir`` is falsy."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


def annotation(name: str):
    """Named profiler region for one engine step (a no-op outside a
    profiling session)."""
    return torch.profiler.record_function(name)
