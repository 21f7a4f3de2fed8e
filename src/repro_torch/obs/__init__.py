"""Observability layer: metrics registry, span tracer, profiler hooks.

The port's counterpart of ``repro.obs``, behind the serving stack's three
measurement questions:

* **how much / how often** — :class:`MetricsRegistry` with
  :class:`Counter` / :class:`Gauge` / :class:`Histogram`, labeled by
  tenant / cache kind / phase; snapshot/delta for per-run digests.
* **when / in what order** — :class:`Tracer`, a ring-buffered span
  collector timestamped exclusively through the engine's injectable
  ``clock=`` seam, exporting Chrome/Perfetto ``trace_event`` JSON.
* **what is the card doing** — :mod:`.profile`, ``torch.profiler``
  sessions and named regions around the engine's steps.
"""
from .metrics import (DEFAULT_MS_EDGES, Counter, Gauge, Histogram,
                      MetricGroup, MetricsRegistry, dist_ms,
                      never_nan_percentile)
from .profile import annotation, profile_session, profiler_available
from .trace import (PID_ENGINE, PID_REQUESTS, Tracer, check_span_nesting,
                    validate_trace)

__all__ = [
    "DEFAULT_MS_EDGES", "Counter", "Gauge", "Histogram", "MetricGroup",
    "MetricsRegistry", "dist_ms", "never_nan_percentile",
    "annotation", "profile_session", "profiler_available",
    "PID_ENGINE", "PID_REQUESTS", "Tracer", "check_span_nesting",
    "validate_trace",
]
