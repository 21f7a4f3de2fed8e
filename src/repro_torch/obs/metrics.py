"""Metrics registry: Counter / Gauge / Histogram.

The port's copy of ``repro/obs/metrics.py`` (which imports no JAX; the
port imports nothing of ``repro``), with the same semantics and names, so
the engine's registry snapshots and deltas have the reference's keys.

* a **metric** is a named :class:`Counter`, :class:`Gauge`, or
  :class:`Histogram`, optionally **labeled** (``tenant=``,
  ``cache_kind=``, ``phase=``); the (name, labels) pair is the
  identity, so ``registry.counter("serve.shed_by_tenant", tenant="a")``
  always returns the same object;
* a **group** (:class:`MetricGroup`) is a dict-shaped view over
  counters sharing a name prefix — ``group["tokens_generated"] += 1``
  keeps the ergonomics of a plain dict while every increment lands in the
  registry (``dict(group)`` materializes the plain shape);
* :meth:`MetricsRegistry.snapshot` flattens everything to a JSON-safe
  dict and :meth:`MetricsRegistry.delta` subtracts a prior snapshot —
  counters and histograms difference, gauges report current — which is
  what ``Scheduler.run`` digests into ``RunResult.summary``.

The never-NaN percentile helpers live here too
(:func:`never_nan_percentile`, :func:`dist_ms`): an empty or
shed-everything sample reports zeros, never a NaN.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# Fixed bucket edges for millisecond-latency histograms: two-ish steps
# per decade across the range a serving step or TTFT can land in.
# Fixed (not adaptive) edges keep snapshots subtractable and traces
# comparable across runs.
DEFAULT_MS_EDGES = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                    500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def never_nan_percentile(xs, q) -> float:
    """Exact percentile hardened for overload reports: an empty sample
    (a run that shed or expired everything) reports 0.0, not a crash or
    a NaN.  Non-finite samples are dropped before the percentile."""
    arr = np.asarray(list(xs) if not hasattr(xs, "size") else xs,
                     np.float64)
    if arr.size == 0:
        return 0.0
    arr = arr[np.isfinite(arr)]
    if arr.size == 0:
        return 0.0
    return float(np.percentile(arr, q))


def dist_ms(xs) -> dict:
    """p50/p95/p99/mean/n of a sample of *seconds*, reported in ms —
    the distribution shape every latency report in the repo uses.
    Empty samples report all-zero (never NaN)."""
    if not xs:
        return dict(p50=0.0, p95=0.0, p99=0.0, mean=0.0, n=0)
    ms = [1e3 * x for x in xs]
    return dict(p50=never_nan_percentile(ms, 50),
                p95=never_nan_percentile(ms, 95),
                p99=never_nan_percentile(ms, 99),
                mean=float(np.mean(ms)), n=len(ms))


class Counter:
    """Monotonic-by-convention scalar.  Arithmetic type follows the
    values fed in (int counters stay int; ``serve_time_s`` stays
    float), so ``dict(group)`` reproduces the old plain-dict shapes."""

    kind = "counter"

    def __init__(self, value=0):
        self.value = value

    def inc(self, n=1):
        self.value = self.value + n

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time scalar (queue-delay estimate, in-flight tokens).
    ``delta`` semantics: a gauge reports its *current* value, never a
    difference."""

    kind = "gauge"

    def __init__(self, value=0):
        self.value = value

    def set(self, v):
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram: ``edges`` are upper bounds, plus one
    overflow bucket.  Percentiles interpolate within the landing bucket
    (assuming uniform mass), clamped to the top edge for overflow —
    never NaN, 0.0 when empty."""

    kind = "histogram"

    def __init__(self, edges: Iterable[float] = DEFAULT_MS_EDGES):
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    @classmethod
    def from_samples(cls, xs, edges: Iterable[float] = DEFAULT_MS_EDGES
                     ) -> "Histogram":
        h = cls(edges)
        for x in xs:
            h.observe(x)
        return h

    def observe(self, x):
        x = float(x)
        self.counts[bisect.bisect_left(self.edges, x)] += 1
        self.sum += x
        self.count += 1

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self.edges[-1]
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.edges[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return dict(count=self.count, sum=self.sum,
                    counts=list(self.counts), edges=list(self.edges))


def _qualname(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Get-or-create metric store keyed on (name, sorted labels)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            object] = {}

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(**kwargs)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, edges=DEFAULT_MS_EDGES,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, edges=edges)

    def adopt(self, metric, name: str, **labels):
        """Register an *existing* metric object under this registry
        (rebinding a component built standalone — e.g. a FaultInjector
        constructed before its engine — without losing its counts)."""
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        self._metrics[key] = metric
        return metric

    def group(self, prefix: str, **labels) -> "MetricGroup":
        return MetricGroup(self, prefix, labels)

    def snapshot(self) -> dict:
        """Flat JSON-safe ``{qualified_name: value}`` — scalars for
        counters/gauges, bucket dicts for histograms."""
        return {_qualname(name, labels): m.snapshot()
                for (name, labels), m in sorted(self._metrics.items())}

    def delta(self, before: dict) -> dict:
        """Difference vs a prior :meth:`snapshot`: counters and
        histograms subtract (a metric born since reports its full
        value), gauges report current."""
        out = {}
        for (name, labels), m in sorted(self._metrics.items()):
            q = _qualname(name, labels)
            prev = before.get(q)
            if m.kind == "counter" and prev is not None:
                out[q] = m.value - prev
            elif m.kind == "histogram" and isinstance(prev, dict):
                cur = m.snapshot()
                out[q] = dict(
                    count=cur["count"] - prev.get("count", 0),
                    sum=cur["sum"] - prev.get("sum", 0.0),
                    counts=[a - b for a, b in
                            zip(cur["counts"],
                                prev.get("counts", [0] * len(cur["counts"])))],
                    edges=cur["edges"])
            else:
                out[q] = m.snapshot()
        return out


class MetricGroup:
    """Dict-shaped view over same-prefix counters: ``group["shed"] += 1``
    increments the registry counter ``<prefix>.shed`` (with the group's
    labels).  Provides the mapping protocol the old plain dicts were
    used through — ``dict(group)``, ``in``, ``.items()`` — so existing
    ``metrics()`` consumers see identical shapes."""

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 labels: Optional[dict] = None):
        self._registry = registry
        self._prefix = prefix
        self._labels = dict(labels or {})
        self._names: List[str] = []       # insertion order, dict-like

    def init(self, **values) -> "MetricGroup":
        """Declare the group's counters with initial values (the old
        ``dict(tokens_generated=0, ...)`` literal, one-for-one)."""
        for k, v in values.items():
            self[k] = v
        return self

    def _ctr(self, name: str) -> Counter:
        c = self._registry.counter(f"{self._prefix}.{name}", **self._labels)
        if name not in self._names:
            self._names.append(name)
        return c

    def __getitem__(self, name: str):
        return self._ctr(name).value

    def __setitem__(self, name: str, value):
        self._ctr(name).value = value

    def __contains__(self, name) -> bool:
        return name in self._names

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def keys(self):
        return list(self._names)

    def items(self):
        return [(k, self[k]) for k in self._names]

    def rebind(self, registry: MetricsRegistry) -> "MetricGroup":
        """Move this group's metric objects into another registry (a
        component built standalone joining its engine's registry);
        counts carry over, future snapshots include them."""
        if registry is self._registry:
            return self
        for name in self._names:
            registry.adopt(self._ctr(name), f"{self._prefix}.{name}",
                           **self._labels)
        self._registry = registry
        return self
