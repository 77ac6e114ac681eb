"""Metrics registry: counters, gauges, histograms with exact semantics.

The paper's overhead accounting (Fig 13: gettask calls, lock failures,
task counts per type) needs *exact integers*, not sampled approximations
— tests assert counts like "this QR plan executed exactly 5 SSRFT tasks"
and "this serving run retired exactly 5 requests".  So:

* :class:`Counter` — monotonically increasing exact int (``inc``
  under a lock; ``value`` is always the true count);
* :class:`Gauge` — last-written float (page-pool occupancy, queue depth);
* :class:`Histogram` — exact count/sum/min/max plus fixed-boundary
  bucket counts (TTFT / request latency distributions).

A :class:`MetricsRegistry` is a get-or-create namespace of metrics;
``snapshot()`` returns a plain dict for logging/JSON.  The process-global
default registry (``get_registry()``) is what the scheduler core records
to (plan-cache hits/misses, executor task counts, engine launches);
subsystems that need isolated accounting (``serve.GenerateService``) hold
their own registry instance.  Time-series *samples* of metric values are
the tracer's job (``Tracer.counter``) — this module stores only current
values.

Port note: a copy of ``repro.obs.metrics``.  ``repro_torch`` imports nothing of
``repro`` (not even its jax-free modules), so it keeps its own copy.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    """Exact monotonically increasing integer counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: negative increment {n}")
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written value (occupancy, depth, temperature-style metrics)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += float(dv)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self.set(0.0)


class Histogram:
    """Exact count/sum/min/max plus cumulative-style bucket counts over
    fixed upper boundaries (``le``); values above the last boundary land
    in the overflow bucket.  Boundaries are per-histogram and fixed at
    creation, so two observations of the same value always count
    identically (exact accounting, no reservoir sampling)."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        bs = tuple(sorted(DEFAULT_BUCKETS if buckets is None else buckets))
        if not bs:
            raise ValueError(f"histogram {name!r}: need >= 1 bucket bound")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)      # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for b in self.buckets:
                if v <= b:
                    break
                i += 1
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            if not self._count:
                return {"count": 0, "sum": 0.0}
            return {
                "count": self._count, "sum": self._sum,
                "min": self._min, "max": self._max,
                "mean": self._sum / self._count,
                "buckets": {**{f"le_{b:g}": c for b, c in
                               zip(self.buckets, self._counts)},
                            "overflow": self._counts[-1]},
            }

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = float("inf")
            self._max = float("-inf")


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create namespace of metrics.  A name is bound to one kind
    for the registry's lifetime — asking for an existing name with a
    different kind raises (silent kind-aliasing would corrupt counts)."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, *args) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._get_or_create(name, Histogram, buckets)
        if buckets is not None and tuple(sorted(buckets)) != h.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                f"bucket bounds")
        return h

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: counters/gauges as their value, histograms as
        their summary dict."""
        with self._lock:
            items: List[Tuple[str, Metric]] = sorted(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in items:
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def reset(self) -> None:
        """Zero every metric (registrations are kept)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry the scheduler core records to."""
    return _default
