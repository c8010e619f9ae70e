"""Metrics half of the observability layer.

A Prometheus-flavoured, dependency-free registry of named, labeled series:

* :class:`Counter` — monotonically increasing (``inc``): dispatches, cache
  hits, GC evictions, segment compactions, dropped dispatch-log entries…
* :class:`Gauge` — last-set value (``set``): store LRU length, history
  cells, wasted lane fraction of the most recent segmented run…
* :class:`Info` — last-set string: default backend, engine version…
* :class:`Histogram` — streaming distribution (``observe``): count / sum /
  min / max plus power-of-two bucket counts, for e.g. rows-per-dispatch.

Series are keyed by ``(kind, name, sorted label items)``; ``counter()`` et
al. are get-or-create, so instrumented code never has to pre-register.
:meth:`MetricsRegistry.snapshot` renders everything into one JSON-able
dict — the daemon-ready ``stats()`` payload (``SimulationService.stats()``
embeds it under ``"metrics"``).

A process-global default registry (:data:`REGISTRY`) backs components that
are not handed an explicit one; tests pass fresh registries for isolation.
All operations are thread-safe and cheap (a dict lookup + float add under
a lock only on first creation); metrics are always on — unlike tracing
there is no enable knob, because the cost is negligible.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[dict]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``inc(n)`` only; negative increments rejected."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: float = 1):
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self.value += n


class Gauge:
    """Last-written value; ``set`` or ``inc`` (which may go negative)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float):
        self.value = v

    def inc(self, n: float = 1):
        self.value += n


class Info:
    """A string-valued annotation (backend name, engine version, ...)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = ""

    def set(self, v: str):
        self.value = str(v)


class Histogram:
    """Streaming distribution: count/sum/min/max + power-of-two buckets.

    Bucket ``i`` counts observations with ``2**(i-1) < x <= 2**i`` (bucket
    0 is ``x <= 1``); good enough resolution for rows-per-dispatch or
    microsecond latencies without configuring bucket edges per series.
    """

    __slots__ = ("name", "labels", "count", "sum", "min", "max", "buckets")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = None  # type: Optional[float]
        self.max = None  # type: Optional[float]
        self.buckets: Dict[int, int] = {}

    def observe(self, x: float):
        self.count += 1
        self.sum += x
        if self.min is None or x < self.min:
            self.min = x
        if self.max is None or x > self.max:
            self.max = x
        b = 0
        edge = 1.0
        while x > edge and b < 64:
            b += 1
            edge *= 2.0
        self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "buckets": {str(2 ** b): n
                        for b, n in sorted(self.buckets.items())},
        }


class MetricsRegistry:
    """Get-or-create registry of labeled Counter/Gauge/Info/Histogram
    series with a JSON-able :meth:`snapshot`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, str, LabelKey], object] = {}

    def _get(self, kind: str, cls, name: str, labels: Optional[dict]):
        key = (kind, name, _label_key(labels))
        inst = self._series.get(key)
        if inst is None:
            with self._lock:
                inst = self._series.get(key)
                if inst is None:
                    inst = cls(name, key[2])
                    self._series[key] = inst
        return inst

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def info(self, name: str, labels: Optional[dict] = None) -> Info:
        return self._get("info", Info, name, labels)

    def histogram(self, name: str,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def series(self) -> List[object]:
        """All live series, sorted by (kind, name, labels)."""
        with self._lock:
            items = sorted(self._series.items())
        return [inst for _, inst in items]

    def find(self, kind: str, name: str) -> List[tuple]:
        """Live ``(labels, instance)`` pairs of every series of ``kind``
        named ``name``, across all label sets — e.g. every
        ``check.violations{pass=...,rule=...}`` counter the sanitizer and
        the static passes have incremented."""
        with self._lock:
            items = sorted(self._series.items())
        return [(dict(key[2]), inst) for key, inst in items
                if key[0] == kind and key[1] == name]

    def snapshot(self) -> dict:
        """Render every series into one JSON-able dict, keyed
        ``name`` or ``name{label=value,...}`` per kind."""
        out = {"counters": {}, "gauges": {}, "info": {}, "histograms": {}}
        with self._lock:
            items = sorted(self._series.items())
        for (kind, name, labels), inst in items:
            rendered = _render(name, labels)
            if kind == "counter":
                out["counters"][rendered] = inst.value
            elif kind == "gauge":
                out["gauges"][rendered] = inst.value
            elif kind == "info":
                out["info"][rendered] = inst.value
            else:
                out["histograms"][rendered] = inst.to_dict()
        return out

    def reset(self):
        """Drop every series (test isolation for the global registry)."""
        with self._lock:
            self._series.clear()


#: Process-global default registry; components use it unless handed an
#: explicit ``MetricsRegistry``.
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY
