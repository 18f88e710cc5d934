"""Counter and histogram registry, trimmed to what the scheduler uses.

The port's copy of ``repro/obs/metrics.py``: a thread-safe namespace of
metric families, created lazily and idempotently
(``REGISTRY.counter("sched_requests_total", ...)`` returns the existing
family on repeat calls), with labelled children cached per label-value
tuple. Histograms keep cumulative bucket counts, a sum and a count.
``snapshot()`` dumps every family as a plain dict. The Prometheus text
exposition, gauges and the fleet merge wait for the gateway and the
fabric (ROADMAP Queue 1, items 7 and 8).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Tuple

# default buckets: latency-shaped, seconds
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _labelstr(labels: Tuple[Tuple[str, str], ...]) -> str:
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Child:
    """One (family, label-values) count."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def get(self) -> float:
        with self._lock:
            return self.value


class _HistChild:
    __slots__ = ("_lock", "buckets", "counts", "total", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.total += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1


class _Family:
    """Base: a named metric with HELP text and labelled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}
        if not labelnames:          # an unlabelled family exists at once
            self._children[()] = self._make_child()

    def _make_child(self):
        return _Child()

    def labels(self, **labels):
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = tuple((k, str(labels[k])) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels "
                             f"{self.labelnames}; use .labels(...)")
        return self.labels()

    def _snapshot_children(self, one) -> object:
        if not self.labelnames:
            return one(self._default())
        with self._lock:
            items = list(self._children.items())
        return {_labelstr(lk): one(c) for lk, c in items}


class Counter(_Family):
    """Monotonically increasing count (``*_total`` by convention)."""

    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def snapshot(self) -> object:
        return self._snapshot_children(lambda c: c.get())


class Histogram(_Family):
    """Latency histogram with cumulative buckets."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)     # before super(): default child
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def snapshot(self) -> object:
        return self._snapshot_children(lambda ch: {
            "count": ch.count, "sum": ch.total,
            "buckets": dict(zip(ch.buckets, ch.counts))})


class MetricsRegistry:
    """Thread-safe namespace of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get(self, cls, name: str, help: str, labelnames: Iterable[str] = (),
             **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help,
                                                 tuple(labelnames), **kw)
            elif type(fam) is not cls:
                raise ValueError(f"{name} already registered as {fam.kind}")
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict dump of every family."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        return {fam.name: fam.snapshot() for fam in fams}


REGISTRY = MetricsRegistry()
