"""Counter, gauge and histogram registry with Prometheus text exposition.

The port's copy of ``repro/obs/metrics.py``: a thread-safe namespace of
metric families, created lazily and idempotently
(``REGISTRY.counter("sched_requests_total", ...)`` returns the existing
family on repeat calls), with labelled children cached per label-value
tuple. Histograms keep cumulative bucket counts, a sum and a count.

* ``render()`` — the Prometheus text exposition format 0.0.4 (``# HELP``
  / ``# TYPE`` and the samples), served by the gateway's ``GET /metrics``;
* ``snapshot()`` — a plain-dict dump (the gateway's ``/metrics.json``),
  and :func:`merge_snapshots` folds several processes' snapshots into
  one, each sample labelled with its ``peer``.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Tuple

# default buckets: latency-shaped, seconds
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def _labelstr(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
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

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

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

    def children(self) -> List[Tuple[Tuple[Tuple[str, str], ...], object]]:
        with self._lock:
            return list(self._children.items())

    def _snapshot_children(self, one) -> object:
        if not self.labelnames:
            return one(self._default())
        return {_labelstr(lk) or "{}": one(c) for lk, c in self.children()}


class Counter(_Family):
    """Monotonically increasing count (``*_total`` by convention)."""

    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def render(self) -> List[str]:
        return [f"{self.name}{_labelstr(lk)} {_fmt(c.get())}"
                for lk, c in self.children()]

    def snapshot(self) -> object:
        return self._snapshot_children(lambda c: c.get())


class Gauge(Counter):
    """A value that goes up and down (queue depth, slots in use)."""

    kind = "gauge"

    def set(self, value: float) -> None:
        self._default().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._default().inc(-amount)


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

    def render(self) -> List[str]:
        out = []
        for lk, ch in self.children():
            for b, cum in zip(ch.buckets, ch.counts):
                out.append(f"{self.name}_bucket"
                           f"{_labelstr(lk + (('le', _fmt(b)),))} {cum}")
            out.append(f"{self.name}_bucket"
                       f"{_labelstr(lk + (('le', '+Inf'),))} {ch.count}")
            out.append(f"{self.name}_sum{_labelstr(lk)} {_fmt(ch.total)}")
            out.append(f"{self.name}_count{_labelstr(lk)} {ch.count}")
        return out

    def snapshot(self) -> object:
        return self._snapshot_children(lambda ch: {
            "count": ch.count, "sum": ch.total,
            "buckets": {_fmt(b): n for b, n in zip(ch.buckets, ch.counts)}})


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
            elif not isinstance(fam, cls):
                raise ValueError(f"{name} already registered as {fam.kind}")
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def _sorted(self) -> List[_Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def render(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines = []
        for fam in self._sorted():
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict dump of every family."""
        return {fam.name: fam.snapshot() for fam in self._sorted()}


def merge_snapshots(snaps: Dict[str, Dict[str, object]]
                    ) -> Dict[str, object]:
    """Merge per-peer ``snapshot()`` dicts into fleet-wide series, each
    sample re-labelled with ``peer="<peer_id>"``. Two peers' same
    labelset stay two series; an inner ``peer=`` label becomes
    ``src_peer=``, so no merged key holds two ``peer=`` labels."""
    out: Dict[str, object] = {}
    for peer, snap in snaps.items():
        if not isinstance(snap, dict):
            continue
        for name, val in snap.items():
            fam = out.setdefault(name, {})
            if isinstance(val, dict) and not _is_hist(val):
                for lbl, v in val.items():
                    fam[_relabel(lbl, peer)] = v
            else:
                fam[f'{{peer="{peer}"}}'] = val
    return out


def _is_hist(val: dict) -> bool:
    return set(val) == {"count", "sum", "buckets"}


def _relabel(lbl: str, peer: str) -> str:
    inner = lbl.strip("{}")
    if inner:
        inner = ",".join(("src_" + p if p.startswith('peer="') else p)
                         for p in inner.split(","))
    parts = [p for p in (f'peer="{peer}"', inner) if p]
    return "{" + ",".join(parts) + "}"


REGISTRY = MetricsRegistry()
