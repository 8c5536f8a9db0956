"""Counter/gauge/histogram registry with labeled instruments.

A :class:`MetricsRegistry` holds named instruments, each optionally
split by a set of string labels (``counter("fleet.admit", reason=
"queue_full")``). Instruments are created on first touch; histograms
use *fixed* bucket upper bounds fixed at creation (first ``observe``
wins, later calls reuse them), so snapshots from different engines
merge trivially. ``snapshot()``/``as_dict()`` return plain JSON-able
dicts - the ``metrics.json`` the fleet CLI writes is exactly one
``as_dict()``.

Thread-safe via one registry lock; the per-record work is a dict lookup
and an integer add, cheap enough to leave always-on for rare events
(compiler builds). Hot paths (per-slice, per-dispatch) additionally
guard on ``repro_torch.obs.enabled()``.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: default histogram buckets for slice-denominated waits (upper bounds)
WAIT_SLICE_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
#: default buckets for wall-time micro-measurements, in microseconds
TIME_US_BUCKETS = (10.0, 50.0, 100.0, 500.0, 1e3, 5e3, 1e4, 1e5, 1e6)

Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> Key:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _fmt(key: Key) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` tallies observations with
    ``value <= buckets[i]``; the trailing slot is the +inf overflow."""

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, buckets: Sequence[float]) -> None:
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile (``q`` in [0, 100]): the upper
        bound of the bucket holding the nearest-rank observation, or the
        observed max for the +inf overflow slot. None when empty.
        Resolution is the bucket grid - good enough for the autoscaler /
        bench wait-distribution summaries it feeds."""
        if not self.count:
            return None
        rank = max(int(math.ceil(q / 100.0 * self.count)), 1)
        acc = 0
        for i, n in enumerate(self.counts):
            acc += n
            if acc >= rank:
                return (self.buckets[i] if i < len(self.buckets)
                        else self.max)
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another histogram with the SAME bucket grid into this
        one (per-cell wait histograms -> one fleet-wide distribution)."""
        if other.buckets != self.buckets:
            raise ValueError(f"bucket grids differ: {self.buckets} vs "
                             f"{other.buckets}")
        for i, n in enumerate(other.counts):
            self.counts[i] += n
        self.sum += other.sum
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def as_dict(self) -> Dict[str, Any]:
        return {"buckets": list(self.buckets),
                "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": (self.sum / self.count) if self.count else None}


class MetricsRegistry:
    """Named, labeled counters/gauges/histograms behind one lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Key, Counter] = {}
        self._gauges: Dict[Key, Gauge] = {}
        self._histograms: Dict[Key, Histogram] = {}

    # -- recording ----------------------------------------------------------
    def counter(self, name: str, n: int = 1, **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            c.inc(n)

    def gauge(self, name: str, value: float, **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
            g.set(value)

    def observe(self, name: str, value: float, *,
                buckets: Sequence[float] = TIME_US_BUCKETS,
                **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(buckets)
            h.observe(value)

    # -- reading ------------------------------------------------------------
    def value(self, name: str, default: int = 0, **labels) -> int:
        """Current counter value (0 for a never-touched counter)."""
        key = _key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            return c.value if c is not None else default

    def gauge_value(self, name: str, default: float = 0.0,
                    **labels) -> float:
        key = _key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            return g.value if g is not None else default

    def histogram(self, name: str, **labels) -> Optional[Histogram]:
        with self._lock:
            return self._histograms.get(_key(name, labels))

    def as_dict(self) -> Dict[str, Any]:
        """JSON-able snapshot: flat ``name{label=value}`` keys per kind."""
        with self._lock:
            return {
                "counters": {_fmt(k): c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {_fmt(k): g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {_fmt(k): h.as_dict()
                               for k, h in sorted(self._histograms.items())},
            }

    snapshot = as_dict

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def render(self) -> List[str]:
        """Human-readable lines for the CLI text summary."""
        snap = self.as_dict()
        lines = []
        for name, v in snap["counters"].items():
            lines.append(f"counter   {name} = {v}")
        for name, v in snap["gauges"].items():
            lines.append(f"gauge     {name} = {v:g}")
        for name, h in snap["histograms"].items():
            mean = f"{h['mean']:.3g}" if h["count"] else "-"
            lines.append(f"histogram {name}: n={h['count']} mean={mean} "
                         f"min={h['min']} max={h['max']}")
        return lines
