"""Structured span/event tracer exporting Chrome trace-event JSON.

A :class:`Tracer` collects *complete* spans (``ph: "X"``) and *instant*
events (``ph: "i"``) on the process monotonic clock
(``time.perf_counter_ns``), thread-safe, and serializes them in the
Chrome trace-event format that Perfetto (ui.perfetto.dev) and
``chrome://tracing`` load directly:

    {"traceEvents": [{"name": ..., "cat": ..., "ph": "X",
                      "ts": <us>, "dur": <us>, "pid": ..., "tid": ...,
                      "args": {...}}, ...],
     "displayTimeUnit": "ms"}

``tid`` defaults to the OS thread id; fleet code passes logical track
ids (one per engine worker) plus :meth:`Tracer.name_track` metadata so
every engine renders as its own named row. Spans nest by ts/dur
containment per track, exactly Perfetto's slice semantics.

The hot path reads ``perf_counter_ns`` only. A *clock anchor*
(:meth:`Tracer.clock_anchor`) pairs that clock with the Unix-epoch
clock that ``torch.profiler`` stamps its host and device events with;
the export writes the newest one into the top-level ``otherData``, and
:func:`to_unix_ns` puts a span's ``ts`` on the profiler's timeline.

The hot-path contract lives one level up (``repro_torch.obs``): call sites
guard on ``obs.enabled()`` so a disabled tracer costs one predicate,
not an allocation. The tracer itself never checks the global switch -
it is usable standalone in tests.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional


def now_ns() -> int:
    """Monotonic timestamp shared by every span in a process."""
    return time.perf_counter_ns()


def to_unix_ns(ts_us: float, anchor: Dict[str, int]) -> int:
    """An exported event's ``ts`` (us since the tracer's origin) on the
    Unix-epoch clock of ``anchor`` (:meth:`Tracer.clock_anchor`)."""
    return anchor["ts0_unix_ns"] + round(ts_us * 1e3)


class Span:
    """Context manager recording one complete ("X") event on exit.

    Attributes set through :meth:`set` (or the ``attrs`` mapping passed
    at construction) land in the event's ``args`` and show up in the
    Perfetto slice detail pane.
    """

    __slots__ = ("_tracer", "name", "cat", "tid", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 tid: Optional[int], attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.attrs = dict(attrs) if attrs else {}
        self._t0 = 0

    def set(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        self._t0 = now_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.complete(self.name, self._t0, now_ns(), cat=self.cat,
                              args=self.attrs, tid=self.tid)


class NullSpan:
    """Shared no-op stand-in returned while tracing is disabled."""

    __slots__ = ()

    def set(self, key: str, value: Any) -> "NullSpan":
        return self

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = NullSpan()


class Tracer:
    """Thread-safe collector of Chrome trace events (ts/dur in us)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._tracks: Dict[int, str] = {}
        self.pid = os.getpid()
        self.t0_ns = now_ns()
        self.anchor: Optional[Dict[str, int]] = None

    # -- recording ----------------------------------------------------------
    def _ts_us(self, t_ns: int) -> float:
        return (t_ns - self.t0_ns) / 1e3

    def span(self, name: str, cat: str = "repro", *,
             tid: Optional[int] = None, **attrs) -> Span:
        """Open a complete-span context manager (records on ``__exit__``)."""
        return Span(self, name, cat, tid, attrs)

    def complete(self, name: str, t_start_ns: int, t_end_ns: int, *,
                 cat: str = "repro", args: Optional[Dict] = None,
                 tid: Optional[int] = None) -> None:
        """Record an already-timed span (post-hoc "X" event): hot paths
        take two clock reads and call this once, skipping the context
        manager allocation."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._ts_us(t_start_ns),
              "dur": max((t_end_ns - t_start_ns) / 1e3, 0.0),
              "pid": self.pid,
              "tid": threading.get_ident() if tid is None else tid,
              "args": args or {}}
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, *, cat: str = "repro",
                args: Optional[Dict] = None,
                tid: Optional[int] = None) -> None:
        """Record a zero-duration marker (``ph: "i"``, thread-scoped)."""
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._ts_us(now_ns()),
              "pid": self.pid,
              "tid": threading.get_ident() if tid is None else tid,
              "args": args or {}}
        with self._lock:
            self._events.append(ev)

    def clock_anchor(self) -> Dict[str, int]:
        """Pair this tracer's clock with the Unix-epoch clock and keep the
        pair as :attr:`anchor`: of five readings of ``time.time_ns``,
        each between two of ``perf_counter_ns``, the one read between the
        closest two. ``ts0_unix_ns`` is the Unix time of ``ts`` 0;
        ``uncertainty_ns`` is half the bracket."""
        best = None
        for _ in range(5):
            a = now_ns()
            u = time.time_ns()
            b = now_ns()
            if best is None or b - a < best[0]:
                best = (b - a, (a + b) // 2, u)
        width, p, u = best
        anchor = {"perf_counter_ns": p, "unix_ns": u,
                  "ts0_unix_ns": u - (p - self.t0_ns),
                  "uncertainty_ns": width // 2}
        with self._lock:
            self.anchor = anchor
        return anchor

    def name_track(self, tid: int, name: str) -> None:
        """Label a logical track (rendered as the row name in Perfetto)."""
        with self._lock:
            self._tracks[tid] = name

    # -- export -------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the recorded events (copy; metadata not included)."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tracks.clear()
            self.anchor = None

    def to_chrome(self) -> Dict[str, Any]:
        """The full trace-event JSON object (with track-name metadata,
        and the clock anchor, when one was taken, under ``otherData``)."""
        with self._lock:
            meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                     "tid": tid, "args": {"name": label}}
                    for tid, label in sorted(self._tracks.items())]
            doc = {"traceEvents": meta + list(self._events),
                   "displayTimeUnit": "ms"}
            if self.anchor is not None:
                doc["otherData"] = {"clock_anchor": dict(self.anchor)}
            return doc

    def export(self, path) -> Path:
        """Write Perfetto-loadable JSON to ``path`` (parents created)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome()))
        return path


def summarize_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Aggregate trace events per span name: count, total/mean/max wall
    time. Shared by the obs CLI's text renderer and tests; accepts the
    ``traceEvents`` list of a loaded trace.json as-is."""
    agg: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        a = agg.setdefault(ev["name"], {"name": ev["name"],
                                        "cat": ev.get("cat", ""),
                                        "count": 0, "total_us": 0.0,
                                        "max_us": 0.0})
        a["count"] += 1
        a["total_us"] += ev["dur"]
        a["max_us"] = max(a["max_us"], ev["dur"])
    rows = sorted(agg.values(), key=lambda r: -r["total_us"])
    for r in rows:
        r["mean_us"] = r["total_us"] / r["count"]
    return rows
