"""``repro_torch.obs`` - the fleet-wide observability layer (DESIGN.md SS.8).

Dependency-light structured tracing + metrics + post-mortem capture,
shared by every layer (router, scheduler, compiler, serve engines,
kernel dispatch). Three pieces:

* a span/event **tracer** (:mod:`repro_torch.obs.trace`) exporting Chrome
  trace-event JSON loadable in Perfetto,
* a **metrics registry** (:mod:`repro_torch.obs.metrics`) of counters, gauges
  and fixed-bucket histograms with ``snapshot()``/``as_dict()``,
* an SLO-breach **flight recorder** (:mod:`repro_torch.obs.flight`): a ring
  buffer of the last N per-slice fleet frames, dumped as JSON when the
  running deadline-miss rate or p99 crosses a threshold.

Hot-path contract: instrumentation sites guard on :func:`enabled` - a
module-level boolean read - so with observability off (the default) the
added cost is one predicate per site and **no** allocation:

    from repro_torch import obs

    if obs.enabled():
        t0 = obs.now_ns()
        ...
        obs.complete("sched.slice", t0, args={...}, tid=wid)

Rare events (a compiler LUT build, an autoscaler scale event) may write
through :func:`metrics` unconditionally; that is what keeps the fleet
CLI's lut-cache/autoscale reporting truthful even with tracing off.

Enable with :func:`enable` (optionally attaching a
:class:`~repro_torch.obs.flight.FlightRecorder`), read back through
``repro_torch.api.obs()``, export with :func:`export`. The state is
process-global on purpose: one fleet run = one timeline.

Counts that the device keeps (:func:`count_on_device`: a tensor of
counts added up on the card, so the hot path never waits for it) are
read to the host once, by :func:`read_device_counts`, when the trace
stops (``disable``), and then stand in the metrics registry as counters
labelled by index.

Spans share a timeline with ``torch.profiler``'s host and device events
through a clock anchor (:func:`clock_anchor`, taken by :func:`enable`
and again on request; exported under ``otherData``): convert a span's
``ts`` with :func:`to_unix_ns`.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.obs.flight import FlightRecorder  # noqa: F401
from repro_torch.obs.metrics import (TIME_US_BUCKETS,  # noqa: F401
                               WAIT_SLICE_BUCKETS, Histogram,
                               MetricsRegistry)
from repro_torch.obs.trace import (NULL_SPAN, NullSpan, Span,  # noqa: F401
                             Tracer, now_ns, summarize_events, to_unix_ns)

__all__ = [
    "enabled", "enable", "disable", "reset",
    "tracer", "metrics", "flight_recorder", "set_flight_recorder",
    "span", "instant", "complete", "counter", "gauge", "observe",
    "count_on_device", "read_device_counts",
    "export", "now_ns", "summarize_events", "clock_anchor", "to_unix_ns",
    "Tracer", "MetricsRegistry", "FlightRecorder", "Histogram",
    "NULL_SPAN",
]

_enabled: bool = False
_tracer = Tracer()
_metrics = MetricsRegistry()
_flight: Optional[FlightRecorder] = None
_device_counts: Dict[str, Any] = {}


# -- switches ----------------------------------------------------------------
def enabled() -> bool:
    """The one hot-path guard: True while tracing is on."""
    return _enabled


def enable(*, flight_recorder: Optional[FlightRecorder] = None) -> None:
    """Turn tracing on (idempotent) and take a clock anchor; optionally
    attach a flight recorder in the same call."""
    global _enabled, _flight
    _enabled = True
    _tracer.clock_anchor()
    if flight_recorder is not None:
        _flight = flight_recorder


def clock_anchor() -> Dict[str, int]:
    """Pair the spans' clock with the profiler's Unix-epoch clock again
    (a profile that starts long after :func:`enable` asks for one as it
    starts); returns the anchor the export will carry."""
    return _tracer.clock_anchor()


def disable() -> None:
    """Turn tracing off; the device's counts are read first
    (:func:`read_device_counts`)."""
    global _enabled
    read_device_counts()
    _enabled = False


def reset() -> None:
    """Disable and drop all recorded state (tests; fresh CLI runs)."""
    global _enabled, _flight
    _enabled = False
    _flight = None
    _device_counts.clear()
    _tracer.clear()
    _metrics.clear()


# -- accessors ----------------------------------------------------------------
def tracer() -> Tracer:
    return _tracer


def metrics() -> MetricsRegistry:
    return _metrics


def flight_recorder() -> Optional[FlightRecorder]:
    return _flight


def set_flight_recorder(rec: Optional[FlightRecorder]) -> None:
    global _flight
    _flight = rec


# -- recording shorthands -----------------------------------------------------
def span(name: str, cat: str = "repro", *, tid: Optional[int] = None,
         **attrs):
    """Context-manager span; the shared no-op singleton when disabled."""
    if not _enabled:
        return NULL_SPAN
    return _tracer.span(name, cat, tid=tid, **attrs)


def complete(name: str, t_start_ns: int, *, cat: str = "repro",
             args: Optional[Dict[str, Any]] = None,
             tid: Optional[int] = None,
             t_end_ns: Optional[int] = None) -> None:
    """Record a post-hoc span ending now, or at ``t_end_ns`` (hot-path
    form; callers took ``t_start_ns = obs.now_ns()`` behind their own
    ``enabled()`` check)."""
    if not _enabled:
        return
    _tracer.complete(name, t_start_ns,
                     now_ns() if t_end_ns is None else t_end_ns, cat=cat,
                     args=args, tid=tid)


def instant(name: str, *, cat: str = "repro",
            args: Optional[Dict[str, Any]] = None,
            tid: Optional[int] = None) -> None:
    if not _enabled:
        return
    _tracer.instant(name, cat=cat, args=args, tid=tid)


def counter(name: str, n: int = 1, **labels) -> None:
    if not _enabled:
        return
    _metrics.counter(name, n, **labels)


def gauge(name: str, value: float, **labels) -> None:
    if not _enabled:
        return
    _metrics.gauge(name, value, **labels)


def observe(name: str, value: float, *, buckets=TIME_US_BUCKETS,
            **labels) -> None:
    if not _enabled:
        return
    _metrics.observe(name, value, buckets=buckets, **labels)


def count_on_device(name: str, values) -> None:
    """Add ``values`` (an integer tensor) to the count ``name`` kept on
    its device; no host sync."""
    if not _enabled:
        return
    acc = _device_counts.get(name)
    if acc is None:
        _device_counts[name] = values.detach().clone()
    else:
        acc.add_(values)


def read_device_counts() -> Dict[str, list]:
    """Copy every count kept on a device to the host (one sync each),
    add entry ``i`` of count ``name`` to the counter ``name`` labelled
    ``index=i``, and start the counts again from 0. Returns what was
    read."""
    out = {}
    for name, acc in list(_device_counts.items()):
        vals = [int(v) for v in acc.cpu().tolist()]
        for i, v in enumerate(vals):
            _metrics.counter(name, v, index=i)
        out[name] = vals
    _device_counts.clear()
    return out


# -- export -------------------------------------------------------------------
def export(trace_path=None, metrics_path=None) -> Dict[str, Path]:
    """Write ``trace.json`` (Chrome trace events) and/or ``metrics.json``
    (registry snapshot); returns the paths actually written."""
    import json

    out: Dict[str, Path] = {}
    if trace_path is not None:
        out["trace"] = _tracer.export(trace_path)
    if metrics_path is not None:
        p = Path(metrics_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(_metrics.as_dict(), indent=2))
        out["metrics"] = p
    return out
