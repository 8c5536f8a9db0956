"""The card's time and its idle time put down to the program's spans,
over a profiled stretch.

Three records are joined: the program's ``obs`` spans, moved onto the
profiler's clock by a clock anchor (``obs.clock_anchor()``, taken as the
profile starts); the profiler's device intervals (kernels, copies,
memsets); and each interval's launch, the host time of the CUDA call
with the same correlation id (:func:`device_intervals`). A device
interval belongs to every program span open on the host when it was
*launched*, however late it ran; an idle stretch of the card goes,
piece by piece, to the *innermost* span open on the host while it
lasted. The fleet runs on one host thread with its workers' spans on
logical tracks, so the innermost span is the shortest one, by time,
that encloses the moment, across tracks.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from portbench.bench import _union

NO_SPAN = "(no span)"


def device_intervals(events) -> dict:
    """From the events of a torch.profiler profile of the host and the
    card (``kineto_results.events()``): the stretch (the host range
    ``pb.window``, else the device intervals' ends), the busy intervals
    (the union of the device intervals, chosen as ``bench.summarize``
    chooses them) and, for each device interval, (launch, start, end,
    name): its launch is the start of the CUDA runtime or driver call
    (``cu*``) with its correlation id, or None."""
    from torch.autograd import DeviceType
    dev, calls, window = [], {}, None
    for e in events:
        name = e.name()
        if name.startswith("pb.") or e.is_user_annotation():
            if name == "pb.window" and e.device_type() != DeviceType.CUDA:
                window = (e.start_ns(), e.end_ns())
        elif e.device_type() == DeviceType.CUDA:
            dev.append((e.correlation_id() or e.linked_correlation_id(),
                        e.start_ns(), e.end_ns(), name))
        elif name.startswith("cu"):
            # the operators' own ids are another numbering: only runtime
            # and driver calls share the device's correlation ids
            calls.setdefault(e.correlation_id(), e.start_ns())
    busy = _union([(a, b) for _, a, b, _ in dev])
    if window is None:
        window = (busy[0][0], busy[-1][1]) if busy else (0, 0)
    return {"stretch_ns": window, "busy_intervals": busy,
            "launches": [(calls.get(cid) if cid else None, a, b, name)
                         for cid, a, b, name in dev]}


def program_spans(events, anchor: dict, lo: int,
                  hi: int) -> List[Tuple[str, int, int]]:
    """(name, start, end) on the profiler's clock of every complete span
    of ``events`` (``obs`` trace events, ``ts``/``dur`` in us) that
    overlaps ``[lo, hi)``."""
    t0 = anchor["ts0_unix_ns"]
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev["dur"] <= 0:
            continue
        a = t0 + round(ev["ts"] * 1e3)
        b = a + round(ev["dur"] * 1e3)
        if b > lo and a < hi:
            out.append((ev["name"], a, b))
    return out


class Timeline:
    """The spans cut at every edge into pieces, each with the names of
    the spans that cover it and the innermost of them."""

    def __init__(self, spans: List[Tuple[str, int, int]]):
        self.edges = sorted({t for _, a, b in spans for t in (a, b)})
        n = max(len(self.edges) - 1, 0)
        inner: List[Optional[Tuple[int, str]]] = [None] * n
        names: List[set] = [set() for _ in range(n)]
        for name, a, b in spans:
            for k in range(bisect_right(self.edges, a) - 1,
                           bisect_right(self.edges, b) - 1):
                names[k].add(name)
                if inner[k] is None or b - a < inner[k][0]:
                    inner[k] = (b - a, name)
        self.cover = [frozenset(s) for s in names]
        self.inner = [NO_SPAN if x is None else x[1] for x in inner]

    def open_at(self, t: int) -> frozenset:
        """The names of the spans open at ``t``."""
        k = bisect_right(self.edges, t) - 1
        return self.cover[k] if 0 <= k < len(self.cover) else frozenset()

    def credit(self, x: int, y: int, acc: Dict[str, int]) -> None:
        """Add ``[x, y)`` to ``acc`` piece by piece, by innermost span."""
        k = bisect_right(self.edges, x) - 1
        while x < y:
            if k < 0:
                end, name = (self.edges[0] if self.edges else y), NO_SPAN
            elif k >= len(self.inner):
                end, name = y, NO_SPAN
            else:
                end, name = self.edges[k + 1], self.inner[k]
            end = min(end, y)
            acc[name] = acc.get(name, 0) + (end - x)
            x = end
            k += 1


def join(trace: dict, events, anchor: dict) -> dict:
    """Launches, busy time (the union of what was launched) and idle
    time of the stretch of ``trace`` (:func:`device_intervals`) by the
    program spans of ``events`` (``obs`` trace events); ns throughout.

    ``launches`` and ``busy_by_span`` count a device interval under
    every span open at its launch; ``idle_by_span`` under the innermost
    one only. ``spans`` counts each name's spans that start in the
    stretch. Device intervals launched outside every span, or whose
    launch the profile lacks, are kept by kernel name (``outside``,
    ``unlaunched``: device time summed)."""
    lo, hi = trace["stretch_ns"]
    spans = program_spans(events, anchor, lo, hi)
    tl = Timeline(spans)
    n_spans: Dict[str, int] = {}
    for name, a, _ in spans:
        if lo <= a < hi:
            n_spans[name] = n_spans.get(name, 0) + 1
    launches: Dict[str, int] = {}
    ops: Dict[str, List[Tuple[int, int]]] = {}
    in_spans: List[Tuple[int, int]] = []
    outside: Dict[str, int] = {}
    unlaunched: Dict[str, int] = {}
    for t, a, b, kernel in trace["launches"]:
        if t is None:
            unlaunched[kernel] = unlaunched.get(kernel, 0) + (b - a)
            continue
        cover = tl.open_at(t)
        if not cover:
            outside[kernel] = outside.get(kernel, 0) + (b - a)
            continue
        in_spans.append((a, b))
        for name in cover:
            launches[name] = launches.get(name, 0) + 1
            ops.setdefault(name, []).append((a, b))
    idle: Dict[str, int] = {}
    prev = lo
    for a, b in list(trace["busy_intervals"]) + [(hi, hi)]:
        if a > prev:
            tl.credit(prev, min(a, hi), idle)
        prev = max(prev, b)
    return {"stretch_ns": hi - lo,
            "busy_ns": _busy(trace["busy_intervals"], lo, hi),
            "busy_in_spans_ns": _busy(_union(in_spans), lo, hi),
            "n_ops": len(trace["launches"]),
            "spans": n_spans, "launches": launches,
            "busy_by_span": {n: _busy(_union(v), lo, hi)
                             for n, v in ops.items()},
            "idle_by_span": idle, "outside": outside,
            "unlaunched": unlaunched}


def _busy(intervals, lo: int, hi: int) -> int:
    """Length of disjoint ``intervals`` inside ``[lo, hi)``."""
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in intervals)
