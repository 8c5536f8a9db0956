"""SLO-aware request routing across a pool of serve engines.

One :class:`EngineWorker` = one HH-PIM serve engine: a
``TimeSliceScheduler`` re-solving weight placement every slice (the paper's
per-device loop), plus a per-engine
:class:`~repro_torch.fleet.forecast.Forecaster` feeding the scheduler's
``lookup_tasks`` hook so migrations happen *proactively*, and optionally
a real ``HeteroServeEngine`` so placement changes are functionally
exercised (weights re-tiered and tokens decoded on the engine's
device).

The fleet runs the paper's buffering discipline at pool scale: requests
arriving during slice ``s`` are dispatched to a worker's backlog and become
executable in slice ``s+1``; each slice a worker drains as much backlog as
fits its current placement's capacity (``cap_to_capacity``), carrying the
rest. A request's latency is measured from the start of its arrival slice
to its completion instant inside its execution slice, so the paper's <= 2T
operational-latency bound is exactly the default SLO (``slo_slices=2``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.core.scheduler import SliceReport, TimeSliceScheduler
from repro_torch.fleet.forecast import Forecaster, NoForecast
from repro_torch.fleet.traces import Trace

POLICIES = ("round_robin", "least_loaded", "slo")

#: admission outcomes recorded per request (reason codes: DESIGN.md SS.8)
ADMIT_ACCEPT = "accept"           # routed to the preferred worker
ADMIT_DEFER = "defer"             # preferred queue full; fell back
ADMIT_REJECT = "reject"           # every queue at the admission limit


@dataclasses.dataclass
class FleetRequest:
    rid: int
    arrival_slice: int
    tokens: int = 8               # decoded tokens = one scheduler task
    worker: Optional[int] = None
    finish_slice: Optional[int] = None
    latency_ns: Optional[float] = None
    rejected: bool = False
    slo_class: str = "default"    # per-class SLO/queue-wait attribution
    tenant: str = "-"             # owning tenant ("-" = untenanted)
    admission: Optional[str] = None   # ADMIT_* outcome stamped by the router
    # hierarchical routing (repro_torch.fleet.hierarchy): cell id + the
    # wait the global tier predicted at admission (feeds the cell's bias EWMA)
    cell: Optional[int] = None
    wait_est: Optional[float] = None


class EngineWorker:
    """One engine of the fleet: scheduler + forecaster + backlog queue."""

    def __init__(self, wid: int, sched: TimeSliceScheduler,
                 forecaster: Optional[Forecaster] = None, *,
                 hetero=None, substrate=None, forecast_margin: float = 1.0):
        self.wid = wid
        self.sched = sched
        self.forecaster = forecaster or NoForecast()
        self.hetero = hetero              # optional HeteroServeEngine
        # optional Substrate: placement application is routed through its
        # apply_placement (functional re-tiering where the platform has one)
        self.substrate = substrate
        self.forecast_margin = forecast_margin
        self.backlog: List[FleetRequest] = []
        self.reports: List[SliceReport] = []
        self.tokens_decoded = 0
        self._arrived_this_slice = 0

    # -- routing signals ---------------------------------------------------
    @property
    def t_slice_ns(self) -> float:
        return self.sched.t_slice_ns

    def t_task_est_ns(self) -> float:
        """Per-task time under the worker's CURRENT placement (what a newly
        routed request would experience before any re-placement)."""
        return self.sched.em.task_cost(self.sched.placement).t_task_ns

    def expected_wait_slices(self, extra: int = 0) -> float:
        """Backlog drain time, in slices, if `extra` more tasks were added."""
        t = self.t_task_est_ns()
        if t <= 0:
            return 0.0
        return (len(self.backlog) + extra) * t / self.t_slice_ns

    # -- per-slice protocol ------------------------------------------------
    def enqueue(self, req: FleetRequest) -> None:
        req.worker = self.wid
        self.backlog.append(req)
        self._arrived_this_slice += 1

    def end_of_slice(self) -> None:
        """Feed this slice's arrival count to the forecaster."""
        self.forecaster.observe(self._arrived_this_slice)
        self._arrived_this_slice = 0

    def step(self, slice_idx: int) -> List[FleetRequest]:
        """Execute one slice against the buffered backlog; returns the
        requests completed this slice (latency stamped)."""
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        n_backlog = len(self.backlog)
        pred = int(math.ceil(self.forecaster.predict()
                             * self.forecast_margin))
        lookup = max(n_backlog, pred)
        rep = self.sched.step(n_backlog, lookup_tasks=lookup,
                              cap_to_capacity=True)
        self.reports.append(rep)
        n_done = rep.n_done
        done, self.backlog = self.backlog[:n_done], self.backlog[n_done:]
        T = self.t_slice_ns
        t_task = rep.t_task_ns
        for i, req in enumerate(done):
            req.finish_slice = slice_idx
            req.latency_ns = ((slice_idx - req.arrival_slice) * T
                              + rep.t_move_ns + (i + 1) * t_task)
            self.tokens_decoded += req.tokens
            if _obs:
                # queue wait in slices, attributed per SLO class
                obs.observe("fleet.queue_wait_slices",
                            slice_idx - req.arrival_slice,
                            buckets=obs.WAIT_SLICE_BUCKETS,
                            cls=req.slo_class, tenant=req.tenant)
        if self.substrate is not None:
            self.substrate.apply_placement(rep.placement, sink=self.hetero)
        elif self.hetero is not None:
            self.hetero.apply_placement(rep.placement)
        if self.hetero is not None and n_done:
            self.hetero.decode(n_done)
        if _obs:
            obs.complete("worker.step", _t0, cat="fleet", tid=self.wid,
                         args={"wid": self.wid, "backlog": n_backlog,
                               "forecast": pred, "n_done": n_done,
                               "carried": len(self.backlog),
                               "moved_weights": rep.moved_weights})
        return done


class FleetRouter:
    """Dispatches arrivals to workers; optionally rejects (admission
    control) when every queue is past ``admission_limit`` tasks."""

    def __init__(self, workers: Sequence[EngineWorker],
                 policy: str = "slo",
                 admission_limit: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.workers = list(workers)
        self.policy = policy
        self.admission_limit = admission_limit
        self._rr = 0

    def _score(self, w: EngineWorker) -> float:
        if self.policy == "least_loaded":
            return len(w.backlog)
        # "slo": expected completion time of the new request, in slices,
        # normalizing out heterogeneous engine speeds
        return w.expected_wait_slices(1)

    def _admits(self, i: int) -> bool:
        return (self.admission_limit is None
                or len(self.workers[i].backlog) < self.admission_limit)

    def route(self, req: FleetRequest) -> bool:
        """Assign ``req`` to a worker; False => rejected by admission (only
        when EVERY queue is at the limit - a full preferred worker falls
        back to the best still-admitting one). Backlogs update as each
        request is enqueued, so scores stay fresh within a slice.

        The admission outcome (accept / defer / reject + reason code) is
        stamped on the request and counted in the metrics registry."""
        n = len(self.workers)
        if self.policy == "round_robin":
            order = [(self._rr + k) % n for k in range(n)]
            self._rr = (self._rr + 1) % n
        else:
            order = sorted(range(len(self.workers)),
                           key=lambda j: (self._score(self.workers[j]), j))
        i = next((j for j in order if self._admits(j)), None)
        if i is None:
            req.rejected = True
            req.admission = ADMIT_REJECT
            if obs.enabled():
                obs.counter("fleet.admission", decision=ADMIT_REJECT,
                            reason="all_queues_full", cls=req.slo_class,
                            tenant=req.tenant)
                obs.instant("fleet.reject", cat="fleet",
                            args={"rid": req.rid,
                                  "reason": "all_queues_full",
                                  "limit": self.admission_limit})
            return False
        req.admission = ADMIT_ACCEPT if i == order[0] else ADMIT_DEFER
        if obs.enabled():
            if req.admission == ADMIT_DEFER:
                obs.counter("fleet.admission", decision=ADMIT_DEFER,
                            reason="preferred_full", cls=req.slo_class,
                            tenant=req.tenant)
            else:
                obs.counter("fleet.admission", decision=ADMIT_ACCEPT,
                            reason="ok", cls=req.slo_class,
                            tenant=req.tenant)
        self.workers[i].enqueue(req)
        return True


@dataclasses.dataclass
class FleetResult:
    trace: str
    completed: List[FleetRequest]
    rejected: List[FleetRequest]
    # still queued when the drain cutoff fired (overload); counted as SLO
    # misses by metrics.summarize so saturation cannot deflate miss rates
    unfinished: List[FleetRequest]
    reports: Dict[int, List[SliceReport]]   # worker id -> per-slice reports
    t_slice_ns: float
    slo_ns: float
    n_slices: int


def _nearest_rank(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile without numpy (flight-recorder trigger
    signal; the reporting-grade percentiles stay in fleet.metrics)."""
    if not xs:
        return None
    ordered = sorted(xs)
    k = max(math.ceil(q / 100.0 * len(ordered)) - 1, 0)
    return ordered[min(k, len(ordered) - 1)]


class Fleet:
    """Trace-driven multi-engine serving loop."""

    def __init__(self, workers: Sequence[EngineWorker], *,
                 policy: str = "slo",
                 admission_limit: Optional[int] = None,
                 slo_slices: float = 2.0,
                 tokens_per_request: int = 8):
        if not workers:
            raise ValueError("fleet needs at least one worker")
        self.workers = list(workers)
        self.router = FleetRouter(self.workers, policy=policy,
                                  admission_limit=admission_limit)
        self.slo_slices = slo_slices
        self.tokens_per_request = tokens_per_request
        self._rid = itertools.count()

    def _record_frame(self, recorder, s: int, n_arr: int,
                      done_now: List[FleetRequest], rejected_now: int,
                      trace: Trace, lat_ms: List[float], n_miss: int,
                      slo_ms: float) -> None:
        """One flight-recorder frame: per-engine state + the slice's
        admission outcomes + fleet-wide LUT-cache counters (schema:
        DESIGN.md SS.8), then the SLO trigger check on the running
        miss rate / p99."""
        reg = obs.metrics()
        engines = []
        for w in self.workers:
            rep = w.reports[-1] if w.reports else None
            engines.append({
                "wid": w.wid,
                "queue_depth": len(w.backlog),
                "n_done": rep.n_done if rep else 0,
                "placement": dict(rep.placement) if rep else {},
                "moved_weights": rep.moved_weights if rep else 0,
                "deadline_met": rep.deadline_met if rep else True,
                "forecast": round(w.forecaster.predict(), 3),
            })
        admitted = n_arr - rejected_now
        # running denominator = requests with a known outcome so far:
        # completed (lat_ms) + rejected (n_miss minus late completions)
        denom = len(lat_ms) + (n_miss - sum(x > slo_ms for x in lat_ms))
        miss_rate = (n_miss / denom) if denom else 0.0
        recorder.record(s, {
            "arrivals": n_arr,
            "admitted": admitted,
            "rejected": rejected_now,
            "completed": len(done_now),
            "engines": engines,
            "lut_cache": {"builds": reg.value("compiler.lut.build"),
                          "hits": reg.value("compiler.lut.hit"),
                          "sched_hits": reg.value("sched.lut.hit"),
                          "sched_misses": reg.value("sched.lut.miss")},
            "running": {"deadline_miss_rate": round(miss_rate, 4),
                        "p99_ms": _nearest_rank(lat_ms, 99)},
        })
        recorder.check(deadline_miss_rate=miss_rate,
                       p99_ms=_nearest_rank(lat_ms, 99),
                       context={"trace": trace.name, "slice": s,
                                "slo_ms": slo_ms})

    def run(self, trace: Trace, *, max_drain_slices: int = 200,
            verbose_cb=None) -> FleetResult:
        completed: List[FleetRequest] = []
        rejected: List[FleetRequest] = []
        s = 0
        n_slices = len(trace.arrivals)
        recorder = obs.flight_recorder()
        if obs.enabled():
            for w in self.workers:
                obs.tracer().name_track(w.wid, f"engine-{w.wid}")
            obs.instant("fleet.run", cat="fleet",
                        args={"trace": trace.name, "engines":
                              len(self.workers),
                              "policy": self.router.policy})
        # running SLO signals for the flight recorder: latency of every
        # completed request so far (ms) + misses incl. rejections
        slo_ms = self.slo_slices * self.workers[0].t_slice_ns / 1e6
        lat_ms: List[float] = []
        n_miss = 0
        while True:
            draining = s >= n_slices
            if draining and (all(not w.backlog for w in self.workers)
                             or s >= n_slices + max_drain_slices):
                break
            _obs = obs.enabled()
            _t0 = obs.now_ns() if _obs else 0
            # 1) execute the backlog buffered from earlier slices
            done_now: List[FleetRequest] = []
            for w in self.workers:
                done_now.extend(w.step(s))
            completed.extend(done_now)
            # 2) dispatch this slice's arrivals (executable next slice)
            n_arr = trace.arrivals[s] if not draining else 0
            rejected_now = 0
            for _ in range(n_arr):
                req = FleetRequest(rid=next(self._rid), arrival_slice=s,
                                   tokens=self.tokens_per_request)
                if not self.router.route(req):
                    rejected.append(req)
                    rejected_now += 1
            for w in self.workers:
                w.end_of_slice()
            if _obs:
                obs.complete("fleet.slice", _t0, cat="fleet",
                             args={"slice": s, "arrivals": n_arr,
                                   "done": len(done_now),
                                   "rejected": rejected_now,
                                   "backlog": sum(len(w.backlog)
                                                  for w in self.workers)})
            if recorder is not None:
                n_miss += rejected_now
                for r in done_now:
                    lat_ms.append(r.latency_ns / 1e6)
                    n_miss += r.latency_ns / 1e6 > slo_ms
                self._record_frame(recorder, s, n_arr, done_now,
                                   rejected_now, trace, lat_ms, n_miss,
                                   slo_ms)
            if verbose_cb is not None:
                verbose_cb(s, n_arr, done_now, self.workers)
            s += 1
        T = self.workers[0].t_slice_ns
        unfinished = [r for w in self.workers for r in w.backlog]
        if recorder is not None:
            # the drain cutoff strands backlog: that is an SLO event too
            n_miss += len(unfinished)
            n_sub = len(completed) + len(rejected) + len(unfinished)
            recorder.check(
                deadline_miss_rate=(n_miss / n_sub) if n_sub else 0.0,
                p99_ms=_nearest_rank(lat_ms, 99),
                context={"trace": trace.name, "phase": "end_of_run",
                         "slo_ms": slo_ms, "n_slices": s})
        return FleetResult(
            trace=trace.name, completed=completed, rejected=rejected,
            unfinished=unfinished,
            reports={w.wid: w.reports for w in self.workers},
            t_slice_ns=T, slo_ns=self.slo_slices * T, n_slices=s)
