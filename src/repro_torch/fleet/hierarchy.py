"""Two-level (cell -> engine) fleet: hierarchical routing + autoscaling.

The flat :class:`~repro_torch.fleet.router.FleetRouter` scores every engine for
every arrival - O(requests x engines log engines) - and tops out at a
handful of engines. This module scales the serving loop to hundreds ->
thousands of simulated engines by introducing the **cell** as the unit of
placement (after the heterogeneous data-centric survey, PAPERS.md): a
cell groups engines of ONE substrate variant behind an aggregate queue
model, the HH-PIM energy/latency trade (Eq. (1), DESIGN.md SS.3) is
decided per cell, and routing becomes two cheap decisions:

* **global tier** (:class:`CellRouter`): pick a cell by queue-aware
  scoring - expected queue wait (aggregate backlog over aggregate
  capacity, bias-corrected by an EWMA of realized waits from the same
  per-class queue-wait signal the ``fleet.queue_wait_slices``
  histograms record) as a fraction of the request class's SLO budget,
  plus a small energy/token term from the cell's LUT-backed placement.
  Admission control is wait-based per class: a request is admitted only
  into a cell whose expected completion latency fits its class budget,
  and the admission reason codes (``accept`` / ``defer`` /
  ``reject``) are stamped + counted exactly as in the flat router.
* **cell tier** (:meth:`Cell.dispatch`): pick an engine inside the
  chosen cell - least-loaded or join-shortest-queue.

:class:`CellAutoscaler` brings engine pools up/down per cell from
queue-depth and miss-rate signals with hysteresis (watermarks +
patience + cooldown). Scale-ups first unpark previously parked engines
and otherwise build new workers through the fleet's shared
:class:`~repro_torch.core.compiler.PlacementCompiler` - the variant's LUT was
compiled at bring-up (or loaded via ``save()``/``load()`` warm start),
so a scale-up costs **zero** LUT builds; every :class:`ScaleEvent`
records the builds it actually paid so benches and CI can assert that.

Construct through :func:`repro_torch.api.hierarchical_fleet`; the run loop,
latency accounting and result schema match :class:`~repro_torch.fleet.router.
Fleet` so :func:`repro_torch.fleet.metrics.summarize` applies unchanged.
See DESIGN.md SS.9.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fleet.router import (ADMIT_ACCEPT, ADMIT_DEFER,
                                      ADMIT_REJECT, EngineWorker,
                                      FleetRequest, FleetResult,
                                      _nearest_rank)
from repro_torch.fleet.traces import Trace

CELL_POLICIES = ("least_loaded", "jsq")

#: admission reject reason emitted by the wait-based global tier
#: (complements the flat router's "all_queues_full"; DESIGN.md SS.8/SS.9)
REASON_BUDGET = "slo_budget_exhausted"

#: EWMA weight of the realized-vs-predicted wait correction
_BIAS_ALPHA = 0.2
#: slices of completion history feeding the autoscaler miss signal
_MISS_WINDOW = 8


class Cell:
    """Engines of one substrate variant behind an aggregate queue model.

    The cell maintains an incrementally-updated aggregate backlog and a
    once-per-slice capacity estimate, so the global tier scores a cell in
    O(1) instead of touching its engines. Realized queue waits feed an
    EWMA bias correction (``_wait_bias``) and a per-cell wait histogram
    on the ``WAIT_SLICE_BUCKETS`` grid.
    """

    def __init__(self, cid: int, workers: Sequence[EngineWorker], *,
                 substrate=None, tokens_per_task: int = 8):
        if not workers:
            raise ValueError(f"cell {cid} needs at least one engine")
        self.cid = cid
        self.workers = list(workers)          # active engines
        self.parked: List[EngineWorker] = []  # scaled-down, warm
        self.substrate = substrate
        self.tokens_per_task = tokens_per_task
        self.backlog = 0                      # aggregate queued tasks
        self.wait_hist = obs.Histogram(obs.WAIT_SLICE_BUCKETS)
        self._wait_bias = 0.0
        self._cap_engine = 1.0                # tasks/slice of one engine
        self._energy_norm = 0.0               # set by CellRouter.refresh
        # (n_done, n_missed_budget) per recent slice -> miss signal
        self._recent: collections.deque = collections.deque(
            maxlen=_MISS_WINDOW)
        self.refresh()

    # -- aggregate queue model ---------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self.workers)

    @property
    def t_slice_ns(self) -> float:
        return self.workers[0].t_slice_ns

    def refresh(self) -> None:
        """Once per slice: re-estimate per-engine capacity and the
        energy/token of the cell's current placement (both move only
        when a placement changes)."""
        T = self.t_slice_ns
        ts = [w.t_task_est_ns() for w in self.workers]
        mean_t = sum(ts) / len(ts)
        self._cap_engine = T / mean_t if mean_t > 0 else float("inf")
        em = self.workers[0].sched.em
        cost = em.task_cost(self.workers[0].sched.placement)
        self.energy_per_token_pj = (cost.e_dyn_task_pj
                                    / max(self.tokens_per_task, 1))

    def expected_wait_slices(self, extra: int = 1) -> float:
        """Slices a newly admitted request expects to queue, from the
        aggregate backlog spread over the active engines, corrected by
        the EWMA of realized-minus-predicted waits."""
        if not math.isfinite(self._cap_engine):
            return self._wait_bias
        per_engine = (self.backlog + extra) / self.n_active
        return max(per_engine / self._cap_engine + self._wait_bias, 0.0)

    def expected_latency_slices(self, extra: int = 1) -> float:
        """Expected completion latency in slices: arrivals buffer one
        slice before executing (the paper's <= 2T discipline), then wait
        out the queue ahead of them."""
        return 1.0 + self.expected_wait_slices(extra)

    def recent_miss_rate(self) -> float:
        done = sum(d for d, _ in self._recent)
        missed = sum(m for _, m in self._recent)
        return missed / done if done else 0.0

    # -- cell tier: engine selection ---------------------------------------
    def dispatch(self, req: FleetRequest, policy: str = "least_loaded"
                 ) -> None:
        """Second routing tier: enqueue on the least-loaded (queue
        length) or shortest-expected-wait (jsq) engine of this cell."""
        if policy == "jsq":
            w = min(self.workers,
                    key=lambda w: (w.expected_wait_slices(1), w.wid))
        else:
            w = min(self.workers, key=lambda w: (len(w.backlog), w.wid))
        req.cell = self.cid
        w.enqueue(req)
        self.backlog += 1

    # -- per-slice protocol ------------------------------------------------
    def step(self, slice_idx: int, budget_slices: Callable[[str], float]
             ) -> List[FleetRequest]:
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        done: List[FleetRequest] = []
        for w in self.workers:
            done.extend(w.step(slice_idx))
        self.backlog = sum(len(w.backlog) for w in self.workers)
        n_missed = 0
        for r in done:
            wait = r.finish_slice - r.arrival_slice - 1
            self.wait_hist.observe(wait)
            if r.wait_est is not None:
                self._wait_bias += _BIAS_ALPHA * (
                    wait - r.wait_est - self._wait_bias)
            lat_slices = r.latency_ns / self.t_slice_ns
            n_missed += lat_slices > budget_slices(r.slo_class)
        self._recent.append((len(done), n_missed))
        if _obs:
            obs.complete("cell.step", _t0, cat="fleet", tid=self.cid,
                         args={"cell": self.cid, "engines": self.n_active,
                               "backlog": self.backlog,
                               "n_done": len(done)})
        return done

    def end_of_slice(self) -> None:
        for w in self.workers:
            w.end_of_slice()

    # -- scaling hooks (CellAutoscaler) ------------------------------------
    def park_one(self) -> bool:
        """Scale down by one engine: park the emptiest ACTIVE engine.
        Only engines with a drained backlog park (no request stranding);
        returns False when none qualifies or one engine would remain."""
        if self.n_active <= 1:
            return False
        idle = [w for w in self.workers if not w.backlog]
        if not idle:
            return False
        w = min(idle, key=lambda w: -w.wid)    # newest engine first
        self.workers.remove(w)
        self.parked.append(w)
        return True

    def unpark_one(self) -> bool:
        if not self.parked:
            return False
        self.workers.append(self.parked.pop())
        return True

    def add_worker(self, w: EngineWorker) -> None:
        self.workers.append(w)

    def all_workers(self) -> List[EngineWorker]:
        return self.workers + self.parked


class CellRouter:
    """Global routing tier: queue-aware cell scoring with per-class SLO
    budgets and wait-based admission.

    Score = (expected completion latency / class budget)
          + ``energy_weight`` x (cell energy/token, min-max normalized
            across cells each slice). The request is admitted into the
    best-scoring cell whose expected latency fits its class budget
    (times ``admit_headroom``); if the top-scoring cell does not fit but
    a later one does, the outcome is ``defer`` (reason
    ``preferred_over_budget``); if none fits, ``reject`` (reason
    ``slo_budget_exhausted``). Admission outcomes reuse the flat
    router's reason-code schema (DESIGN.md SS.8)."""

    def __init__(self, cells: Sequence[Cell], *,
                 budgets: Optional[Dict[str, float]] = None,
                 slo_slices: float = 2.0,
                 energy_weight: float = 0.05,
                 admit_headroom: float = 1.0,
                 cell_policy: str = "least_loaded"):
        if not cells:
            raise ValueError("router needs at least one cell")
        if cell_policy not in CELL_POLICIES:
            raise ValueError(f"unknown cell policy {cell_policy!r}; "
                             f"one of {CELL_POLICIES}")
        self.cells = list(cells)
        self.budgets = dict(budgets or {})
        self.budgets.setdefault("default", slo_slices)
        self.energy_weight = energy_weight
        self.admit_headroom = admit_headroom
        self.cell_policy = cell_policy

    def budget(self, slo_class: str) -> float:
        """SLO budget of a class, in slices. Unknown classes raise a
        shaped error naming the class and listing the registered set -
        classes are registered via ``budgets=`` (or inherited from
        ``class_mix=`` at fleet construction); there is no silent
        default fallback."""
        try:
            return self.budgets[slo_class]
        except KeyError:
            raise ValueError(
                f"unknown SLO class {slo_class!r}; registered: "
                f"{sorted(self.budgets)} (register it via budgets= or "
                f"class_mix=)") from None

    def refresh(self) -> None:
        """Once per slice: refresh every cell's capacity/energy estimate
        and min-max normalize energy/token across cells (the relative
        term the score uses; degenerate spread -> 0 for all)."""
        for c in self.cells:
            c.refresh()
        es = [c.energy_per_token_pj for c in self.cells]
        lo, hi = min(es), max(es)
        spread = hi - lo
        for c in self.cells:
            c._energy_norm = ((c.energy_per_token_pj - lo) / spread
                              if spread > 0 else 0.0)

    def route(self, req: FleetRequest) -> bool:
        """Two-level dispatch; False => rejected by wait-based admission.
        Backlogs update as requests enqueue, so scores stay fresh within
        a slice."""
        b = self.budget(req.slo_class)
        scored = sorted(
            ((c.expected_latency_slices(1) / b
              + self.energy_weight * c._energy_norm,
              c.expected_latency_slices(1), c) for c in self.cells),
            key=lambda t: (t[0], t[2].cid))
        limit = b * self.admit_headroom
        for rank, (_, lat, c) in enumerate(scored):
            if lat <= limit:
                req.admission = ADMIT_ACCEPT if rank == 0 else ADMIT_DEFER
                req.wait_est = lat - 1.0
                if obs.enabled():
                    reason = ("ok" if rank == 0 else "preferred_over_budget")
                    obs.counter("fleet.admission", decision=req.admission,
                                reason=reason, cls=req.slo_class,
                                tenant=req.tenant)
                    obs.counter("cell.dispatch", cell=c.cid)
                c.dispatch(req, self.cell_policy)
                return True
        req.rejected = True
        req.admission = ADMIT_REJECT
        if obs.enabled():
            obs.counter("fleet.admission", decision=ADMIT_REJECT,
                        reason=REASON_BUDGET, cls=req.slo_class,
                        tenant=req.tenant)
            obs.instant("fleet.reject", cat="fleet",
                        args={"rid": req.rid, "reason": REASON_BUDGET,
                              "cls": req.slo_class, "tenant": req.tenant,
                              "budget": b})
        return False


@dataclasses.dataclass
class ScaleEvent:
    """One autoscaler action: the LUT builds the event paid is the
    warm-start audit trail (scale-ups must report 0)."""
    slice_idx: int
    cell: int
    direction: str                # "up" | "down"
    n_engines: int                # active engines AFTER the event
    lut_builds: int = 0
    unparked: bool = False        # reused a parked engine (no new build)


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Hysteresis state machine knobs (DESIGN.md SS.9): a cell scales up
    after ``patience`` consecutive slices above ``up_wait`` expected
    queue wait (or above ``up_miss`` recent budget-miss rate), scales
    down after ``patience`` consecutive slices below ``down_wait`` with
    an idle engine to park, and after any event ignores both signals for
    ``cooldown`` slices. ``up_wait > down_wait`` + patience + cooldown
    is what prevents flapping on a step load."""
    min_engines: int = 1
    max_engines: int = 8
    # wait-based admission clamps a saturated cell's expected wait near
    # (budget - 1) slices, so the high watermark sits BELOW 1.0: a cell
    # pinned at its admission ceiling reads as hot, not as healthy
    up_wait: float = 0.75         # slices; scale-up high watermark
    down_wait: float = 0.15       # slices; scale-down low watermark
    up_miss: float = 0.25         # recent budget-miss-rate trigger
    patience: int = 2             # consecutive slices before acting
    cooldown: int = 2             # slices to hold after an event


class CellAutoscaler:
    """Per-cell engine-pool scaling from queue-depth + miss signals.

    ``worker_factory(cell)`` builds one new :class:`EngineWorker` for a
    cell through the fleet's shared placement compiler; the autoscaler
    measures the compiler builds each scale-up actually paid (0 when the
    variant's LUT is warm) and records them on the :class:`ScaleEvent`.
    """

    def __init__(self, cfg: AutoscaleConfig,
                 worker_factory: Callable[[Cell], EngineWorker],
                 compiler=None):
        self.cfg = cfg
        self.worker_factory = worker_factory
        self.compiler = compiler
        self._hot: Dict[int, int] = {}       # cid -> consecutive hot slices
        self._cold: Dict[int, int] = {}
        self._hold: Dict[int, int] = {}      # cid -> cooldown remaining
        self.events: List[ScaleEvent] = []

    def _builds(self) -> int:
        return self.compiler.n_builds if self.compiler is not None else 0

    def _scale_up(self, slice_idx: int, cell: Cell) -> ScaleEvent:
        b0 = self._builds()
        unparked = cell.unpark_one()
        if not unparked:
            w = self.worker_factory(cell)
            w.sched.lut          # force the LUT now: builds land on event
            cell.add_worker(w)
        ev = ScaleEvent(slice_idx=slice_idx, cell=cell.cid, direction="up",
                        n_engines=cell.n_active,
                        lut_builds=self._builds() - b0, unparked=unparked)
        return ev

    def observe(self, slice_idx: int, cells: Sequence[Cell]
                ) -> List[ScaleEvent]:
        """Run one autoscaling round over the cells; returns the events
        applied this slice (new engines serve from the next slice)."""
        fired: List[ScaleEvent] = []
        cfg = self.cfg
        for cell in cells:
            cid = cell.cid
            if self._hold.get(cid, 0) > 0:
                self._hold[cid] -= 1
                continue
            wait = cell.expected_wait_slices(0)
            hot = wait > cfg.up_wait or cell.recent_miss_rate() > cfg.up_miss
            cold = wait < cfg.down_wait
            self._hot[cid] = self._hot.get(cid, 0) + 1 if hot else 0
            self._cold[cid] = self._cold.get(cid, 0) + 1 if cold else 0
            ev = None
            if (self._hot[cid] >= cfg.patience
                    and cell.n_active < cfg.max_engines):
                ev = self._scale_up(slice_idx, cell)
            elif (self._cold[cid] >= cfg.patience
                    and cell.n_active > cfg.min_engines
                    and cell.park_one()):
                ev = ScaleEvent(slice_idx=slice_idx, cell=cid,
                                direction="down", n_engines=cell.n_active)
            if ev is not None:
                fired.append(ev)
                self.events.append(ev)
                self._hot[cid] = self._cold[cid] = 0
                self._hold[cid] = cfg.cooldown
                obs.metrics().counter("fleet.autoscale",
                                      direction=ev.direction)
                if obs.enabled():
                    obs.instant("fleet.scale", cat="fleet",
                                args=dataclasses.asdict(ev))
        return fired


@dataclasses.dataclass
class HierarchyResult:
    """A :class:`~repro_torch.fleet.router.FleetResult` (so ``summarize()``
    applies unchanged) plus the hierarchy's own audit trail."""
    result: FleetResult
    scale_events: List[ScaleEvent]
    n_engines_start: int
    n_engines_peak: int
    n_engines_end: int
    #: (rid, cell, wid) per admitted request, in admission order - the
    #: determinism contract: same trace + seed => identical sequence
    assignments: List[Tuple[int, int, int]]

    @property
    def scale_up_builds(self) -> int:
        return sum(e.lut_builds for e in self.scale_events
                   if e.direction == "up")

    @property
    def n_scale_ups(self) -> int:
        return sum(e.direction == "up" for e in self.scale_events)

    @property
    def n_scale_downs(self) -> int:
        return sum(e.direction == "down" for e in self.scale_events)


class HierarchicalFleet:
    """Trace-driven two-level serving loop over cells of engines.

    Mirrors :meth:`repro_torch.fleet.router.Fleet.run` - same buffering
    discipline, latency stamping, drain semantics and flight-recorder
    triggers - with per-CELL flight frames (hundreds of engines would
    blow up per-engine frames) and an optional :class:`CellAutoscaler`
    run each slice. ``class_mix`` assigns SLO classes to arrivals from a
    seeded RNG, so runs are deterministic per (trace, seed)."""

    def __init__(self, cells: Sequence[Cell], *,
                 budgets: Optional[Dict[str, float]] = None,
                 class_mix: Optional[Dict[str, float]] = None,
                 slo_slices: float = 2.0,
                 tokens_per_request: int = 8,
                 autoscaler: Optional[CellAutoscaler] = None,
                 cell_policy: str = "least_loaded",
                 energy_weight: float = 0.05,
                 admit_headroom: float = 1.0,
                 seed: int = 0):
        if not cells:
            raise ValueError("hierarchical fleet needs at least one cell")
        self.cells = list(cells)
        self.router = CellRouter(self.cells, budgets=budgets,
                                 slo_slices=slo_slices,
                                 energy_weight=energy_weight,
                                 admit_headroom=admit_headroom,
                                 cell_policy=cell_policy)
        self.slo_slices = slo_slices
        self.tokens_per_request = tokens_per_request
        self.autoscaler = autoscaler
        self.seed = seed
        if class_mix:
            total = sum(class_mix.values())
            self._classes = sorted(class_mix)
            self._probs = [class_mix[c] / total for c in self._classes]
            # classes the mix generates without an explicit budget
            # inherit the default one (budget() itself never falls back)
            for c in self._classes:
                self.router.budgets.setdefault(c, slo_slices)
        else:
            self._classes = ["default"]
            self._probs = [1.0]
        self._rid = itertools.count()

    @property
    def workers(self) -> List[EngineWorker]:
        """Every engine ever part of the fleet (active + parked), in wid
        order - the accounting surface for reports/energy."""
        ws = [w for c in self.cells for w in c.all_workers()]
        return sorted(ws, key=lambda w: w.wid)

    @property
    def n_engines(self) -> int:
        return sum(c.n_active for c in self.cells)

    def _cell_states(self) -> List[Dict]:
        """Per-cell aggregate state for a flight frame (shared by the
        plain and DAG run loops; schema: DESIGN.md SS.9)."""
        return [{
            "cell": c.cid,
            "engines": c.n_active,
            "parked": len(c.parked),
            "queue_depth": c.backlog,
            "expected_wait": round(c.expected_wait_slices(0), 3),
            "capacity_per_engine": round(c._cap_engine, 2),
            "recent_miss_rate": round(c.recent_miss_rate(), 4),
        } for c in self.cells]

    def _record_frame(self, recorder, s: int, n_arr: int, done_n: int,
                      rejected_now: int, scaled: List[ScaleEvent],
                      trace: Trace, lat_ms: List[float], n_miss: int,
                      slo_ms: float) -> None:
        """Flight frame with per-cell aggregates (schema: DESIGN.md SS.9;
        the flat fleet's per-engine form is SS.8)."""
        reg = obs.metrics()
        cells = self._cell_states()
        denom = len(lat_ms) + (n_miss - sum(x > slo_ms for x in lat_ms))
        miss_rate = (n_miss / denom) if denom else 0.0
        recorder.record(s, {
            "arrivals": n_arr,
            "admitted": n_arr - rejected_now,
            "rejected": rejected_now,
            "completed": done_n,
            "cells": cells,
            "scale_events": [dataclasses.asdict(e) for e in scaled],
            "lut_cache": {"builds": reg.value("compiler.lut.build"),
                          "hits": reg.value("compiler.lut.hit")},
            "running": {"deadline_miss_rate": round(miss_rate, 4),
                        "p99_ms": _nearest_rank(lat_ms, 99)},
        })
        recorder.check(deadline_miss_rate=miss_rate,
                       p99_ms=_nearest_rank(lat_ms, 99),
                       context={"trace": trace.name, "slice": s,
                                "slo_ms": slo_ms, "hierarchy": True})

    def run(self, trace: Trace, *, max_drain_slices: int = 200,
            verbose_cb=None) -> HierarchyResult:
        rng = np.random.default_rng(self.seed)
        completed: List[FleetRequest] = []
        rejected: List[FleetRequest] = []
        assignments: List[Tuple[int, int, int]] = []
        n_start = self.n_engines
        n_peak = n_start
        recorder = obs.flight_recorder()
        if obs.enabled():
            for c in self.cells:
                obs.tracer().name_track(c.cid, f"cell-{c.cid}")
            obs.instant("fleet.run", cat="fleet",
                        args={"trace": trace.name, "cells": len(self.cells),
                              "engines": n_start, "hierarchy": True,
                              "autoscale": self.autoscaler is not None})
        slo_ms = self.slo_slices * self.cells[0].t_slice_ns / 1e6
        lat_ms: List[float] = []
        n_miss = 0
        s = 0
        n_slices = len(trace.arrivals)
        while True:
            draining = s >= n_slices
            if draining and (all(c.backlog == 0 for c in self.cells)
                             or s >= n_slices + max_drain_slices):
                break
            _obs = obs.enabled()
            _t0 = obs.now_ns() if _obs else 0
            self.router.refresh()
            # 1) execute backlog buffered from earlier slices
            done_now: List[FleetRequest] = []
            for c in self.cells:
                done_now.extend(c.step(s, self.router.budget))
            completed.extend(done_now)
            # 2) two-level dispatch of this slice's arrivals
            n_arr = trace.arrivals[s] if not draining else 0
            rejected_now = 0
            for _ in range(n_arr):
                cls = (self._classes[0] if len(self._classes) == 1 else
                       self._classes[int(rng.choice(len(self._classes),
                                                    p=self._probs))])
                req = FleetRequest(rid=next(self._rid), arrival_slice=s,
                                   tokens=self.tokens_per_request,
                                   slo_class=cls)
                if self.router.route(req):
                    assignments.append((req.rid, req.cell, req.worker))
                else:
                    rejected.append(req)
                    rejected_now += 1
            # 3) autoscaling acts on post-dispatch queues; new engines
            #    serve from the next slice
            scaled: List[ScaleEvent] = []
            if self.autoscaler is not None and not draining:
                scaled = self.autoscaler.observe(s, self.cells)
                n_peak = max(n_peak, self.n_engines)
            for c in self.cells:
                c.end_of_slice()
            if _obs:
                obs.complete("fleet.slice", _t0, cat="fleet",
                             args={"slice": s, "arrivals": n_arr,
                                   "done": len(done_now),
                                   "rejected": rejected_now,
                                   "engines": self.n_engines,
                                   "backlog": sum(c.backlog
                                                  for c in self.cells)})
            if recorder is not None:
                n_miss += rejected_now
                for r in done_now:
                    lat_ms.append(r.latency_ns / 1e6)
                    n_miss += r.latency_ns / 1e6 > slo_ms
                self._record_frame(recorder, s, n_arr, len(done_now),
                                   rejected_now, scaled, trace, lat_ms,
                                   n_miss, slo_ms)
            if verbose_cb is not None:
                verbose_cb(s, n_arr, done_now, self.cells)
            s += 1
        workers = self.workers
        T = self.cells[0].t_slice_ns
        unfinished = [r for w in workers for r in w.backlog]
        if recorder is not None:
            n_miss += len(unfinished)
            n_sub = len(completed) + len(rejected) + len(unfinished)
            recorder.check(
                deadline_miss_rate=(n_miss / n_sub) if n_sub else 0.0,
                p99_ms=_nearest_rank(lat_ms, 99),
                context={"trace": trace.name, "phase": "end_of_run",
                         "slo_ms": slo_ms, "n_slices": s,
                         "hierarchy": True})
        result = FleetResult(
            trace=trace.name, completed=completed, rejected=rejected,
            unfinished=unfinished,
            reports={w.wid: w.reports for w in workers},
            t_slice_ns=T, slo_ns=self.slo_slices * T, n_slices=s)
        return HierarchyResult(
            result=result,
            scale_events=(self.autoscaler.events
                          if self.autoscaler is not None else []),
            n_engines_start=n_start, n_engines_peak=n_peak,
            n_engines_end=self.n_engines, assignments=assignments)
