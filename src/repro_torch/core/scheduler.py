"""Time-slice scheduler: the runtime half of the paper's SS.III strategy.

Tasks generated during slice ``s-1`` are buffered and must complete inside
slice ``s`` (operational latency <= 2T). Per slice the scheduler derives
``t_constraint = (T - movement_overhead) / n_tasks``, consults the placement
LUT, migrates weights if the optimum changed, and executes the backlog.

The same class doubles as the straggler-mitigation feedback loop of the
TPU-serving adaptation: an observed per-cluster slowdown factor rescales the
effective per-weight times before lookup, so a degraded pool automatically
receives a smaller shard next slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch import obs
from repro_torch.core import spaces as sp
from repro_torch.core.compiler import slowdown_signature
from repro_torch.core.energy import EnergyModel, Placement
from repro_torch.core.placement import PlacementLUT
from repro_torch.core.solvers import PlacementSolver, make_solver


@dataclasses.dataclass
class SliceReport:
    slice_idx: int
    n_tasks: int
    t_constraint_ns: float
    placement: Placement
    moved_weights: int
    t_move_ns: float
    e_move_pj: float
    t_exec_ns: float             # n_executed * t_task
    e_dyn_pj: float
    e_static_pj: float
    deadline_met: bool
    # tasks actually run this slice; < n_tasks only under capacity capping
    # (fleet serving), where the remainder carries over to the next slice.
    n_executed: Optional[int] = None
    # DVFS clock the online controller chose for this slice; None when
    # the scheduler runs at a static operating point (no controller).
    clock: Optional[float] = None

    @property
    def n_done(self) -> int:
        return self.n_tasks if self.n_executed is None else self.n_executed

    @property
    def t_task_ns(self) -> float:
        return self.t_exec_ns / self.n_done if self.n_done else 0.0

    @property
    def energy_pj(self) -> float:
        return self.e_dyn_pj + self.e_static_pj + self.e_move_pj


class TimeSliceScheduler:
    def __init__(self, *args, **kw):
        # The PR 2 keyword-threaded constructor finished its one-release
        # deprecation window and is gone.
        raise TypeError(
            "direct TimeSliceScheduler(arch, model, ...) construction was "
            "removed; build through repro_torch.api.scheduler(substrate_name, "
            "...) or TimeSliceScheduler.from_substrate(substrate, ...) "
            "(DESIGN.md SS.5)")

    @classmethod
    def from_substrate(cls, substrate, workload=None, *,
                       t_slice_ns: Optional[float] = None,
                       rho: Optional[float] = None,
                       solver=None,
                       lut: Optional[PlacementLUT] = None,
                       initial_placement: Optional[Placement] = None,
                       lut_points: Optional[int] = None,
                       compiler=None, dvfs=None) -> "TimeSliceScheduler":
        """Canonical constructor: resolve everything from a
        :class:`~repro_torch.core.substrate.Substrate` (duck-typed), letting
        callers override slice length, reuse factor, solver and LUT.
        A shared :class:`~repro_torch.core.compiler.PlacementCompiler` makes
        LUT (re)builds - including straggler-rescaling rebuilds - hit a
        fleet-wide cache instead of this engine's private one.

        ``dvfs`` attaches the online DVFS controller (DESIGN.md SS.10):
        ``True`` solves over the substrate TechModel's default clock
        grid, an int sets the grid size, a sequence gives explicit clock
        points, and a prebuilt
        :class:`~repro_torch.core.techmodel.DVFSController` is shared as-is
        (fleet workers of one shape share one controller). Each slice
        then picks the energy-minimal (placement, clock) pair instead of
        running at the substrate's static ``lp_clock``."""
        model = substrate.model_spec(workload)
        rho = substrate.rho if rho is None else rho
        if t_slice_ns is None:
            t_slice_ns = substrate.default_t_slice_ns(model, rho=rho)
        sol = make_solver(solver or substrate.solver)
        self = cls.__new__(cls)
        self._setup(substrate.arch, model, t_slice_ns=t_slice_ns, rho=rho,
                    lut=lut, initial_placement=initial_placement,
                    lut_points=(substrate.lut_points if lut_points is None
                                else lut_points),
                    solver=sol,
                    static_window=getattr(substrate, "static_window",
                                          "t_constraint"),
                    compiler=compiler,
                    variant_key=substrate.variant_key())
        if dvfs is not None and dvfs is not False:
            from repro_torch.core.techmodel import DVFSController
            if isinstance(dvfs, DVFSController):
                ctrl = dvfs
            else:
                kw = {}
                if isinstance(dvfs, int) and not isinstance(dvfs, bool):
                    kw["n_clocks"] = dvfs
                elif not isinstance(dvfs, bool):
                    kw["clocks"] = tuple(dvfs)
                ctrl = DVFSController(
                    substrate, model, t_slice_ns=self.t_slice_ns, rho=rho,
                    solver=sol, lut_points=self.lut_points,
                    compiler=compiler, **kw)
                ctrl.prepare()
            self.dvfs = ctrl
        return self

    def _setup(self, arch: sp.PIMArch, model: sp.ModelSpec, *,
               t_slice_ns: float, rho: float,
               lut: Optional[PlacementLUT],
               initial_placement: Optional[Placement],
               lut_points: int,
               solver: Optional[PlacementSolver] = None,
               static_window: str = "t_constraint",
               compiler=None, variant_key: Optional[tuple] = None) -> None:
        self.arch = arch
        self.model = model
        self.t_slice_ns = float(t_slice_ns)
        self.rho = rho
        self.lut_points = lut_points
        self.static_window = static_window
        self.compiler = compiler
        self.variant_key = variant_key or (arch.name,)
        self.solver = solver if solver is not None \
            else make_solver("closed-form")
        # online DVFS controller (repro_torch.core.techmodel); None = static
        # operating point. Attached by from_substrate(dvfs=...) or by
        # api.fleet, which shares one controller per engine shape.
        self.dvfs = None
        self.em = EnergyModel(arch, model, rho=rho)
        # slowdown must exist before the cache prime: the lut property
        # looks the cache up under the populated slowdown signature.
        self.slowdown: Dict[str, float] = {c.name: 1.0
                                           for c in self.arch.clusters}
        self._lut_cache: Dict[tuple, PlacementLUT] = {}
        if lut is not None:
            self._lut_cache[self._slowdown_key()] = lut
        if initial_placement is None:
            initial_placement = self.solver.initial_placement(self.em)
        self.placement: Placement = dict(
            initial_placement or self.em.peak_placement(sram_only=True))
        self._idx = 0

    # -- straggler feedback ------------------------------------------------
    def observe_slowdown(self, cluster: str, factor: float) -> None:
        """Report that `cluster` currently runs `factor`x slower than spec.

        The next slice re-solves placement against the degraded timing model
        (LUT rebuilt and cached per slowdown signature), so the straggling
        pool automatically receives a smaller weight shard.
        """
        if factor < 1.0:
            raise ValueError("slowdown factor must be >= 1")
        self.slowdown[cluster] = float(factor)
        self.em = EnergyModel(self.arch, self.model, rho=self.rho,
                              time_scale=self.slowdown)

    def _slowdown_key(self) -> tuple:
        # shared helper: must stay keyed identically to the compiler's
        # cache for straggler rebuilds to hit the fleet-wide entry
        return slowdown_signature(getattr(self, "slowdown", {}))

    @property
    def lut(self) -> PlacementLUT:
        key = self._slowdown_key()
        if key not in self._lut_cache:
            if obs.enabled():
                obs.counter("sched.lut.miss")
            if self.compiler is not None:
                # fleet-wide build service: engines of the same shape and
                # slowdown signature share one build
                self._lut_cache[key] = self.compiler.lut(
                    self.em, solver=self.solver,
                    t_slice_ns=self.t_slice_ns, n_points=self.lut_points,
                    static_window=self.static_window,
                    variant_key=self.variant_key)
            else:
                with obs.span("sched.lut_build", "scheduler",
                              arch=self.arch.name, solver=self.solver.name,
                              n_points=self.lut_points):
                    self._lut_cache[key] = self.solver.build_lut(
                        self.em, t_slice_ns=self.t_slice_ns,
                        n_points=self.lut_points,
                        static_window=self.static_window)
        elif obs.enabled():
            obs.counter("sched.lut.hit")
        return self._lut_cache[key]

    def stage_cost(self, n_tasks: int) -> "tuple[float, float]":
        """Read-only LUT consultation for stage co-scheduling
        (:mod:`repro_torch.fleet.dag`): the ``(t_task_ns, e_dyn_task_pj)``
        this engine would pay per task if ``n_tasks`` were due in one
        slice. Shares :attr:`lut` (the SS.6 variant-key cache), so the
        query costs zero builds beyond the engine's own LUT and never
        mutates scheduler state (no migration, no report)."""
        entry = self.lut.lookup(self.t_slice_ns / max(n_tasks, 1))
        cost = self.em.task_cost(entry.placement)
        return cost.t_task_ns, cost.e_dyn_task_pj

    # -- one slice ----------------------------------------------------------
    def step(self, n_tasks: int, *, lookup_tasks: Optional[int] = None,
             cap_to_capacity: bool = False) -> SliceReport:
        """Execute one time slice with ``n_tasks`` buffered tasks.

        ``lookup_tasks`` (fleet forecasting hook): consult the placement LUT
        as if this many tasks were due, instead of the actual backlog. A
        forecaster predicting next-slice load can thereby trigger *proactive*
        weight migration during a quiet slice, before the burst lands.

        ``cap_to_capacity``: execute only as many tasks as fit inside the
        slice under the chosen placement (``n_executed`` in the report); the
        caller carries the remainder into the next slice. Default keeps the
        paper semantics (whole backlog runs, deadline possibly missed).
        """
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        T = self.t_slice_ns
        n_plan = max(lookup_tasks if lookup_tasks is not None else n_tasks, 1)
        clock = None
        if self.dvfs is not None:
            # online DVFS: the controller picks the energy-minimal
            # (placement, clock) grid point for this slice's plan; the
            # slice then runs entirely under that point's physics.
            clock, em, lut, _ = self.dvfs.select(n_plan,
                                                 slowdown=self.slowdown)
        else:
            em = self.em
            lut = self.lut

        # pass 1: ignore movement; pass 2: subtract its overhead (paper:
        # "the calculation of t_constraint at runtime incorporates the data
        # movement overhead").
        entry = lut.lookup(T / n_plan)
        t_move_c, e_move = em.movement_cost(self.placement,
                                            entry.placement)
        t_move = max(t_move_c.values(), default=0.0)
        if t_move > 0:
            entry2 = lut.lookup(max(T - t_move, 0.0) / n_plan)
            t_move_c2, e_move2 = em.movement_cost(self.placement,
                                                  entry2.placement)
            t_move2 = max(t_move_c2.values(), default=0.0)
            if n_plan * entry2.t_task_ns + t_move2 <= T + 1e-9:
                entry, t_move, e_move = entry2, t_move2, e_move2
            # if even the refined choice cannot absorb the migration this
            # slice, keep the current placement when it meets the deadline
            # on its own ("no inference delay due to data movement").
            elif (n_plan * em.task_cost(self.placement).t_task_ns
                  <= T + 1e-9):
                entry = None

        if entry is None:
            new_placement = dict(self.placement)
            t_move, e_move = 0.0, 0.0
        else:
            new_placement = dict(entry.placement)
        moved = sum(max(0, new_placement.get(k, 0) - self.placement.get(k, 0))
                    for k in {*new_placement, *self.placement})

        cost = em.task_cost(new_placement)
        n_run = n_tasks
        if cap_to_capacity and cost.t_task_ns > 0:
            capacity = int((T - t_move + 1e-6) // cost.t_task_ns)
            n_run = min(n_tasks, max(capacity, 0))
        t_exec = n_run * cost.t_task_ns
        busy = {c: t * n_run for c, t in cost.t_cluster_ns.items()}
        e_dyn = n_run * cost.e_dyn_task_pj
        e_static = em.static_energy_pj(new_placement, T, busy)
        deadline_met = (n_tasks * cost.t_task_ns + t_move) <= T + 1e-6

        # t_constraint reflects the load the LUT was actually consulted
        # with (the forecast under lookup_tasks), so reports explain the
        # recorded placement
        rep = SliceReport(self._idx, n_tasks, T / n_plan,
                          new_placement, moved, t_move, e_move, t_exec,
                          e_dyn, e_static, deadline_met, n_executed=n_run,
                          clock=clock)
        self.placement = new_placement
        self._idx += 1
        if _obs:
            if clock is not None:
                obs.gauge("sched.dvfs.clock", clock)
            # the slice span carries the full SliceReport so a Perfetto
            # timeline attributes every missed deadline to its placement
            obs.complete("sched.slice", _t0, cat="scheduler", args={
                "slice": rep.slice_idx, "n_tasks": n_tasks,
                "n_executed": n_run, "lookup_tasks": n_plan,
                "t_constraint_ns": rep.t_constraint_ns,
                "t_move_ns": t_move, "t_exec_ns": t_exec,
                "moved_weights": moved, "e_dyn_pj": e_dyn,
                "e_static_pj": e_static, "e_move_pj": e_move,
                "deadline_met": deadline_met, "clock": clock,
                "placement": dict(new_placement)})
            if moved:
                obs.instant("sched.migration", cat="scheduler",
                            args={"slice": rep.slice_idx,
                                  "moved_weights": moved,
                                  "t_move_ns": t_move})
        return rep

    def run(self, tasks_per_slice: List[int]) -> List[SliceReport]:
        return [self.step(n) for n in tasks_per_slice]


class FixedPlacementScheduler:
    """Comparison-group runtime: placement never changes (Baseline-,
    Heterogeneous- and Hybrid-PIM in Table I)."""

    def __init__(self, arch: sp.PIMArch, model: sp.ModelSpec, *,
                 t_slice_ns: float, placement: Placement, rho: float = 1.0):
        self.arch = arch
        self.model = model
        self.t_slice_ns = float(t_slice_ns)
        self.em = EnergyModel(arch, model, rho=rho)
        self.placement = dict(placement)
        self._idx = 0

    def step(self, n_tasks: int) -> SliceReport:
        T = self.t_slice_ns
        cost = self.em.task_cost(self.placement)
        busy = {c: t * n_tasks for c, t in cost.t_cluster_ns.items()}
        e_dyn = n_tasks * cost.e_dyn_task_pj
        e_static = self.em.static_energy_pj(self.placement, T, busy)
        rep = SliceReport(self._idx, n_tasks, T / max(n_tasks, 1),
                          dict(self.placement), 0, 0.0, 0.0,
                          n_tasks * cost.t_task_ns, e_dyn, e_static,
                          n_tasks * cost.t_task_ns <= T + 1e-6)
        self._idx += 1
        return rep

    def run(self, tasks_per_slice: List[int]) -> List[SliceReport]:
        return [self.step(n) for n in tasks_per_slice]
