"""``repro_torch.core.techmodel`` - the technology/DVFS axis of a substrate
(DESIGN.md SS.10).

A :class:`TechModel` carries the per-tech-node physics every DVFS-capable
substrate shares: the vdd/frequency scaling curve, the dynamic-energy and
leakage scale it implies, and the DVFS upper/lower bounds the silicon
supports (after lumos' per-node ITRS/conservative scaling tables with
``DVFS_U_BOUND``/``DVFS_L_BOUND``; see ROADMAP + PAPERS.md). Before this
module, each serving substrate open-coded a single ``V^2 . f`` knob
(``repro_torch.serve.gpu.dvfs_energy_scale``); now ``gpu-pool`` and both CXL
substrates resolve one registered model, so the frequency axis has one
source of truth the solver layer can enumerate.

On top of it sits the :class:`DVFSController`: the *online* half of the
paper's adaptive-allocation move, extended to the frequency axis. The
placement LUTs the fleet already builds are per-DVFS-point (the clock is
part of ``variant_key()``); the controller builds a small grid of them
through the shared :class:`~repro_torch.core.compiler.PlacementCompiler`
(deduped fleet-wide exactly like every other build) and, each slice,
picks the energy-minimal ``(placement, clock)`` pair that still meets
the slice's latency budget. ``--dvfs`` stops being a static flag: the
clock becomes a solved variable (``TimeSliceScheduler.step`` consults
the controller when one is attached, and reports the chosen clock).

Clock transitions are modeled as free: a PLL relock is ~us against the
ms-scale slices every substrate runs, and no weights move when only the
frequency changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

#: canonical rounding of a clock point (matches the ``lp_clock`` rounding
#: in ``ServePoolSubstrate.variant_key`` so grid points and cache keys
#: always agree)
CLOCK_DECIMALS = 4


@dataclasses.dataclass(frozen=True)
class TechModel:
    """Per-tech-node voltage/frequency/power scaling with DVFS bounds.

    The curve is the standard linear voltage-frequency tracking model
    down to a retention floor (the same shape the paper's 1.2 V / 0.8 V
    HP/LP split instantiates):

        ``vdd(clock) = v_min_frac + (1 - v_min_frac) * clock``

    with per-op switching energy going as ``V^2`` (:meth:`energy_scale`),
    dynamic *power* as ``V^2 . f`` (:meth:`power_scale`) and leakage as
    ``V^2`` too (:meth:`leakage_scale`; DIBL-dominated at these nodes -
    and identical to the dynamic scale on purpose, preserving the exact
    arithmetic the pre-TechModel substrates applied to their static
    rails, so LUTs at the legacy default clock stay byte-identical).

    ``dvfs_min``/``dvfs_max`` bound the *operating* range the controller
    may pick from (lumos' DVFS_L/U_BOUND); :meth:`energy_scale` itself
    accepts any clock in (0, 1] so explicitly constructed out-of-range
    substrates keep raising only at true physics violations.
    """

    name: str
    tech_nm: int                 # process node (informational + key)
    v_min_frac: float = 0.45     # voltage floor, fraction of nominal rail
    dvfs_min: float = 0.30       # lower DVFS frequency-scale bound
    dvfs_max: float = 1.00       # upper bound (nominal; no overdrive)

    def __post_init__(self):
        if not 0.0 < self.dvfs_min <= self.dvfs_max <= 1.0:
            raise ValueError(
                f"DVFS bounds must satisfy 0 < dvfs_min <= dvfs_max <= 1, "
                f"got [{self.dvfs_min}, {self.dvfs_max}]")
        if not 0.0 < self.v_min_frac <= 1.0:
            raise ValueError(f"v_min_frac must be in (0, 1], got "
                             f"{self.v_min_frac}")

    # -- vdd/frequency curve ----------------------------------------------
    def vdd(self, clock: float) -> float:
        """Rail voltage (fraction of nominal) at frequency scale
        ``clock`` - voltage tracks frequency linearly down to the
        retention floor."""
        self._check(clock)
        return self.v_min_frac + (1.0 - self.v_min_frac) * clock

    # -- dynamic + leakage power model ------------------------------------
    def energy_scale(self, clock: float) -> float:
        """Per-op dynamic (switching) energy scale: ``V^2`` at the
        frequency-matched voltage. The single physics expression behind
        ``repro_torch.serve.gpu.dvfs_energy_scale`` (kept byte-identical)."""
        v = self.vdd(clock)
        return v * v

    def power_scale(self, clock: float) -> float:
        """Dynamic *power* scale ``C . V^2 . f`` (energy scale times
        throughput) - the frontier axis the 2-D sweep plots."""
        return self.energy_scale(clock) * clock

    def leakage_scale(self, clock: float) -> float:
        """Static/leakage power scale at ``clock``'s rail voltage.

        Modeled as ``V^2`` (identical to :meth:`energy_scale`): the
        pre-TechModel substrates scaled their static rails by the same
        factor as the dynamic energy, and keeping the expressions equal
        is what pins LUT bytes at the legacy default clock."""
        return self.energy_scale(clock)

    # -- DVFS bounds -------------------------------------------------------
    def in_bounds(self, clock: float) -> bool:
        return self.dvfs_min - 1e-12 <= clock <= self.dvfs_max + 1e-12

    def clamp(self, clock: float) -> float:
        """Clamp ``clock`` into the model's operating range."""
        return min(max(float(clock), self.dvfs_min), self.dvfs_max)

    def clock_grid(self, n_clocks: int = 5,
                   include: Iterable[float] = ()) -> Tuple[float, ...]:
        """``n_clocks`` evenly spaced operating points spanning
        [``dvfs_min``, ``dvfs_max``], merged (sorted, deduplicated at
        :data:`CLOCK_DECIMALS`) with any explicit ``include`` points -
        pass a substrate's default clock so the legacy static point is
        always on the solved grid."""
        if n_clocks < 1:
            raise ValueError("clock_grid needs n_clocks >= 1")
        if n_clocks == 1:
            pts = [self.dvfs_max]
        else:
            step = (self.dvfs_max - self.dvfs_min) / (n_clocks - 1)
            pts = [self.dvfs_min + i * step for i in range(n_clocks)]
        pts.extend(self.clamp(c) for c in include)
        seen: Dict[float, float] = {}
        for p in pts:
            seen.setdefault(round(p, CLOCK_DECIMALS), p)
        return tuple(seen[k] for k in sorted(seen))

    def _check(self, clock: float) -> None:
        if not 0.0 < clock <= 1.0:
            raise ValueError(
                f"DVFS clock scale must be in (0, 1], got {clock}")


# ---------------------------------------------------------------------------
# Registry (one entry per substrate technology; DESIGN.md SS.10)
# ---------------------------------------------------------------------------

TECH_MODELS: Dict[str, TechModel] = {}


def register_tech_model(model: TechModel) -> TechModel:
    TECH_MODELS[model.name] = model
    return model


def get_tech_model(name: str) -> TechModel:
    if name not in TECH_MODELS:
        raise ValueError(
            f"unknown tech model {name!r}; one of {sorted(TECH_MODELS)}")
    return TECH_MODELS[name]


def available_tech_models() -> Tuple[str, ...]:
    return tuple(sorted(TECH_MODELS))


#: A100-class SM pools (repro_torch.serve.gpu): v_min_frac is the historic
#: ``V_MIN_FRAC = 0.45`` retention floor, bounds span the lp_clock range
#: the DVFS sweeps always used.
SM_POOL_7NM = register_tech_model(TechModel(
    "sm-pool-7nm", tech_nm=7, v_min_frac=0.45,
    dvfs_min=0.30, dvfs_max=1.00))

#: DDR5/CXL-class node pools (repro_torch.serve.cxl, both cxl-tier and
#: cxl-tier-3): historically shared the GPU voltage curve (cxl.py
#: imported ``dvfs_energy_scale``), so the same v_min_frac - only the
#: lower operating bound differs (node fabrics hold a higher floor).
CXL_NODE_10NM = register_tech_model(TechModel(
    "cxl-node-10nm", tech_nm=10, v_min_frac=0.45,
    dvfs_min=0.35, dvfs_max=1.00))


# ---------------------------------------------------------------------------
# Online DVFS controller
# ---------------------------------------------------------------------------


class DVFSController:
    """Per-slice joint ``(placement, clock)`` solver for one engine.

    Holds one substrate variant per clock grid point (built with
    ``substrate.with_clock``), lazily materializes each point's
    :class:`~repro_torch.core.energy.EnergyModel` + placement LUT through the
    shared :class:`~repro_torch.core.compiler.PlacementCompiler` (clocked
    variants have distinct ``variant_key()``s, so N engines on the same
    grid pay one build per point fleet-wide), and per slice returns the
    grid point whose LUT placement minimizes *slice* energy subject to
    the slice's latency budget ``n_plan * t_task <= T``.

    Deterministic by construction: grid points are scanned in ascending
    clock order with strict improvement, so ties go to the lowest clock
    and identical inputs always produce identical clock sequences.
    """

    def __init__(self, substrate, workload=None, *,
                 clocks: Optional[Sequence[float]] = None,
                 n_clocks: int = 5,
                 t_slice_ns: Optional[float] = None,
                 rho: Optional[float] = None,
                 solver=None,
                 lut_points: Optional[int] = None,
                 compiler=None):
        tm = substrate.tech_model()
        if tm is None:
            raise ValueError(
                f"substrate {substrate.name!r} has no registered TechModel "
                f"(no DVFS axis to solve); use a gpu-pool or cxl-tier "
                f"substrate, or register one via its `tech` attribute")
        if compiler is None:
            from repro_torch.core.compiler import PlacementCompiler
            compiler = PlacementCompiler()
        self.tech = tm
        self.base = substrate
        self.compiler = compiler
        default_clock = getattr(substrate, "lp_clock", None)
        if clocks is None:
            include = () if default_clock is None else (default_clock,)
            clocks = tm.clock_grid(n_clocks, include=include)
        else:
            clocks = tuple(sorted(tm.clamp(c) for c in clocks))
        self.clocks: Tuple[float, ...] = tuple(clocks)
        self.variants = {c: substrate.with_clock(c) for c in self.clocks}
        self.model = substrate.model_spec(workload)
        self.rho = substrate.rho if rho is None else rho
        self.solver = solver or substrate.solver
        self.lut_points = (substrate.lut_points if lut_points is None
                           else lut_points)
        self.t_slice_ns = float(
            substrate.default_t_slice_ns(self.model, rho=self.rho)
            if t_slice_ns is None else t_slice_ns)
        # (clock, slowdown signature) -> EnergyModel; LUTs live in the
        # shared compiler cache keyed the same way
        self._ems: Dict[tuple, object] = {}

    # -- per-point state ---------------------------------------------------
    def _em_for(self, clock: float, slowdown: Optional[dict]):
        from repro_torch.core.compiler import slowdown_signature
        from repro_torch.core.energy import EnergyModel
        key = (round(clock, CLOCK_DECIMALS),
               slowdown_signature(slowdown or {}))
        em = self._ems.get(key)
        if em is None:
            em = EnergyModel(self.variants[clock].arch, self.model,
                             rho=self.rho, time_scale=slowdown)
            self._ems[key] = em
        return em

    def lut_for(self, clock: float, slowdown: Optional[dict] = None):
        """The clock point's placement LUT, served from the fleet-wide
        compiler cache (straggler slowdowns get their own entries, keyed
        exactly like the scheduler's rebuilds)."""
        v = self.variants[clock]
        return self.compiler.lut(
            self._em_for(clock, slowdown), solver=self.solver,
            t_slice_ns=self.t_slice_ns, n_points=self.lut_points,
            static_window=v.static_window, variant_key=v.variant_key())

    def prepare(self) -> int:
        """Eagerly build every grid point's LUT (fleet bring-up pays the
        whole grid once; later engines on the same grid hit the cache).
        Returns the number of grid points."""
        for c in self.clocks:
            self.lut_for(c)
        return len(self.clocks)

    # -- the per-slice solve ----------------------------------------------
    def select(self, n_plan: int, *, slowdown: Optional[dict] = None):
        """Energy-minimal ``(clock, em, lut, entry)`` for a slice that
        must fit ``n_plan`` tasks into ``t_slice_ns``.

        Scores each grid point by exact slice energy under its LUT's
        placement (``n . e_dyn + statics over T``), skipping points whose
        placement cannot meet the budget. If no point fits (overload),
        falls back to the throughput-maximal point so the backlog drains
        fastest - the same degradation semantics as a static clock.
        """
        T = self.t_slice_ns
        n = max(int(n_plan), 1)
        best = fastest = None
        best_e = fastest_t = float("inf")
        for c in self.clocks:
            em = self._em_for(c, slowdown)
            lut = self.lut_for(c, slowdown)
            entry = lut.lookup(T / n)
            cost = em.task_cost(entry.placement)
            cand = (c, em, lut, entry)
            if cost.t_task_ns < fastest_t:
                fastest_t, fastest = cost.t_task_ns, cand
            if n * cost.t_task_ns > T * (1 + 1e-9):
                continue
            busy = {k: v * n for k, v in cost.t_cluster_ns.items()}
            e_slice = (n * cost.e_dyn_task_pj
                       + em.static_energy_pj(entry.placement, T, busy))
            if e_slice < best_e:
                best_e, best = e_slice, cand
        return best if best is not None else fastest
