"""``repro_torch.api`` - the facade for constructing the HH-PIM
placement runtime on PyTorch.

Entry points build LUTs and schedulers through this module instead of
hand-wiring ``(arch, model, em, lut, rho, t_slice)`` tuples. Substrates
and solvers are string-keyed registries (DESIGN.md SS.5):

    from repro_torch import api

    sched = api.scheduler("edge-hhpim", "efficientnet_b0", rho=4.0)
    sched = api.scheduler("edge-hybrid", model)        # fixed Table I policy
    sched = api.scheduler("gpu-pool", cfg, solver="dp", dvfs=True)
    lut   = api.lut("edge-hhpim", model, t_slice_ns=T)
    pc    = api.compiler()               # batched LUT build service
    pc.stats()                           # {"entries": 2, "builds": 2, ...}

    eng   = api.engine("gpu-pool", cfg, params, max_batch=16)
    fl    = api.fleet("gpu-pool-mixed", cfg, n_engines=4, params=params,
                      decode=True, solver="dp", dvfs=True)
    hf    = api.hierarchical_fleet("gpu-pool-mixed", cfg, n_cells=4,
                                   engines_per_cell=4, autoscale=True)
    df    = api.dag_fleet("cxl-tier-3", cfg, n_cells=4,
                          engines_per_cell=2)      # DESIGN.md SS.11
    pc    = api.compiler(device="cpu")
    fl    = api.fleet("tpu-pool", n_engines=2, compiler=pc, device="cpu")

``lut``, ``scheduler``, ``compiler``, ``engine``, ``fleet``,
``hierarchical_fleet`` and ``dag_fleet`` run their device work on
``device="cuda"`` unless the caller asks for ``device="cpu"``; a CUDA
request without a card raises. A fleet's routing, forecasting and
accounting are host code; its device runs the LUT builds (one per
engine shape, and one per DVFS clock point) and, with ``decode=True``,
every worker's re-tiering and decode.

Adding a backend = one ``register_substrate`` entry; adding a placement
strategy = one ``register_solver`` entry. The
:class:`~repro_torch.core.compiler.PlacementCompiler` (DESIGN.md SS.6) is
the batched LUT build service: schedulers route straggler-rescaling
rebuilds through its shared cache.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.compiler import PlacementCompiler
from repro_torch.core.scheduler import (FixedPlacementScheduler,
                                        TimeSliceScheduler)
from repro_torch.core.solvers import (SOLVERS, FixedPolicySolver,  # noqa: F401
                                PlacementSolver, make_solver,
                                register_solver)
from repro_torch.core.substrate import (SUBSTRATES, Substrate,  # noqa: F401
                                  available_substrates, list_substrates,
                                  make_substrate, register_substrate)
from repro_torch.core.techmodel import (TECH_MODELS,  # noqa: F401
                                        DVFSController, TechModel,
                                        available_tech_models,
                                        get_tech_model, register_tech_model)
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device

__all__ = [
    "substrate", "solver", "lut", "scheduler", "engine", "fleet",
    "hierarchical_fleet", "dag_fleet", "compiler", "obs",
    "PlacementCompiler",
    "Substrate", "PlacementSolver", "SUBSTRATES", "SOLVERS",
    "register_substrate", "register_solver", "available_substrates",
    "list_substrates", "TechModel", "DVFSController", "TECH_MODELS",
    "tech_model", "register_tech_model", "available_tech_models",
]


def tech_model(name: str) -> TechModel:
    """Resolve a registered :class:`~repro_torch.core.techmodel.TechModel`
    (the per-tech-node vdd/freq/power curve + DVFS bounds behind a
    substrate's clock axis, DESIGN.md SS.10)."""
    return get_tech_model(name)


def compiler(device=DEFAULT_DEVICE) -> PlacementCompiler:
    """A fresh :class:`~repro_torch.core.compiler.PlacementCompiler` - the
    batched LUT build service, building on ``device``. Pass the same
    instance to several ``scheduler``/``engine``/``fleet`` calls to
    share one build cache."""
    resolve_device(device)
    return PlacementCompiler(device=device)


def obs():
    """The process-wide observability facade (:mod:`repro_torch.obs`,
    DESIGN.md SS.8): ``obs().enable()`` turns on tracing, ``obs().
    tracer()``/``metrics()``/``flight_recorder()`` read back the
    recorded state, ``obs().export(trace_path, metrics_path)`` writes
    Perfetto-loadable ``trace.json`` and a ``metrics.json`` snapshot."""
    from repro_torch import obs as _obs
    return _obs


def substrate(name: Union[str, Substrate], **over) -> Substrate:
    """Resolve a substrate by registry name (instances pass through;
    keyword overrides go to the factory / ``dataclasses.replace``)."""
    return make_substrate(name, **over)


def solver(name: Union[str, PlacementSolver],
           device=DEFAULT_DEVICE) -> PlacementSolver:
    """Resolve a placement solver by registry name (LUT-method solvers
    build on ``device``)."""
    return make_solver(name, device=device)


def lut(sub: Union[str, Substrate], workload=None, *, solver=None,
        t_slice_ns: Optional[float] = None, n_points: Optional[int] = None,
        rho: Optional[float] = None,
        compiler: Optional[PlacementCompiler] = None,
        device=DEFAULT_DEVICE, **over):
    """Build a :class:`~repro_torch.core.placement.PlacementLUT` for a
    substrate workload through its (or the named) solver; an explicit
    ``compiler`` routes the build through its shared cache.

    ``solver="dp"`` runs the fused lut_pipeline op (one device pass for
    the whole t-grid) on ``device``. The returned LUT's ``backend``
    attribute records the device type that built it; both are
    byte-identical."""
    resolve_device(device)
    return substrate(sub, **over).build_lut(
        workload, solver=solver, t_slice_ns=t_slice_ns, n_points=n_points,
        rho=rho, compiler=compiler, device=device)


def scheduler(sub: Union[str, Substrate], workload=None, *, solver=None,
              t_slice_ns: Optional[float] = None,
              rho: Optional[float] = None, lut=None,
              lut_points: Optional[int] = None, initial_placement=None,
              compiler: Optional[PlacementCompiler] = None,
              dvfs=None, device=DEFAULT_DEVICE, **over):
    """Construct the per-slice runtime for a substrate workload.

    Dynamic solvers (``closed-form``/``dp``) yield a
    :class:`~repro_torch.core.scheduler.TimeSliceScheduler`; the degenerate
    ``fixed-*`` solvers yield a
    :class:`~repro_torch.core.scheduler.FixedPlacementScheduler` (the Table I
    comparison-group semantics: no migration, no movement accounting).
    A shared ``compiler`` lets several schedulers reuse one LUT cache.

    ``dvfs`` attaches the online per-slice DVFS controller (DESIGN.md
    SS.10) on substrates with a registered TechModel: ``True`` for the
    default clock grid, an int for the grid size, a sequence for
    explicit clock points, or a prebuilt
    :class:`~repro_torch.core.techmodel.DVFSController`.

    A solver named by string builds its LUTs on ``device``.
    """
    resolve_device(device)
    s = substrate(sub, **over)
    model = s.model_spec(workload)
    rho = s.rho if rho is None else rho
    if t_slice_ns is None:
        t_slice_ns = s.default_t_slice_ns(model, rho=rho)
    sol = make_solver(solver or s.solver, device=device)
    if sol.fixed:
        if dvfs is not None:
            raise ValueError(
                "the DVFS controller needs a dynamic solver; fixed-* "
                "policies run at the substrate's static operating point")
        em = s.energy_model(model, rho=rho)
        return FixedPlacementScheduler(
            s.arch, model, t_slice_ns=t_slice_ns,
            placement=sol.initial_placement(em), rho=rho)
    return TimeSliceScheduler.from_substrate(
        s, model, t_slice_ns=t_slice_ns, rho=rho, solver=sol, lut=lut,
        initial_placement=initial_placement, lut_points=lut_points,
        compiler=compiler, dvfs=dvfs)


def engine(sub: Union[str, Substrate] = "tpu-pool", cfg=None, params=None,
           *, t_slice_ms: Optional[float] = None, max_batch: int = 16,
           seed: int = 0, lut_points: Optional[int] = None,
           compiler: Optional[PlacementCompiler] = None,
           compute_params=None, device=DEFAULT_DEVICE, **over):
    """Construct a functional serve engine (weights actually re-tiered per
    placement) on a decode-capable pool substrate (tpu/gpu pools and the
    cxl tiers; the substrate's ``tier_plan`` sets the column split).
    ``params`` must live on ``device``, which runs the LUT builds, the
    decode state and the tiering. The decode reads ``compute_params``
    (``serve.hetero.compute_copy`` of ``params``), made here when not
    given."""
    from repro_torch.serve.hetero import HeteroServeEngine
    resolve_device(device)
    s = substrate(sub, **over)
    if not s.supports_decode:
        raise ValueError(
            f"substrate {s.name!r} has no functional serve engine "
            f"(accounting-only); use a substrate with supports_decode "
            f"(tpu-pool / gpu-pool / cxl-tier families)")
    return HeteroServeEngine(cfg, params, substrate=s,
                             t_slice_ms=t_slice_ms, max_batch=max_batch,
                             seed=seed, lut_points=lut_points,
                             compiler=compiler,
                             compute_params=compute_params, device=device)


def _fleet_compiler(compiler: Optional[PlacementCompiler],
                    device) -> PlacementCompiler:
    """The fleet's shared build service: ``compiler`` when given (it must
    build on the fleet's device), else a fresh one on ``device``."""
    dev = resolve_device(device)
    if compiler is None:
        return PlacementCompiler(device=device)
    if torch.device(compiler.device).type != dev.type:
        raise ValueError(
            f"compiler builds on {compiler.device!r}, the fleet runs on "
            f"{str(device)!r}; pass a compiler made with "
            f"api.compiler(device={str(device)!r})")
    return compiler


def fleet(sub: Union[str, Substrate] = "tpu-pool", cfg=None, *,
          n_engines: int = 2, forecaster: str = "ewma",
          policy: str = "slo", tokens_per_task: Optional[int] = None,
          rho: Optional[float] = None, t_slice_ms: Optional[float] = None,
          lut_points: Optional[int] = None,
          admission_limit: Optional[int] = None, slo_slices: float = 2.0,
          forecast_margin: float = 1.0, params=None, decode: bool = False,
          max_batch: int = 16, forecaster_kw: Optional[dict] = None,
          workload=None, compiler: Optional[PlacementCompiler] = None,
          dvfs=None, device=DEFAULT_DEVICE, **over):
    """Construct a fleet of ``n_engines`` serve engines on one substrate.

    Engine shapes come from ``substrate.engine_variant(i)`` (the
    ``*-mixed`` substrates give odd engines half the pools); engines
    with the same shape share one placement LUT, batch-built by a
    :class:`~repro_torch.core.compiler.PlacementCompiler` on ``device``
    (pass one in to share its cache across fleets; the same compiler
    also serves every worker's straggler-rescaling rebuilds).
    ``decode=True`` (decode-capable substrates, requires ``params`` on
    ``device``) attaches a real ``HeteroServeEngine`` per worker so
    every placement change re-tiers actual weights and decodes tokens;
    the engines decode from one compute copy of ``params``
    (``serve.hetero.compute_copy``), made once here.

    ``dvfs`` turns the fleet's clock into a solved variable (DESIGN.md
    SS.10): ``True``/int/sequence builds one
    :class:`~repro_torch.core.techmodel.DVFSController` per engine
    *shape* (grid LUTs built through the shared compiler at bring-up,
    deduped exactly like the base LUTs), shared by every worker of that
    shape; each worker's scheduler then solves the energy-minimal
    (placement, clock) pair per slice.

    Every worker's scheduler gets a solver resolved on ``device``, so a
    LUT it builds later (a straggler slowdown) builds there too.
    """
    from repro_torch.fleet.forecast import make_forecaster
    from repro_torch.fleet.router import EngineWorker, Fleet

    pc = _fleet_compiler(compiler, device)
    s = substrate(sub, **over)
    if tokens_per_task is None:
        # registry names get the fleet default; a pre-configured Substrate
        # instance keeps whatever it was built with
        tokens_per_task = (s.tokens_per_task
                           if not isinstance(sub, str)
                           and hasattr(s, "tokens_per_task") else 2)
    if hasattr(s, "tokens_per_task") and s.tokens_per_task != tokens_per_task:
        s = s.replace(tokens_per_task=tokens_per_task)
    rho = s.rho if rho is None else rho
    if rho != s.rho:
        s = s.replace(rho=rho)
    model = s.model_spec(workload if workload is not None else cfg)

    variants = [s.engine_variant(i) for i in range(n_engines)]
    shapes = {}
    for v in variants:
        shapes.setdefault(v.variant_key(), v)

    if t_slice_ms is None:
        # fleet-wide slice = the fastest engine shape's default sizing
        t_slice_ms = min(v.default_t_slice_ns(model, rho=rho)
                         for v in shapes.values()) / 1e6
    t_slice_ns = t_slice_ms * 1e6

    # one LUT per distinct engine shape, batch-built by the placement
    # compiler (one pass over the deduplicated shapes) and shared by all
    # instances
    luts = pc.compile(shapes.values(), model, t_slice_ns=t_slice_ns,
                      n_points=lut_points, rho=rho)

    # one DVFS controller per engine SHAPE (controllers are stateless
    # across slices, so same-shape workers share one grid of LUTs)
    controllers = {}
    if dvfs is not None and dvfs is not False:
        kw = {}
        if isinstance(dvfs, DVFSController):
            raise ValueError(
                "pass dvfs=True/int/sequence to fleet(); controllers are "
                "per engine shape and built internally")
        if isinstance(dvfs, int) and not isinstance(dvfs, bool):
            kw["n_clocks"] = dvfs
        elif not isinstance(dvfs, bool):
            kw["clocks"] = tuple(dvfs)
        for vk, v in shapes.items():
            controllers[vk] = DVFSController(
                v, model, t_slice_ns=t_slice_ns, rho=rho,
                lut_points=lut_points, compiler=pc, **kw)
            controllers[vk].prepare()

    compute = None
    if decode:
        if params is None:
            raise ValueError("decode=True requires model params")
        from repro_torch.serve.hetero import compute_copy
        compute = compute_copy(cfg, params, shared_by=n_engines)
    workers = []
    for i, v in enumerate(variants):
        hetero = None
        if decode:
            eng = engine(v, cfg, params, t_slice_ms=t_slice_ns / 1e6,
                         max_batch=max_batch, lut_points=lut_points,
                         compiler=pc, compute_params=compute,
                         device=device)
            sched = eng.sched
            sched._lut_cache[sched._slowdown_key()] = luts[v.variant_key()]
            hetero = eng
        else:
            sched = TimeSliceScheduler.from_substrate(
                v, model, t_slice_ns=t_slice_ns, rho=rho,
                solver=make_solver(v.solver, device=device),
                lut=luts[v.variant_key()], lut_points=lut_points,
                compiler=pc)
        if controllers:
            sched.dvfs = controllers[v.variant_key()]
        workers.append(EngineWorker(
            i, sched, make_forecaster(forecaster, **(forecaster_kw or {})),
            hetero=hetero, substrate=v, forecast_margin=forecast_margin))
    return Fleet(workers, policy=policy, admission_limit=admission_limit,
                 slo_slices=slo_slices, tokens_per_request=tokens_per_task)


def hierarchical_fleet(sub: Union[str, Substrate] = "tpu-pool", cfg=None,
                       *, n_cells: int = 4, engines_per_cell: int = 4,
                       forecaster: str = "ewma",
                       budgets: Optional[dict] = None,
                       class_mix: Optional[dict] = None,
                       cell_policy: str = "least_loaded",
                       energy_weight: float = 0.05,
                       admit_headroom: float = 1.0,
                       autoscale: bool = False,
                       min_engines: Optional[int] = None,
                       max_engines: Optional[int] = None,
                       autoscale_kw: Optional[dict] = None,
                       tokens_per_task: Optional[int] = None,
                       rho: Optional[float] = None,
                       t_slice_ms: Optional[float] = None,
                       lut_points: Optional[int] = None,
                       slo_slices: float = 2.0,
                       forecast_margin: float = 1.0,
                       forecaster_kw: Optional[dict] = None,
                       workload=None,
                       compiler: Optional[PlacementCompiler] = None,
                       seed: int = 0, device=DEFAULT_DEVICE, **over):
    """Construct a two-level (cell -> engine) fleet (DESIGN.md SS.9).

    ``n_cells`` cells of ``engines_per_cell`` engines each; one
    substrate variant per cell (``sub`` may also be a list of substrate
    names/instances, cycled across cells - with a mixed substrate,
    odd-indexed CELLS get the half shape). All engines of a cell share
    one placement LUT; the fleet-wide
    :class:`~repro_torch.core.compiler.PlacementCompiler` builds every
    distinct shape at bring-up on ``device``, so ``n_cells x
    engines_per_cell`` engines cost at most ``n_cells`` builds
    (typically 1-2) and a warm-started compiler (``pc.load(...)``)
    costs zero.

    ``budgets`` maps SLO class -> latency budget in slices (default
    ``{"default": slo_slices}``); ``class_mix`` maps class ->
    probability for seeded class assignment. ``autoscale=True`` attaches
    a :class:`~repro_torch.fleet.hierarchy.CellAutoscaler` with per-cell
    bounds [``min_engines`` (default 1), ``max_engines`` (default
    ``engines_per_cell``)]; extra :class:`~repro_torch.fleet.hierarchy.
    AutoscaleConfig` knobs go in ``autoscale_kw``. Scale-ups build new
    workers through the shared compiler, so they pay 0 LUT builds; a
    scale-up that does miss (another slowdown) builds on ``device``.

    The hierarchical path is analytic-only (scheduler + energy model);
    use :func:`fleet` with ``decode=True`` for functional token decode.
    """
    import itertools as _it

    from repro_torch.fleet.forecast import make_forecaster
    from repro_torch.fleet.hierarchy import (AutoscaleConfig, Cell,
                                             CellAutoscaler,
                                             HierarchicalFleet)
    from repro_torch.fleet.router import EngineWorker

    pc = _fleet_compiler(compiler, device)
    names = list(sub) if isinstance(sub, (list, tuple)) else [sub]
    subs = []
    for nm in names:
        s = substrate(nm, **over)
        if tokens_per_task is None:
            tokens_per_task = (s.tokens_per_task
                               if not isinstance(nm, str)
                               and hasattr(s, "tokens_per_task") else 2)
        if (hasattr(s, "tokens_per_task")
                and s.tokens_per_task != tokens_per_task):
            s = s.replace(tokens_per_task=tokens_per_task)
        if rho is not None and rho != s.rho:
            s = s.replace(rho=rho)
        subs.append(s)

    # one substrate variant per CELL (cells are the unit of shape)
    cell_subs = [subs[i % len(subs)].engine_variant(i)
                 for i in range(n_cells)]
    shapes = {}
    for v in cell_subs:
        shapes.setdefault(v.variant_key(), v)
    models = {vk: v.model_spec(workload if workload is not None else cfg)
              for vk, v in shapes.items()}
    if t_slice_ms is None:
        t_slice_ms = min(
            v.default_t_slice_ns(models[vk])
            for vk, v in shapes.items()) / 1e6
    t_slice_ns = t_slice_ms * 1e6

    luts = pc.compile(shapes.values(),
                      workload if workload is not None else cfg,
                      t_slice_ns=t_slice_ns, n_points=lut_points)

    wid = _it.count()

    def make_worker(v, lut=None):
        # lut=None routes the first LUT access through the shared
        # compiler (a warm cache hit for autoscaler scale-ups)
        sched = TimeSliceScheduler.from_substrate(
            v, models[v.variant_key()], t_slice_ns=t_slice_ns, lut=lut,
            solver=make_solver(v.solver, device=device),
            lut_points=lut_points, compiler=pc)
        return EngineWorker(
            next(wid), sched,
            make_forecaster(forecaster, **(forecaster_kw or {})),
            substrate=v, forecast_margin=forecast_margin)

    cells = [Cell(cid, [make_worker(v, lut=luts[v.variant_key()])
                        for _ in range(engines_per_cell)],
                  substrate=v, tokens_per_task=tokens_per_task)
             for cid, v in enumerate(cell_subs)]

    scaler = None
    if autoscale:
        acfg = AutoscaleConfig(
            min_engines=1 if min_engines is None else min_engines,
            max_engines=(engines_per_cell if max_engines is None
                         else max_engines),
            **(autoscale_kw or {}))
        scaler = CellAutoscaler(
            acfg, lambda cell: make_worker(cell.substrate), compiler=pc)

    return HierarchicalFleet(
        cells, budgets=budgets, class_mix=class_mix,
        slo_slices=slo_slices, tokens_per_request=tokens_per_task,
        autoscaler=scaler, cell_policy=cell_policy,
        energy_weight=energy_weight, admit_headroom=admit_headroom,
        seed=seed)


def dag_fleet(sub: Union[str, Substrate] = "tpu-pool", cfg=None, *,
              tenants=None, budgets: Optional[dict] = None,
              stage_affinity: bool = True,
              handoff_tax_slices: float = 0.25,
              handoff_energy_pj: float = 2e5,
              affinity_bonus: float = 0.1, device=DEFAULT_DEVICE, **kw):
    """Construct a multi-tenant DAG-serving fleet (DESIGN.md SS.11).

    Same cell bring-up as :func:`hierarchical_fleet` on ``device`` (every
    keyword it takes passes through - ``n_cells``, ``engines_per_cell``,
    ``compiler``, ``autoscale``, ...), returning a
    :class:`~repro_torch.fleet.dag.DagFleet` whose
    :meth:`~repro_torch.fleet.dag.DagFleet.run_dag` co-schedules DAG
    *stages* across the cells. ``tenants`` is a
    :class:`~repro_torch.fleet.dag.TenantRegistry` (or a sequence of
    :class:`~repro_torch.fleet.dag.Tenant`); the default registry is
    :func:`~repro_torch.fleet.dag.default_tenants` with matching
    ``budgets`` - every tenant's SLO class must be registered in
    ``budgets`` or construction raises a shaped error. Stage placement
    reads the per-variant LUTs compiled at bring-up, so a DAG fleet
    pays **zero** placement builds beyond the plain fleet's set."""
    from repro_torch.fleet.dag import (DEFAULT_DAG_BUDGETS, DagFleet,
                                       Tenant, TenantRegistry,
                                       default_tenants)

    if tenants is None:
        tenants = default_tenants()
    elif not isinstance(tenants, TenantRegistry):
        tenants = TenantRegistry(tuple(
            t if isinstance(t, Tenant) else Tenant(**t) for t in tenants))
    if budgets is None:
        budgets = dict(DEFAULT_DAG_BUDGETS)
    hf = hierarchical_fleet(sub, cfg, budgets=budgets, device=device, **kw)
    return DagFleet(
        hf.cells, tenants=tenants, stage_affinity=stage_affinity,
        handoff_tax_slices=handoff_tax_slices,
        handoff_energy_pj=handoff_energy_pj,
        affinity_bonus=affinity_bonus, budgets=hf.router.budgets,
        slo_slices=hf.slo_slices,
        tokens_per_request=hf.tokens_per_request,
        autoscaler=hf.autoscaler, cell_policy=hf.router.cell_policy,
        energy_weight=hf.router.energy_weight,
        admit_headroom=hf.router.admit_headroom, seed=hf.seed)
