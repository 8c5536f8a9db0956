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

``lut``, ``scheduler``, ``compiler`` and ``engine`` run their device work
on ``device="cuda"`` unless the caller asks for ``device="cpu"``; a CUDA
request without a card raises. The fleets of ``repro.api`` are not
ported yet.

Adding a backend = one ``register_substrate`` entry; adding a placement
strategy = one ``register_solver`` entry. The
:class:`~repro_torch.core.compiler.PlacementCompiler` (DESIGN.md SS.6) is
the batched LUT build service: schedulers route straggler-rescaling
rebuilds through its shared cache.
"""
from __future__ import annotations

from typing import Optional, Union

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
    "substrate", "solver", "lut", "scheduler", "compiler", "engine", "obs",
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
    instance to several ``scheduler`` calls to share one build cache."""
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
           device=DEFAULT_DEVICE, **over):
    """Construct a functional serve engine (weights actually re-tiered per
    placement) on a decode-capable pool substrate (tpu/gpu pools and the
    cxl tiers; the substrate's ``tier_plan`` sets the column split).
    ``params`` must live on ``device``, which runs the LUT builds, the
    decode state and the tiering."""
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
                             compiler=compiler, device=device)
