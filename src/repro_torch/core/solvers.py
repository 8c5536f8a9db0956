"""Pluggable placement solvers behind one strategy interface.

Every solver turns an :class:`~repro_torch.core.energy.EnergyModel` plus a
slice length into a :class:`~repro_torch.core.placement.PlacementLUT`, so
schedulers, benchmarks and fleets can swap the optimization strategy by
name without re-threading ``(arch, model, em, ...)`` tuples:

  * ``"closed-form"`` - exact per-cluster endpoint solver with statics
    (:class:`repro_torch.core.placement.ClosedFormSolver`), the default;
    solves the whole t-grid in one vectorized pass (DESIGN.md SS.6).
  * ``"dp"``          - Algorithms 1+2 (tick-quantized DP) on the
    :mod:`repro_torch.kernels.lut_pipeline` op (CUDA kernels on the card,
    their plain versions with ``device="cpu"``).
  * ``"fixed-baseline"`` / ``"fixed-hetero"`` / ``"fixed-hybrid"`` - the
    Table I comparison policies as *degenerate* solvers: one placement for
    every constraint, packaged as a single-entry LUT so they can be
    benchmarked through the same builder as the real solvers.

Adding a solver is one :func:`register_solver` call; see DESIGN.md SS.5.

The DVFS clock axis (DESIGN.md SS.10) is orthogonal to the solver
registry: the online controller (:mod:`repro_torch.core.techmodel`) builds one
LUT per clock grid point *through* whichever dynamic solver the
substrate names, then picks among the per-point LUTs at runtime -- so a
new solver composes with the clock axis for free, and a new TechModel
never touches solver code.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

from repro_torch.core.energy import EnergyModel, Placement
from repro_torch.core.placement import LUTEntry, PlacementLUT, build_lut
from repro_torch.device import DEFAULT_DEVICE


class PlacementSolver:
    """Strategy interface: (EnergyModel, t_slice) -> PlacementLUT."""

    name: str
    #: True for degenerate solvers whose placement never changes; the api
    #: layer runs these through FixedPlacementScheduler (no movement logic).
    fixed: bool

    def build_lut(self, em: EnergyModel, *, t_slice_ns: float,
                  n_points: int = 64, k_groups: int = 256,
                  static_window: str = "t_constraint") -> PlacementLUT:
        raise NotImplementedError

    def initial_placement(self, em: EnergyModel) -> Optional[Placement]:
        """Placement to boot a scheduler with (None = scheduler default)."""
        return None


@dataclasses.dataclass
class LUTMethodSolver(PlacementSolver):
    """Dynamic solver backed by :func:`repro_torch.core.placement.build_lut`.

    ``batched`` selects the vectorized whole-t-grid drivers (DESIGN.md
    SS.6, the default) vs the per-point reference loop - byte-identical
    output either way; ``device`` is where ``method="dp"`` runs its
    kernels (``"cuda"``, the default, or ``"cpu"`` for their plain
    versions)."""

    name: str
    method: str                     # build_lut method key
    fixed: bool = False
    batched: bool = True
    device: str = DEFAULT_DEVICE

    def build_lut(self, em: EnergyModel, *, t_slice_ns: float,
                  n_points: int = 64, k_groups: int = 256,
                  static_window: str = "t_constraint") -> PlacementLUT:
        return build_lut(em.arch, em.model, t_slice_ns=t_slice_ns,
                         n_points=n_points, rho=em.rho, method=self.method,
                         k_groups=k_groups, static_window=static_window,
                         em=em, batched=self.batched, device=self.device)


@dataclasses.dataclass
class FixedPolicySolver(PlacementSolver):
    """Degenerate solver: one fixed placement for every time constraint
    (Baseline-/Heterogeneous-/Hybrid-PIM of Table I)."""

    name: str
    policy: Callable[[EnergyModel], Placement]
    fixed: bool = True

    def placement(self, em: EnergyModel) -> Placement:
        return dict(self.policy(em))

    def initial_placement(self, em: EnergyModel) -> Placement:
        return self.placement(em)

    def build_lut(self, em: EnergyModel, *, t_slice_ns: float,
                  n_points: int = 64, k_groups: int = 256,
                  static_window: str = "t_constraint") -> PlacementLUT:
        pl = self.placement(em)
        tc = em.task_cost(pl)
        e_task = tc.e_dyn_task_pj + em.static_energy_pj(
            pl, tc.t_task_ns, tc.t_cluster_ns)
        entry = LUTEntry(tc.t_task_ns, pl, float(e_task), tc.t_task_ns, True)
        return PlacementLUT(em.arch.name, em.model.name, [entry])


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SolverFactory = Callable[[], PlacementSolver]
SOLVERS: Dict[str, SolverFactory] = {}

_ALIASES = {"closed_form": "closed-form"}   # legacy build_lut method name


def register_solver(name: str, factory: SolverFactory) -> None:
    SOLVERS[name] = factory


def make_solver(name: Union[str, PlacementSolver], *,
                device=DEFAULT_DEVICE) -> PlacementSolver:
    """Resolve a solver by registry name (instances pass through, keeping
    their own device); a LUT-method solver resolved by name builds on
    ``device``."""
    if isinstance(name, PlacementSolver):
        return name
    key = _ALIASES.get(name, name)
    if key not in SOLVERS:
        raise ValueError(
            f"unknown solver {name!r}; one of {sorted(SOLVERS)}")
    sol = SOLVERS[key]()
    if isinstance(sol, LUTMethodSolver):
        sol = dataclasses.replace(sol, device=device)
    return sol


register_solver("closed-form",
                lambda: LUTMethodSolver("closed-form", "closed_form"))
register_solver("dp", lambda: LUTMethodSolver("dp", "dp"))

# The three fixed comparison policies. All reduce to a peak placement of
# the matching arch (baseline/hetero: makespan-balanced SRAM; hybrid:
# MRAM-resident weights, SRAM as I/O buffer), which is exactly what
# repro_torch.core.baselines computes policy-by-policy.
register_solver("fixed-baseline", lambda: FixedPolicySolver(
    "fixed-baseline", lambda em: em.peak_placement(sram_only=True)))
register_solver("fixed-hetero", lambda: FixedPolicySolver(
    "fixed-hetero", lambda em: em.peak_placement(sram_only=True)))
register_solver("fixed-hybrid", lambda: FixedPolicySolver(
    "fixed-hybrid", lambda em: em.peak_placement(sram_only=False)))
