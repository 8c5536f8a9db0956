"""End-to-end HH-PIM system simulation: scenarios -> energy/latency traces.

All runtimes are constructed through the ``repro_torch.api`` facade; ``kind``
and ``solver`` select substrate/solver registry entries, so adding an
arch variant or placement strategy needs no change here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import spaces as sp
from repro_torch.core import workloads
from repro_torch.core.scheduler import SliceReport
from repro_torch.device import DEFAULT_DEVICE


@dataclasses.dataclass
class ScenarioResult:
    arch: str
    model: str
    scenario: str
    energy_uj: float
    deadline_miss: int
    reports: List[SliceReport]


def default_t_slice_ns(model: sp.ModelSpec, rho: float = 1.0,
                       headroom: float = 1.01) -> float:
    """Time slice sized to fit PEAK_TASKS inferences at HH-PIM peak perf
    (paper: 'up to 10 inferences per time slice'), plus 1% headroom so a
    placement migration can be absorbed in a full-load slice."""
    from repro_torch.core.substrate import make_substrate
    return make_substrate("edge-hhpim").default_t_slice_ns(
        model, rho=rho, headroom=headroom)


def _run_scenario(sched, arch_tag: str, model: sp.ModelSpec, scenario: str
                  ) -> ScenarioResult:
    reports = sched.run(workloads.SCENARIOS[scenario])
    return ScenarioResult(
        arch_tag, model.name, scenario,
        sum(r.energy_pj for r in reports) * 1e-6,
        sum(not r.deadline_met for r in reports), reports)


def run_hh_pim(model: sp.ModelSpec, scenario: str, *, rho: float = 1.0,
               t_slice_ns: Optional[float] = None,
               lut_points: int = 64,
               solver: Optional[str] = None,
               device=DEFAULT_DEVICE) -> ScenarioResult:
    from repro_torch import api
    t_slice = t_slice_ns or default_t_slice_ns(model, rho)
    sched = api.scheduler("edge-hhpim", model, t_slice_ns=t_slice, rho=rho,
                          lut_points=lut_points, solver=solver,
                          device=device)
    return _run_scenario(sched, "hh_pim", model, scenario)


def run_baseline(kind: str, model: sp.ModelSpec, scenario: str, *,
                 rho: float = 1.0, t_slice_ns: Optional[float] = None,
                 device=DEFAULT_DEVICE) -> ScenarioResult:
    from repro_torch import api
    t_slice = t_slice_ns or default_t_slice_ns(model, rho)
    sched = api.scheduler(f"edge-{kind}", model, t_slice_ns=t_slice,
                          rho=rho, device=device)
    return _run_scenario(sched, f"{kind}_pim", model, scenario)


def energy_savings_table(model: sp.ModelSpec, *, rho: float = 1.0,
                         lut_points: int = 64, device=DEFAULT_DEVICE
                         ) -> Dict[str, Dict[str, float]]:
    """Savings of HH-PIM vs each comparison arch per scenario (Fig. 5)."""
    t_slice = default_t_slice_ns(model, rho)
    out: Dict[str, Dict[str, float]] = {}
    for scen in workloads.SCENARIOS:
        hh = run_hh_pim(model, scen, rho=rho, t_slice_ns=t_slice,
                        lut_points=lut_points, device=device)
        row = {}
        for kind in ("baseline", "hetero", "hybrid"):
            base = run_baseline(kind, model, scen, rho=rho,
                                t_slice_ns=t_slice, device=device)
            row[kind] = 100.0 * (1.0 - hh.energy_uj / base.energy_uj)
        row["hh_energy_uj"] = hh.energy_uj
        out[scen] = row
    return out
