"""Comparison-group processors (Table I) and their fixed placement policies.

The policies are registered as degenerate solvers (``fixed-baseline`` /
``fixed-hetero`` / ``fixed-hybrid``) bound to the ``edge-*`` substrates;
construct their runtimes via ``repro_torch.api.scheduler("edge-<kind>", ...)``.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core import spaces as sp
from repro_torch.core.energy import EnergyModel, Placement


def baseline_policy(model: sp.ModelSpec) -> Tuple[sp.PIMArch, Placement]:
    """Baseline-PIM: 8 HP modules, all weights in (128 kB) SRAM."""
    arch = sp.baseline_pim()
    return arch, {"hp_sram": model.n_params}


def hetero_policy(model: sp.ModelSpec, rho: float = 1.0
                  ) -> Tuple[sp.PIMArch, Placement]:
    """Heterogeneous-PIM: 4 HP + 4 LP modules, SRAM-only; weights split to
    balance the two clusters' makespans (its best fixed operating point)."""
    arch = sp.hetero_pim()
    em = EnergyModel(arch, model, rho=rho)
    return arch, em.peak_placement(sram_only=True)


def hybrid_policy(model: sp.ModelSpec) -> Tuple[sp.PIMArch, Placement]:
    """Hybrid-PIM: 8 HP modules; weights in MRAM, SRAM as I/O buffer."""
    arch = sp.hybrid_pim()
    return arch, {"hp_mram": model.n_params}
