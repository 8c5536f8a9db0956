"""Timing and energy model for PIM placements.

Implements the modeling contract of DESIGN.md SS.2:

  * one PIM op = one INT8 MAC on one stored weight; per-op latency is
    ``io_read + weight_read/rho + pe`` of the weight's home space,
  * ops parallelize across a cluster's modules, MRAM-resident and
    SRAM-resident ops within a module are serial (paper SS.III.B), HP and LP
    clusters run in parallel (task time = max over clusters),
  * static power: volatile banks holding weights stay on for the whole time
    slice; non-volatile banks (and empty volatile I/O banks) are power-gated
    whenever their cluster is idle; PE leaks while its cluster is busy,
  * re-placement pays the destination write (+ source read) energy and time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from repro_torch.core import spaces as sp

Placement = Dict[str, int]   # space name -> number of weights stored there


def total_weights(placement: Mapping[str, int]) -> int:
    return int(sum(placement.values()))


def validate_placement(arch: sp.PIMArch, model: sp.ModelSpec,
                       placement: Mapping[str, int]) -> None:
    names = {s.name for s in arch.spaces}
    for k, v in placement.items():
        if k not in names:
            raise ValueError(f"unknown space {k!r} for arch {arch.name}")
        if v < 0:
            raise ValueError(f"negative count for {k}")
    if total_weights(placement) != model.n_params:
        raise ValueError(
            f"placement stores {total_weights(placement)} weights, model has "
            f"{model.n_params}")
    for s in arch.spaces:
        if placement.get(s.name, 0) > s.capacity_weights:
            raise ValueError(
                f"{s.name} over capacity: {placement.get(s.name, 0)} > "
                f"{s.capacity_weights}")


@dataclasses.dataclass(frozen=True)
class TaskCost:
    """Per-task timing and per-slice energy breakdown (ns / pJ)."""

    t_task_ns: float                 # makespan of one task
    t_cluster_ns: Dict[str, float]   # per-cluster busy time per task
    e_dyn_task_pj: float             # dynamic energy of one task


class EnergyModel:
    """Evaluates placements for a given (arch, model) pair."""

    def __init__(self, arch: sp.PIMArch, model: sp.ModelSpec,
                 rho: float = 1.0,
                 time_scale: Optional[Mapping[str, float]] = None):
        if rho < 1.0:
            raise ValueError("rho must be >= 1")
        self.arch = arch
        self.model = model
        self.rho = float(rho)
        # per-cluster slowdown factors (straggler mitigation feedback)
        self.time_scale = {c.name: 1.0 for c in arch.clusters}
        if time_scale:
            self.time_scale.update({k: float(v)
                                    for k, v in time_scale.items()})

    # -- per-weight characteristics of one space -------------------------
    def weight_time_ns(self, space: sp.StorageSpace) -> float:
        """Per-task module-level time contribution of ONE weight in `space`
        (already divided by the cluster's module parallelism)."""
        return (self.model.ops_per_weight * space.op_ns(self.rho)
                * self.time_scale[space.cluster] / space.n_modules)

    def weight_energy_pj(self, space: sp.StorageSpace) -> float:
        """Per-task dynamic energy of ONE weight resident in `space`."""
        return self.model.ops_per_weight * space.op_pj(self.rho)

    # -- task-level ------------------------------------------------------
    def task_cost(self, placement: Mapping[str, int]) -> TaskCost:
        t_cluster: Dict[str, float] = {}
        e_dyn = 0.0
        for c in self.arch.clusters:
            t_c = 0.0
            for s in c.spaces:
                x = placement.get(s.name, 0)
                if x:
                    t_c += x * self.weight_time_ns(s)
                    e_dyn += x * self.weight_energy_pj(s)
            t_cluster[c.name] = t_c
        return TaskCost(t_task_ns=max(t_cluster.values()),
                        t_cluster_ns=t_cluster, e_dyn_task_pj=e_dyn)

    # -- slice-level -----------------------------------------------------
    def static_energy_pj(self, placement: Mapping[str, int],
                         t_slice_ns: float, busy_ns: Mapping[str, float]
                         ) -> float:
        """Static energy of one time slice of length ``t_slice_ns`` during
        which cluster ``c`` computed for ``busy_ns[c]`` ns."""
        e = 0.0
        for c in self.arch.clusters:
            busy = min(busy_ns.get(c.name, 0.0), t_slice_ns)
            e += c.pe_static_mw_total * busy
            for s in c.spaces:
                holds = placement.get(s.name, 0) > 0
                if s.mem.volatile and holds:
                    # SRAM holding weights cannot be gated without data loss.
                    e += s.static_mw_total * t_slice_ns
                else:
                    # Gated when idle; on while the cluster computes (MRAM
                    # reads / SRAM I/O buffering).
                    e += s.static_mw_total * busy
        return e

    def slice_energy_pj(self, placement: Mapping[str, int], n_tasks: int,
                        t_slice_ns: float) -> float:
        """Total energy of a slice executing ``n_tasks`` under `placement`."""
        cost = self.task_cost(placement)
        busy = {k: v * n_tasks for k, v in cost.t_cluster_ns.items()}
        return (n_tasks * cost.e_dyn_task_pj
                + self.static_energy_pj(placement, t_slice_ns, busy))

    # -- re-placement (data movement) -------------------------------------
    def movement_cost(self, old: Mapping[str, int], new: Mapping[str, int]
                      ) -> tuple[Dict[str, float], float]:
        """Time (per destination cluster, ns) and energy (pJ) to migrate from
        placement ``old`` to ``new``.

        Weight counts are per-space; `arrivals_i = max(0, new_i - old_i)`
        weights are written into space `i` (destination write) after being
        read from a departing space of the *other* end (charged at the
        cheapest departing space's read cost, via the controller's Data
        Rearrange Buffer - paper SS.II).
        """
        arrivals = {s.name: max(0, new.get(s.name, 0) - old.get(s.name, 0))
                    for s in self.arch.spaces}
        departures = {s.name: max(0, old.get(s.name, 0) - new.get(s.name, 0))
                      for s in self.arch.spaces}
        # source read energy: drain departures in arbitrary (name) order
        # against arrivals; energy only depends on totals per space.
        e = 0.0
        for s in self.arch.spaces:
            e += departures[s.name] * s.mem.read_pj
            e += arrivals[s.name] * s.mem.write_pj
        t_move: Dict[str, float] = {}
        for c in self.arch.clusters:
            t = 0.0
            for s in c.spaces:
                t += arrivals[s.name] * s.mem.write_ns / s.n_modules
                t += departures[s.name] * s.mem.read_ns / s.n_modules
            t_move[c.name] = t
        return t_move, e

    # -- convenience -----------------------------------------------------
    def peak_placement(self, sram_only: bool = True) -> Placement:
        """Minimal-makespan placement (the paper's green/purple dots).

        ``sram_only=True``  : weights in {HP,LP}-SRAM (HH-PIM peak, green),
        ``sram_only=False`` : weights in {HP,LP}-MRAM (H-PIM style, purple).

        Generalized to any cluster count: makespan is balanced across
        all clusters (``x_c`` proportional to ``1/w_c``, remainder in
        the last cluster), which for two clusters reproduces the
        historic split exactly. A single-tier cluster (e.g. the
        far-pool of ``cxl-tier-3``, which has no "sram" space) falls
        back to its one space rather than raising.
        """
        kind = "sram" if sram_only else "mram"
        spaces_ = []
        for c in self.arch.clusters:
            try:
                spaces_.append(c.space(kind))
            except KeyError:
                if len(c.spaces) != 1:
                    raise
                spaces_.append(c.spaces[0])     # single-tier cluster
        # balance makespan: x_a * w_a = x_b * w_b = ..., sum = K
        K = self.model.n_params
        w = [self.weight_time_ns(s) for s in spaces_]
        if len(spaces_) == 1:
            return {spaces_[0].name: K}
        inv = [1.0 / wi for wi in w]
        tot_inv = sum(inv)
        pl: Placement = {}
        acc = 0
        for s, iv in zip(spaces_[:-1], inv[:-1]):
            x = min(int(round(K * iv / tot_inv)), K - acc)
            pl[s.name] = x
            acc += x
        pl[spaces_[-1].name] = K - acc
        return pl
