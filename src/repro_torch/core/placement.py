"""Optimal weight-data placement for HH-PIM (paper SS.III).

Three solvers, cross-validated by the test-suite:

  * :func:`dp_min_energy`        - Algorithm 1, verbatim bottom-up DP
                                   (per-cluster, integer time ticks). Kept
                                   as the float64 reference oracle; the
                                   production ``method="dp"`` path runs
                                   the fused
                                   :mod:`repro_torch.kernels.lut_pipeline` op
                                   (CUDA kernels on the card, their
                                   plain versions on the CPU): all
                                   clusters' stage
                                   tables, the consulted-row gather and
                                   the Algorithm-2 combine in one
                                   launch, backtracing over the op's
                                   returned stage tables.
                                   ``batched=False`` keeps the per-point
                                   :mod:`repro_torch.kernels.knapsack_dp` +
                                   host-fold loop as the byte-identity
                                   reference.
  * :func:`combine_clusters`     - Algorithm 2, combining the per-cluster
                                   tables over (k_hp, k_lp = K - k_hp);
                                   the K=2 entry point of the min-plus
                                   K-cluster fold in
                                   :mod:`repro_torch.core.multipool`, which
                                   both LUT build paths now run so 3+
                                   pool substrates (e.g. ``cxl-tier-3``)
                                   solve through the same code.
  * :class:`ClosedFormSolver`    - beyond-paper fast path: because per-space
                                   (t_i, e_i) are uniform across weights, the
                                   per-cluster optimum lies at an endpoint of
                                   the feasible interval; exact, O(K) per
                                   t-point, and able to include the
                                   volatility-aware static terms that the
                                   paper folds into its measured results.
                                   :meth:`ClosedFormSolver.solve_clusters`
                                   solves the whole t-grid in one
                                   numpy-broadcast call (DESIGN.md SS.6).

The LUT (:class:`PlacementLUT`) is built once at application init (paper:
Algorithms 1+2 "performed only once during the application initialization
phase") and consulted per time slice; :func:`build_lut` defaults to the
batched drivers, with ``batched=False`` keeping the per-point loop as the
byte-identical reference path the equivalence suite checks against.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import spaces as sp
from repro_torch.core.energy import EnergyModel, Placement
from repro_torch.core.multipool import combine_many
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device

INF = float("inf")


# ---------------------------------------------------------------------------
# Algorithm 1 - verbatim DP (per cluster)
# ---------------------------------------------------------------------------


def dp_min_energy(t_items: Sequence[int], e_items: Sequence[float],
                  T: int, K: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bottom-up DP of Eq. (2) / Algorithm 1 (float64 reference oracle).

    The production ``build_lut(method="dp")`` path runs the
    :mod:`repro_torch.kernels.knapsack_dp` op instead; this verbatim numpy
    implementation remains the cross-check the kernel tests compare
    against.

    Args:
      t_items: integer per-item time cost of each storage space (ticks).
      e_items: per-item energy cost of each storage space (pJ).
      T: time-constraint horizon in ticks.
      K: number of items (weights / weight groups) to place.

    Returns:
      dp:    (n+1, T+1, K+1) float array; ``dp[i, t, k]`` = min energy to
             place exactly ``k`` items in the first ``i`` spaces within ``t``.
      count: (n+1, T+1, K+1) int array tracing items taken in space ``i``
             at the optimum (paper's ``count`` path variable).
    """
    n = len(t_items)
    assert n == len(e_items)
    dp = np.full((n + 1, T + 1, K + 1), INF, dtype=np.float64)
    count = np.zeros((n + 1, T + 1, K + 1), dtype=np.int32)
    dp[:, :, 0] = 0.0
    for i in range(1, n + 1):
        ti, ei = int(t_items[i - 1]), float(e_items[i - 1])
        dp[i] = dp[i - 1]        # default: carry forward (t_i*k > t branch)
        count[i] = 0
        if ti > T:
            continue
        for t in range(ti, T + 1):
            # take one more item in space i (vectorized over k)
            cand = dp[i, t - ti, :-1] + ei
            take = cand < dp[i, t, 1:]
            dp[i, t, 1:] = np.where(take, cand, dp[i, t, 1:])
            count[i, t, 1:] = np.where(take, count[i, t - ti, :-1] + 1,
                                       count[i, t, 1:])
    return dp, count


def backtrace(dp: np.ndarray, count: np.ndarray,
              t_items: Sequence[int], t: int, k: int) -> List[int]:
    """Recover per-space item counts ``x_i`` from the DP tables."""
    n = dp.shape[0] - 1
    x = [0] * n
    i = n
    while k > 0 and i > 0:
        c = int(count[i, t, k])
        x[i - 1] = c
        t -= c * int(t_items[i - 1])
        k -= c
        i -= 1
    return x


def backtrace_tables(stages: np.ndarray, t_items: Sequence[int],
                     t: int, k: int) -> List[int]:
    """Recover per-space counts from stacked per-space DP tables.

    ``stages`` is the ``(n+1, T+1, K+1)`` array returned by
    ``repro_torch.kernels.knapsack_dp.ops.knapsack_dp(...,
    return_stages=True)`` (stage 0 is the k=0 base table). The recurrence is
    ``dp_i[t, k] = min(dp_{i-1}[t, k], dp_i[t - t_i, k - 1] + e_i)``, so
    at state ``(i, t, k)`` equality with the previous stage means the
    carry branch was taken (the carried value is copied bit-identically,
    so float equality is exact); otherwise one more item sits in space
    ``i``. Ties prefer the carry branch, matching the ``count`` path
    variable of the verbatim numpy DP.
    """
    n = stages.shape[0] - 1
    x = [0] * n
    i = n
    while k > 0 and i > 0:
        if stages[i, t, k] == stages[i - 1, t, k]:
            i -= 1
            continue
        x[i - 1] += 1
        t -= int(t_items[i - 1])
        k -= 1
        if t < 0:      # inconsistent table: fail loudly, not silently
            raise RuntimeError("backtrace walked below t=0")
    return x


# ---------------------------------------------------------------------------
# Algorithm 2 - combine per-cluster tables
# ---------------------------------------------------------------------------


def combine_clusters(dp_hp: np.ndarray, dp_lp: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Algorithm 2: for every t, find ``k_hp`` minimizing
    ``dp_hp[t, k_hp] + dp_lp[t, K - k_hp]``.

    The pairwise (K=2) entry point of the min-plus fold
    (:func:`repro_torch.core.multipool.combine_many`), which degenerates to
    exactly this scan for two tables - kept as the named Algorithm-2
    API.

    Args:
      dp_hp, dp_lp: final-layer tables of shape (T+1, K+1)
        (i.e. ``dp[n/2]`` of each cluster).

    Returns:
      (min_energy[T+1], k_opt_hp[T+1]); infeasible t rows are +inf / -1.
    """
    min_e, splits = combine_many([dp_hp, dp_lp])
    return min_e, splits[:, 0]


# ---------------------------------------------------------------------------
# Closed-form per-cluster solver (beyond-paper fast path, includes statics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClusterSolution:
    energy_pj: np.ndarray      # (K+1,) min energy for k = 0..K
    x_mram: np.ndarray         # (K+1,) weights in the cluster's MRAM
    busy_ns: np.ndarray        # (K+1,) cluster busy time at optimum


class ClosedFormSolver:
    """Exact per-cluster optimum for uniform per-weight costs.

    For ``k`` weights split ``(x_m, x_s = k - x_m)`` between MRAM and SRAM,
    time and dynamic energy are linear in ``x_m``; the static terms are a
    step function of {x_m > 0, x_s > 0}; so the optimum over each of the four
    usage-subsets lies at an interval endpoint.
    """

    def __init__(self, em: EnergyModel, group: int = 1):
        self.em = em
        self.group = group

    def _space_vectors(self, cluster: sp.ClusterSpec):
        mram = sram = None
        for s in cluster.spaces:
            if s.mem.kind == "mram":
                mram = s
            else:
                sram = s
        return mram, sram

    def _solve_far_only(self, cluster: sp.ClusterSpec,
                        mram: sp.StorageSpace, k: np.ndarray, t_budget):
        """Far-tier-only cluster (a single non-volatile space, e.g. the
        CXL pool of ``cxl-tier-3``): every group lives in the one space,
        so the per-k optimum is the feasibility-masked linear cost.

        ``t_budget`` is a scalar (per-point path) or a (P, 1) column
        (batched path); one shared code path keeps the two byte-equal.
        """
        em, g = self.em, self.group
        tw_m = em.weight_time_ns(mram) * g
        ew_m = em.weight_energy_pj(mram) * g
        cap_m = mram.capacity_weights // g
        busy = k * tw_m                                  # (K+1,)
        valid = (k <= cap_m) & (busy <= t_budget + 1e-9)
        e = k * ew_m
        # non-volatile: on only while its cluster computes
        e = e + np.where(k > 0, mram.static_mw_total * busy, 0.0)
        e = e + cluster.pe_static_mw_total * busy
        e = np.where(valid, e, INF)
        best_xm = np.where(valid, k, 0).astype(np.int64)
        best_busy = np.where(valid, busy, 0.0)
        e[..., 0] = 0.0
        best_busy[..., 0] = 0.0
        best_xm[..., 0] = 0
        return e, best_xm, best_busy

    def solve_cluster(self, cluster: sp.ClusterSpec, K: int,
                      t_budget_ns: float, static_window_ns: float
                      ) -> ClusterSolution:
        em, g = self.em, self.group
        mram, sram = self._space_vectors(cluster)
        k = np.arange(K + 1, dtype=np.float64)       # in groups
        if sram is None:
            return ClusterSolution(*self._solve_far_only(
                cluster, mram, k, t_budget_ns))
        best_e = np.full(K + 1, INF)
        best_xm = np.zeros(K + 1, dtype=np.int64)
        best_busy = np.zeros(K + 1)

        tw_s = em.weight_time_ns(sram) * g
        ew_s = em.weight_energy_pj(sram) * g
        cap_s = sram.capacity_weights // g
        if mram is not None:
            tw_m = em.weight_time_ns(mram) * g
            ew_m = em.weight_energy_pj(mram) * g
            cap_m = mram.capacity_weights // g

        def consider(x_m: np.ndarray) -> None:
            """Evaluate split (x_m, k - x_m); update running best."""
            x_s = k - x_m
            valid = (x_m >= 0) & (x_s >= 0) & (x_s <= cap_s)
            if mram is not None:
                valid &= x_m <= cap_m
            busy = (x_m * (tw_m if mram is not None else 0.0) + x_s * tw_s)
            valid &= busy <= t_budget_ns + 1e-9
            e = x_m * (ew_m if mram is not None else 0.0) + x_s * ew_s
            # statics: SRAM-on-holding for the window; MRAM/IO/PE while busy
            e = e + np.where(x_s > 0, sram.static_mw_total * static_window_ns,
                             sram.static_mw_total * busy)
            if mram is not None:
                e = e + np.where(x_m > 0, mram.static_mw_total * busy, 0.0)
            e = e + cluster.pe_static_mw_total * busy
            e = np.where(valid, e, INF)
            upd = e < best_e
            best_e[upd] = e[upd]
            best_xm[upd] = x_m[upd].astype(np.int64)
            best_busy[upd] = busy[upd]

        zeros = np.zeros(K + 1)
        if mram is None:
            consider(zeros)                          # all in SRAM
        else:
            consider(zeros)                          # all SRAM
            consider(k.copy())                       # all MRAM
            # mixed: feasible x_m interval endpoints given the time budget.
            #   busy(x_m) = x_m*tw_m + (k-x_m)*tw_s <= t_budget
            if abs(tw_m - tw_s) < 1e-12:
                pass                                 # linear in x_m is flat
            elif tw_m > tw_s:
                xm_hi = np.floor((t_budget_ns - k * tw_s) / (tw_m - tw_s))
                consider(np.clip(xm_hi, 0, k))
                consider(np.clip(xm_hi - 1, 0, k))   # guard rounding
                consider(np.minimum(np.ones(K + 1), k))
                consider(np.maximum(k - 1, zeros))
            else:
                xm_lo = np.ceil((k * tw_s - t_budget_ns) / (tw_s - tw_m))
                consider(np.clip(xm_lo, 0, k))
                consider(np.clip(xm_lo + 1, 0, k))
                consider(np.minimum(np.ones(K + 1), k))
                consider(np.maximum(k - 1, zeros))
            # capacity endpoints
            consider(np.minimum(k, float(cap_m)))
            consider(np.maximum(k - float(cap_s), zeros))
        best_e[0] = 0.0
        best_busy[0] = 0.0
        best_xm[0] = 0
        return ClusterSolution(best_e, best_xm, best_busy)

    def solve_clusters(self, cluster: sp.ClusterSpec, K: int,
                       t_budgets_ns: Sequence[float],
                       static_windows_ns: Sequence[float]
                       ) -> "BatchedClusterSolution":
        """Vectorized :meth:`solve_cluster` over a whole t-grid.

        One numpy-broadcast call evaluates every candidate split for all
        ``P = len(t_budgets_ns)`` budgets at once - the manual vmap of
        the per-point solver over the constraint axis. All arithmetic is
        the same float64 elementwise expressions in the same order, so
        row ``p`` is bit-identical to
        ``solve_cluster(cluster, K, t_budgets_ns[p], static_windows_ns[p])``
        (asserted by the batched-vs-loop equivalence suite).
        """
        em, g = self.em, self.group
        mram, sram = self._space_vectors(cluster)
        t_b = np.asarray(t_budgets_ns, np.float64).reshape(-1, 1)
        win = np.asarray(static_windows_ns, np.float64).reshape(-1, 1)
        P = t_b.shape[0]
        k = np.arange(K + 1, dtype=np.float64)       # in groups
        if sram is None:
            return BatchedClusterSolution(*self._solve_far_only(
                cluster, mram, k, t_b))
        K1 = K + 1
        best_e = np.full((P, K1), INF)
        best_xm = np.zeros((P, K1), dtype=np.int64)
        best_busy = np.zeros((P, K1))

        tw_s = em.weight_time_ns(sram) * g
        ew_s = em.weight_energy_pj(sram) * g
        cap_s = sram.capacity_weights // g
        if mram is not None:
            tw_m = em.weight_time_ns(mram) * g
            ew_m = em.weight_energy_pj(mram) * g
            cap_m = mram.capacity_weights // g

        def consider(x_m: np.ndarray) -> None:
            """Evaluate split (x_m, k - x_m) for every budget row."""
            x_s = k - x_m                  # (K1,) or (P, K1)
            valid = (x_m >= 0) & (x_s >= 0) & (x_s <= cap_s)
            if mram is not None:
                valid = valid & (x_m <= cap_m)
            busy = (x_m * (tw_m if mram is not None else 0.0) + x_s * tw_s)
            valid = valid & (busy <= t_b + 1e-9)
            e = x_m * (ew_m if mram is not None else 0.0) + x_s * ew_s
            # statics: SRAM-on-holding for the window; MRAM/IO/PE while busy
            e = e + np.where(x_s > 0, sram.static_mw_total * win,
                             sram.static_mw_total * busy)
            if mram is not None:
                e = e + np.where(x_m > 0, mram.static_mw_total * busy, 0.0)
            e = e + cluster.pe_static_mw_total * busy
            e = np.where(valid, e, INF)
            upd = e < best_e
            xb = np.broadcast_to(np.asarray(x_m, np.float64), (P, K1))
            bb = np.broadcast_to(busy, (P, K1))
            best_e[upd] = e[upd]
            best_xm[upd] = xb[upd].astype(np.int64)
            best_busy[upd] = bb[upd]

        zeros = np.zeros(K + 1)
        if mram is None:
            consider(zeros)                          # all in SRAM
        else:
            consider(zeros)                          # all SRAM
            consider(k.copy())                       # all MRAM
            # mixed: feasible x_m interval endpoints given the time budget.
            if abs(tw_m - tw_s) < 1e-12:
                pass                                 # linear in x_m is flat
            elif tw_m > tw_s:
                xm_hi = np.floor((t_b - k * tw_s) / (tw_m - tw_s))
                consider(np.clip(xm_hi, 0, k))
                consider(np.clip(xm_hi - 1, 0, k))   # guard rounding
                consider(np.minimum(np.ones(K + 1), k))
                consider(np.maximum(k - 1, zeros))
            else:
                xm_lo = np.ceil((k * tw_s - t_b) / (tw_s - tw_m))
                consider(np.clip(xm_lo, 0, k))
                consider(np.clip(xm_lo + 1, 0, k))
                consider(np.minimum(np.ones(K + 1), k))
                consider(np.maximum(k - 1, zeros))
            # capacity endpoints
            consider(np.minimum(k, float(cap_m)))
            consider(np.maximum(k - float(cap_s), zeros))
        best_e[:, 0] = 0.0
        best_busy[:, 0] = 0.0
        best_xm[:, 0] = 0
        return BatchedClusterSolution(best_e, best_xm, best_busy)


@dataclasses.dataclass
class BatchedClusterSolution:
    """Per-cluster optima for a batch of time budgets; row ``p`` of every
    array equals the :class:`ClusterSolution` of the p-th budget."""

    energy_pj: np.ndarray      # (P, K+1)
    x_mram: np.ndarray         # (P, K+1) int64
    busy_ns: np.ndarray        # (P, K+1)

    def row(self, p: int) -> ClusterSolution:
        return ClusterSolution(self.energy_pj[p], self.x_mram[p],
                               self.busy_ns[p])


# ---------------------------------------------------------------------------
# LUT builder (paper: init-time Algorithms 1+2 -> allocation_state)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LUTEntry:
    t_constraint_ns: float
    placement: Placement
    e_task_pj: float            # model-predicted per-task energy
    t_task_ns: float
    feasible: bool


def _peak_entry(em: EnergyModel, static_window_ns: Optional[float] = None
                ) -> LUTEntry:
    """Exact (ungrouped) minimal-makespan entry - the paper's green dot."""
    pl = em.peak_placement(sram_only=True)
    tc = em.task_cost(pl)
    window = static_window_ns if static_window_ns is not None else tc.t_task_ns
    e_task = tc.e_dyn_task_pj + em.static_energy_pj(pl, window,
                                                    tc.t_cluster_ns)
    return LUTEntry(tc.t_task_ns, pl, float(e_task), tc.t_task_ns, True)


def _insert_entry(entries: List[LUTEntry], e: LUTEntry) -> List[LUTEntry]:
    out = [x for x in entries if abs(x.t_constraint_ns - e.t_constraint_ns)
           > 1e-6]
    out.append(e)
    out.sort(key=lambda x: x.t_constraint_ns)
    return out


@dataclasses.dataclass
class PlacementLUT:
    arch_name: str
    model_name: str
    entries: List[LUTEntry]
    # device type ("cuda" / "cpu") the lut_pipeline op built the entries
    # on (None for the host paths); informational only - both are
    # byte-identical, so it never participates in equality
    backend: Optional[str] = dataclasses.field(default=None, compare=False)

    def lookup(self, t_constraint_ns: float) -> LUTEntry:
        """Largest grid point <= t_constraint (placement remains feasible)."""
        best: Optional[LUTEntry] = None
        tol = t_constraint_ns * 1e-9 + 1e-3   # relative + absolute (ns)
        for e in self.entries:
            if e.t_constraint_ns <= t_constraint_ns + tol and e.feasible:
                best = e
        if best is None:
            # infeasible budget: fall back to the fastest placement we have
            for e in self.entries:
                if e.feasible:
                    return e
            raise RuntimeError("LUT has no feasible entries")
        return best

    @property
    def min_feasible_t_ns(self) -> float:
        for e in self.entries:
            if e.feasible:
                return e.t_constraint_ns
        return INF


def _counts_to_placement(arch: sp.PIMArch, model: sp.ModelSpec,
                         counts: Mapping[str, int], group: int) -> Placement:
    """Scale group counts back to weights; absorb rounding in largest slot."""
    pl = {k: int(v) * group for k, v in counts.items()}
    diff = model.n_params - sum(pl.values())
    if diff:
        kmax = max(pl, key=lambda k: pl[k])
        pl[kmax] += diff
    return pl


# Measured per-cell cost of the BATCHED closed-form build (the lut_build
# benchmark suite records the current number): one cell = one (t-point,
# k-group, space) triple. Measured ~200 ns/cell at the default
# (64 points x 256 groups x 4 spaces) resolution; the per-point loop it
# replaced measures ~1 us/cell on the same core (the old 25 ns/cell
# default encoded only the DP inner loop, not the full per-point build,
# so it overshot the paper's 1% budget by ~40x).
BATCHED_COST_PER_CELL_NS = 200.0


def auto_resolution(model: sp.ModelSpec, t_slice_ns: float, *,
                    budget_fraction: float = 0.01,
                    cost_per_cell_ns: float = BATCHED_COST_PER_CELL_NS,
                    n_spaces: int = 4) -> Tuple[int, int]:
    """Paper SS.III.B: limit optimization resolution so the init-time LUT
    build costs at most ``budget_fraction`` of one time slice.

    The build is O(n * T * K) cells; with the measured per-cell cost of
    the batched solver (~``cost_per_cell_ns``), choose
    (n_points, k_groups) maximizing resolution within the budget.

    Returns (n_points, k_groups).
    """
    budget_cells = max(t_slice_ns * budget_fraction / cost_per_cell_ns, 64)
    # keep the T:K aspect ratio ~8:1 (time needs finer resolution than
    # group count - placements are piecewise constant in k)
    k = int(np.sqrt(budget_cells / (8.0 * n_spaces)))
    k_groups = int(min(max(k, 8), model.n_params))
    n_points = int(min(max(budget_cells / (n_spaces * k_groups), 8), 512))
    return n_points, k_groups


def _entry_fns(arch: sp.PIMArch, model: sp.ModelSpec, em: EnergyModel,
               group: int, t_slice_ns: float, static_window: str):
    """Per-build grid-point finalizers, shared by every solver driver
    (closed-form / per-point dp / fused dp / clock-grid batched) so all
    of them stay byte-identical past these lines."""
    pl_peak = em.peak_placement(sram_only=True)
    tc_peak = em.task_cost(pl_peak)

    def _window(t_c: float) -> float:
        return t_c if static_window == "t_constraint" else t_slice_ns

    def _entry(t_c: float, feasible: bool,
               counts: Mapping[str, int]) -> LUTEntry:
        window = _window(t_c)
        if feasible:
            pl = _counts_to_placement(arch, model, counts, group)
            tc = em.task_cost(pl)
            e_task = tc.e_dyn_task_pj + em.static_energy_pj(
                pl, window, tc.t_cluster_ns)
            return LUTEntry(float(t_c), pl, float(e_task), tc.t_task_ns,
                            True)
        if t_c >= tc_peak.t_task_ns:
            # grid point infeasible at group granularity but >= the exact
            # peak time: fall back to the exact peak placement
            e_task = tc_peak.e_dyn_task_pj + em.static_energy_pj(
                pl_peak, window, tc_peak.t_cluster_ns)
            return LUTEntry(float(t_c), dict(pl_peak), float(e_task),
                            tc_peak.t_task_ns, True)
        return LUTEntry(float(t_c), {}, INF, INF, False)

    return _window, _entry, tc_peak


@dataclasses.dataclass
class _DPProblem:
    """One build's Algorithm-1 discretization, ready for the fused op.

    ``t_items``/``e_items`` are (C, n_max) arrays, ragged clusters
    inert-padded with ``(t=1, e=+inf)`` - an infinite-cost space folds
    to a bitwise copy of the previous stage, so padding changes no byte
    of any table (and ``backtrace_tables`` walks padded stages through
    its carry branch). ``items`` keeps the real unpadded per-cluster
    lists for the per-point reference path.
    """

    T: int
    tick_ns: float
    t_grid: np.ndarray
    rows: np.ndarray                               # (R,) consulted tick rows
    t_items: np.ndarray                            # (C, n_max) int32
    e_items: np.ndarray                            # (C, n_max) float32
    items: Dict[str, Tuple[List[int], List[float]]]
    padded_t_lists: Dict[str, List[int]]


def _dp_problem(em: EnergyModel, arch: sp.PIMArch, group: int,
                t_slice_ns: float, dp_ticks: int,
                t_grid: np.ndarray) -> _DPProblem:
    tick_ns = t_slice_ns / float(dp_ticks)
    # The DP ceils each item's time to whole ticks, so an item spanning
    # ~1 tick is inflated by up to 100% and the DP turns conservative.
    # Edge archs put a weight group at tens of ticks; the serving pools
    # (HBM-resident weights, sub-ns per-weight times) do not - refine the
    # tick until the smallest item spans >= 8 ticks (<= 12.5% inflation),
    # capped so the O(n*T*K) tables stay affordable.
    min_item_ns = min((em.weight_time_ns(s) * group
                       for c in arch.clusters for s in c.spaces
                       if em.weight_time_ns(s) > 0), default=0.0)
    if min_item_ns and min_item_ns / tick_ns < 8:
        tick_ns = min_item_ns / 8
    T = min(int(math.ceil(t_slice_ns / tick_ns)), 16384)
    tick_ns = t_slice_ns / T
    items: Dict[str, Tuple[List[int], List[float]]] = {}
    for c in arch.clusters:
        # ceil => DP never underestimates a placement's true execution time
        t_list = [max(1, int(math.ceil(em.weight_time_ns(s) * group
                                       / tick_ns - 1e-9)))
                  for s in c.spaces]
        e_list = [em.weight_energy_pj(s) * group for s in c.spaces]
        items[c.name] = (t_list, e_list)
    n_max = max(len(c.spaces) for c in arch.clusters)
    t_arr = np.ones((len(arch.clusters), n_max), np.int32)
    e_arr = np.full((len(arch.clusters), n_max), np.inf, np.float32)
    padded: Dict[str, List[int]] = {}
    for ci, c in enumerate(arch.clusters):
        t_list, e_list = items[c.name]
        t_arr[ci, :len(t_list)] = t_list
        e_arr[ci, :len(e_list)] = e_list
        padded[c.name] = t_list + [1] * (n_max - len(t_list))
    rows = np.asarray([int(t_c / tick_ns) for t_c in t_grid], np.int32)
    return _DPProblem(T, tick_ns, t_grid, rows, t_arr, e_arr, items, padded)


def _host(x: torch.Tensor) -> np.ndarray:
    """A device result as a host numpy array (the backtrace walks it)."""
    return x.cpu().numpy()


def _dp_entries(arch: sp.PIMArch, prob: _DPProblem, stages: np.ndarray,
                min_e: np.ndarray, splits: np.ndarray,
                entry_fn) -> List[LUTEntry]:
    """Finalize every grid point from one variant's fused-op results:
    per-cluster stage-table backtrace at that cluster's split share,
    then the shared entry finalizer."""
    entries: List[LUTEntry] = []
    for i, t_c in enumerate(prob.t_grid):
        t_ticks = int(prob.rows[i])
        feasible = bool(np.isfinite(min_e[i]))
        counts: Dict[str, int] = {}
        if feasible:
            for ci, (c, k_c) in enumerate(zip(arch.clusters, splits[i])):
                xs = backtrace_tables(stages[ci],
                                      prob.padded_t_lists[c.name],
                                      t_ticks, int(k_c))
                for s, x in zip(c.spaces, xs):
                    counts[s.name] = x
        entries.append(entry_fn(t_c, feasible, counts))
    return entries


def build_lut(arch: sp.PIMArch, model: sp.ModelSpec, *,
              t_slice_ns: float, n_points: int = 64, rho: float = 1.0,
              method: str = "closed_form", k_groups: int = 256,
              static_window: str = "t_constraint",
              em: Optional[EnergyModel] = None, batched: bool = True,
              device=DEFAULT_DEVICE,
              dp_ticks: int = 2048) -> PlacementLUT:
    """Construct ``allocation_state`` - the init-time placement LUT.

    ``method="closed_form"`` uses :class:`ClosedFormSolver` (exact, with
    statics); ``method="dp"`` runs Algorithms 1+2 on the dynamic energies
    through the fused :mod:`repro_torch.kernels.lut_pipeline` op - per-cluster
    stage tables, consulted-row gather and the min-plus combine with
    argmin backtrace in one device pass. ``device`` is where that pass
    runs: ``"cuda"`` (the default) launches the CUDA kernels and raises
    without a card, ``"cpu"`` runs their plain versions.

    ``batched=True`` (default) solves the whole t-grid in one vectorized
    pass per cluster; ``batched=False`` keeps the per-point loop (the
    unfused :mod:`repro_torch.kernels.knapsack_dp` op plus the host numpy
    fold), which must produce byte-identical LUTs (asserted by the
    equivalence suites in tests/test_api.py and
    tests/test_torch_placement.py). An explicit ``em`` (e.g. with straggler
    ``time_scale``) overrides the default model.
    """
    dev = resolve_device(device)
    em = em or EnergyModel(arch, model, rho=rho)
    K = model.n_params
    group = max(1, math.ceil(K / k_groups))
    Kg = math.ceil(K / group)
    _window, _entry, tc_peak = _entry_fns(arch, model, em, group,
                                          t_slice_ns, static_window)
    t_grid = np.linspace(t_slice_ns / n_points, t_slice_ns, n_points)
    # always include the exact peak-performance point (the paper's green
    # dot), otherwise full-load lookups land on a coarser, slower entry.
    if tc_peak.t_task_ns <= t_slice_ns:
        t_grid = np.unique(np.concatenate([t_grid, [tc_peak.t_task_ns]]))

    def _split_counts(sols: Mapping[str, ClusterSolution],
                      split: Sequence[int]) -> Dict[str, int]:
        """Per-space group counts from a per-cluster split (the
        :func:`repro_torch.core.multipool.combine_many` backtrace row)."""
        counts: Dict[str, int] = {}
        for c, k_c in zip(arch.clusters, split):
            sol = sols[c.name]
            ksel = int(k_c)
            xm = int(sol.x_mram[ksel])
            for s in c.spaces:
                counts[s.name] = xm if s.mem.kind == "mram" else ksel - xm
        return counts

    entries: List[LUTEntry] = []
    if method == "closed_form":
        solver = ClosedFormSolver(em, group=group)
        if batched:
            windows = np.asarray([_window(t_c) for t_c in t_grid])
            batch = {c.name: solver.solve_clusters(c, Kg, t_grid, windows)
                     for c in arch.clusters}
            # K-pool optimum over the simplex of per-cluster splits: the
            # min-plus fold over every cluster's (P, K+1) energy table
            min_e, splits = combine_many(
                [batch[c.name].energy_pj for c in arch.clusters])
            for i, t_c in enumerate(t_grid):
                feasible = bool(np.isfinite(min_e[i]))
                counts: Dict[str, int] = {}
                if feasible:
                    sols = {name: b.row(i) for name, b in batch.items()}
                    counts = _split_counts(sols, splits[i])
                entries.append(_entry(t_c, feasible, counts))
        else:
            for t_c in t_grid:
                sols = {c.name: solver.solve_cluster(c, Kg, t_c,
                                                     _window(t_c))
                        for c in arch.clusters}
                m_e, s_row = combine_many(
                    [sols[c.name].energy_pj[None, :]
                     for c in arch.clusters])
                feasible = bool(np.isfinite(m_e[0]))
                counts = _split_counts(sols, s_row[0]) if feasible else {}
                entries.append(_entry(t_c, feasible, counts))
        entries = _insert_entry(entries, _peak_entry(
            em, None if static_window == "t_constraint" else t_slice_ns))
        return PlacementLUT(arch.name, model.name, entries)

    if method != "dp":
        raise ValueError(method)

    # -- Algorithm 1 + 2 path ----------------------------------------------
    prob = _dp_problem(em, arch, group, t_slice_ns, dp_ticks, t_grid)

    if batched:
        # Fused pipeline: every cluster's stage tables, the consulted
        # t-grid row gather AND the min-plus combine with argmin
        # backtrace in one device pass. The fold is row-local, so
        # combining only the consulted tick rows is byte-identical to
        # combining the full tables and indexing after - the per-point
        # path below does exactly that against the same tables.
        from repro_torch.kernels.lut_pipeline.ops import lut_build
        stages, min_e_all, splits_all = lut_build(
            prob.t_items[None], prob.e_items[None], prob.T, Kg, prob.rows,
            device=dev)
        entries = _dp_entries(arch, prob, _host(stages[0]),
                              _host(min_e_all[0]), _host(splits_all[0]),
                              _entry)
        entries = _insert_entry(entries, _peak_entry(
            em, None if static_window == "t_constraint" else t_slice_ns))
        return PlacementLUT(arch.name, model.name, entries,
                            backend=dev.type)

    # Per-point reference loop: the unfused knapsack op plus the host
    # numpy fold per grid point - the byte-identity anchor the fused
    # path is asserted against.
    from repro_torch.kernels.knapsack_dp.ops import knapsack_dp

    stage_tables: Dict[str, np.ndarray] = {}
    for c in arch.clusters:
        t_list, e_list = prob.items[c.name]
        stage_tables[c.name] = _host(knapsack_dp(
            t_list, e_list, prob.T, Kg, device=dev, return_stages=True))
    finals = [stage_tables[c.name][-1] for c in arch.clusters]
    for i, t_c in enumerate(prob.t_grid):
        t_ticks = int(prob.rows[i])
        m_e, s_row = combine_many([f[t_ticks:t_ticks + 1] for f in finals])
        min_e, split = m_e[0], s_row[0]
        feasible = bool(np.isfinite(min_e))
        counts: Dict[str, int] = {}
        if feasible:
            # per-cluster stage-table backtrace at that cluster's share
            for c, k_c in zip(arch.clusters, split):
                xs = backtrace_tables(stage_tables[c.name],
                                      prob.items[c.name][0],
                                      t_ticks, int(k_c))
                for s, x in zip(c.spaces, xs):
                    counts[s.name] = x
        entries.append(_entry(t_c, feasible, counts))
    entries = _insert_entry(entries, _peak_entry(
        em, None if static_window == "t_constraint" else t_slice_ns))
    return PlacementLUT(arch.name, model.name, entries)


def build_lut_grid(ems: Sequence[EnergyModel], *, t_slice_ns: float,
                   n_points: int = 64, method: str = "dp",
                   k_groups: int = 256,
                   static_window: str = "t_constraint",
                   device=DEFAULT_DEVICE,
                   dp_ticks: int = 2048) -> List[PlacementLUT]:
    """Batched LUT builds across substrate variants (DESIGN.md SS.6/SS.10).

    For a DVFS clock grid every variant shares the model and cluster
    topology but scales its energies/times, so the Algorithm-1 + 2
    pipeline is the same shape per variant. Variants whose DP
    discretization agrees (same tick horizon ``T``, group count and
    grid size) are stacked on the fused op's variant axis and solved in
    ONE device pass; the rest get one pass each. Each
    returned LUT is byte-identical to ``build_lut(em.arch, em.model,
    em=em, method="dp", ...)`` for the matching variant.

    Non-dp methods delegate to :func:`build_lut` per variant.
    """
    if method != "dp":
        return [build_lut(em.arch, em.model, t_slice_ns=t_slice_ns,
                          n_points=n_points, method=method,
                          k_groups=k_groups, static_window=static_window,
                          em=em, device=device, dp_ticks=dp_ticks)
                for em in ems]
    from repro_torch.kernels.lut_pipeline.ops import lut_build
    dev = resolve_device(device)

    preps = []
    for em in ems:
        arch, model = em.arch, em.model
        K = model.n_params
        group = max(1, math.ceil(K / k_groups))
        Kg = math.ceil(K / group)
        _window, _entry, tc_peak = _entry_fns(arch, model, em, group,
                                              t_slice_ns, static_window)
        t_grid = np.linspace(t_slice_ns / n_points, t_slice_ns, n_points)
        if tc_peak.t_task_ns <= t_slice_ns:
            t_grid = np.unique(np.concatenate([t_grid,
                                               [tc_peak.t_task_ns]]))
        prob = _dp_problem(em, arch, group, t_slice_ns, dp_ticks, t_grid)
        preps.append((em, arch, Kg, prob, _entry))

    groups: Dict[tuple, List[int]] = {}
    for idx, (em, arch, Kg, prob, _entry) in enumerate(preps):
        key = (prob.T, Kg, len(prob.rows), prob.t_items.shape)
        groups.setdefault(key, []).append(idx)

    luts: List[Optional[PlacementLUT]] = [None] * len(preps)
    for (T, Kg_g, _, _), idxs in groups.items():
        # three spans split one group's build: the host enqueueing the
        # device pass, the stage-table copy to the host the backtrace
        # walks (which also waits for the pass; a profile puts the
        # pass's device time down to the first span, where it was
        # launched), and the host finalize
        with obs.span("placement.lut_grid.kernel", "placement",
                      n_variants=len(idxs), device=dev.type):
            stages, min_e, splits = lut_build(
                np.stack([preps[i][3].t_items for i in idxs]),
                np.stack([preps[i][3].e_items for i in idxs]),
                T, Kg_g, np.stack([preps[i][3].rows for i in idxs]),
                device=dev)
        with obs.span("placement.lut_grid.d2h", "placement",
                      bytes=stages.numel() * stages.element_size()):
            stages, min_e, splits = map(_host, (stages, min_e, splits))
        with obs.span("placement.lut_grid.finalize", "placement"):
            for v, i in enumerate(idxs):
                em, arch, Kg, prob, _entry = preps[i]
                entries = _dp_entries(arch, prob, stages[v], min_e[v],
                                      splits[v], _entry)
                entries = _insert_entry(entries, _peak_entry(
                    em, None if static_window == "t_constraint"
                    else t_slice_ns))
                luts[i] = PlacementLUT(arch.name, em.model.name, entries,
                                       backend=dev.type)
    return luts
