"""The placement LUTs of a DVFS bring-up on a GPU SM-pool substrate,
worked out again in plain Python and NumPy (a frozen copy of the
arithmetic, not of the program's code paths).

A DVFS bring-up on a ``gpu-pool`` substrate builds one LUT per point of its
clock grid. At clock ``c`` the arch is an HP pool of SM clusters at the
full clock and an LP pool at ``c`` with switching energy ``V^2``
(``V = 0.45 + 0.55 c`` of nominal), each with two residency spaces: int8
("mram": 1 byte a use plus a dequant, may sleep) and bf16 ("sram": 2
bytes a use, pinned). One weight in a space costs ``ops_per_weight *
(io_read + mem_read / rho + mac)`` ns over the pool's clusters and
``ops_per_weight * (io_read_pj + mem_read_pj / rho + mac_pj)`` pJ.

A LUT is Algorithm 1 (per pool, the knapsack over the pool's spaces in
integer time ticks, float32 tables) and Algorithm 2 (the min-plus
combine of the two pools' final tables at the grid's consulted rows,
first minimum), each grid point's placement backtraced from the stage
tables and scaled from weight groups to weights, its energy the dynamic
energy plus the static energy over the slice; the exact peak placement
is inserted as its own entry.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

INF = float("inf")

# SM-cluster pool constants of the gpu-pool substrate (per cluster of 16
# SMs)
PEAK_FLOPS = 46e12
HBM_BW = 250e9
HBM_PJ_PER_BYTE = 6.5
MAC_PJ = 1.1
DEQUANT_PJ = 0.3
IDLE_W = 3.5
SLEEP_W = 0.5
V_MIN_FRAC = 0.45
DVFS_MIN, DVFS_MAX = 0.30, 1.00
CLOCK_DECIMALS = 4


class Space:
    def __init__(self, name: str, cluster: str, kind: str, clock: float,
                 energy: float, n_modules: int, mac_ns: float,
                 mac_mw: float):
        self.name, self.cluster, self.kind = name, cluster, kind
        self.n_modules = n_modules
        self.mem = _mem(kind, clock, energy)
        self.io = _mem("sram", clock, energy)
        self.mac_ns, self.mac_mw = mac_ns, mac_mw

    def op_ns(self, rho: float) -> float:
        return self.io["read_ns"] + self.mem["read_ns"] / rho + self.mac_ns

    def op_pj(self, rho: float) -> float:
        return (self.io["read_ns"] * self.io["read_mw"]
                + self.mem["read_ns"] * self.mem["read_mw"] / rho
                + self.mac_ns * self.mac_mw)

    @property
    def static_mw_total(self) -> float:
        return self.mem["static_mw"] * 1 * self.n_modules


def _mem(kind: str, clock: float, energy: float) -> dict:
    per_use = 1 if kind == "mram" else 2
    read_ns = per_use / HBM_BW / clock * 1e9
    write_ns = 4 * read_ns
    read_pj = per_use * HBM_PJ_PER_BYTE * energy
    if kind == "mram":
        read_pj += DEQUANT_PJ * energy
    static_w = SLEEP_W if kind == "mram" else IDLE_W
    return {"read_ns": read_ns, "write_ns": write_ns,
            "read_mw": read_pj / read_ns,
            "static_mw": static_w * 1e3 * energy,
            "volatile": kind == "sram"}


def energy_scale(clock: float) -> float:
    v = V_MIN_FRAC + (1.0 - V_MIN_FRAC) * clock
    return v * v


def clock_grid(n_clocks: int, include: Sequence[float]) -> List[float]:
    step = (DVFS_MAX - DVFS_MIN) / (n_clocks - 1)
    pts = [DVFS_MIN + i * step for i in range(n_clocks)]
    pts.extend(min(max(float(c), DVFS_MIN), DVFS_MAX) for c in include)
    seen: Dict[float, float] = {}
    for p in pts:
        seen.setdefault(round(p, CLOCK_DECIMALS), p)
    return [seen[k] for k in sorted(seen)]


def arch(n_hp: int, n_lp: int, lp_clock: float) -> List[Tuple[str, int, List[Space]]]:
    """[(pool, modules, [mram space, sram space])] at ``lp_clock``."""
    out = []
    for name, n, clock, energy in (("hp", n_hp, 1.0, 1.0),
                                   ("lp", n_lp, lp_clock,
                                    energy_scale(lp_clock))):
        op_ns = 2.0 / PEAK_FLOPS / clock * 1e9
        mac_mw = MAC_PJ * energy / op_ns
        out.append((name, n, [Space(f"{name}_{k}", name, k, clock, energy,
                                    n, op_ns, mac_mw)
                              for k in ("mram", "sram")]))
    return out


class Model:
    """Weights a placement divides (FFN and attention matrices) and the
    MACs of one task: ``tokens_per_task`` decoded tokens."""

    def __init__(self, c: dict, tokens_per_task: int):
        d, L = c["d_model"], c["n_layers"]
        self.n_params = L * 3 * d * c["d_ff"] + L * 4 * d * d
        n_macs = self.n_params * tokens_per_task
        self.ops_per_weight = int(round(n_macs * 1.0)) / self.n_params


class Energy:
    def __init__(self, pools, model: Model, rho: float):
        self.pools, self.model, self.rho = pools, model, float(rho)

    def wt(self, s: Space) -> float:
        return (self.model.ops_per_weight * s.op_ns(self.rho) * 1.0
                / s.n_modules)

    def we(self, s: Space) -> float:
        return self.model.ops_per_weight * s.op_pj(self.rho)

    def task_cost(self, pl: Dict[str, int]):
        t_cluster: Dict[str, float] = {}
        e_dyn = 0.0
        for name, _, spaces in self.pools:
            t_c = 0.0
            for s in spaces:
                x = pl.get(s.name, 0)
                if x:
                    t_c += x * self.wt(s)
                    e_dyn += x * self.we(s)
            t_cluster[name] = t_c
        return max(t_cluster.values()), t_cluster, e_dyn

    def static_pj(self, pl: Dict[str, int], window: float,
                  busy_ns: Dict[str, float]) -> float:
        e = 0.0
        for name, n, spaces in self.pools:
            busy = min(busy_ns.get(name, 0.0), window)
            e += 0.0 * n * busy
            for s in spaces:
                if s.mem["volatile"] and pl.get(s.name, 0) > 0:
                    e += s.static_mw_total * window
                else:
                    e += s.static_mw_total * busy
        return e

    def move_ns(self, old: Dict[str, int], new: Dict[str, int]
                ) -> Dict[str, float]:
        """Per pool, the time to write the weights that arrive in each
        space and read those that leave it."""
        out = {}
        for name, _, spaces in self.pools:
            t = 0.0
            for s in spaces:
                arrive = max(0, new.get(s.name, 0) - old.get(s.name, 0))
                leave = max(0, old.get(s.name, 0) - new.get(s.name, 0))
                t += arrive * s.mem["write_ns"] / s.n_modules
                t += leave * s.mem["read_ns"] / s.n_modules
            out[name] = t
        return out

    def peak(self) -> Dict[str, int]:
        spaces = [sp for _, _, ss in self.pools for sp in ss
                  if sp.kind == "sram"]
        K = self.model.n_params
        inv = [1.0 / self.wt(s) for s in spaces]
        tot = sum(inv)
        pl, acc = {}, 0
        for s, iv in zip(spaces[:-1], inv[:-1]):
            x = min(int(round(K * iv / tot)), K - acc)
            pl[s.name] = x
            acc += x
        pl[spaces[-1].name] = K - acc
        return pl

    def entry(self, t_c: float, pl: Dict[str, int], window: float):
        t_task, t_cl, e_dyn = self.task_cost(pl)
        return (float(t_c), dict(pl),
                float(e_dyn + self.static_pj(pl, window, t_cl)), t_task, True)


def default_t_slice_ns(c: dict, sub: dict) -> float:
    """The substrate's default slice: ``peak_tasks`` tasks at the peak
    placement, plus 1 %."""
    em = Energy(arch(sub["n_hp_clusters"], sub["n_lp_clusters"],
                     sub["lp_clock"]),
                Model(c, sub["tokens_per_task"]), sub["rho"])
    t_peak = em.task_cost(em.peak())[0]
    return t_peak * sub["peak_tasks"] * 1.01 / 1e6 * 1e6


def stage_tables(t_list: Sequence[int], e_list: Sequence[float], T: int,
                 K: int) -> np.ndarray:
    """Algorithm 1 for one pool: (n+1, T+1, K+1) float32 tables,
    ``dp_i[t, k] = min(dp_{i-1}[t, k], dp_i[t - t_i, k - 1] + e_i)``."""
    out = np.full((len(t_list) + 1, T + 1, K + 1), np.inf, np.float32)
    out[0, :, 0] = 0.0
    for i, (ti, ei) in enumerate(zip(t_list, e_list)):
        cur = out[i + 1]
        cur[:] = out[i]
        e = np.float32(ei)
        for t0 in range(ti, T + 1, ti):
            t1 = min(t0 + ti, T + 1)
            cur[t0:t1, 1:] = np.minimum(
                cur[t0:t1, 1:], cur[t0 - ti:t1 - ti, :-1] + e)
    return out


def backtrace(stages: np.ndarray, t_list: Sequence[int], t: int,
              k: int) -> List[int]:
    n = stages.shape[0] - 1
    x, i = [0] * n, n
    while k > 0 and i > 0:
        if stages[i, t, k] == stages[i - 1, t, k]:
            i -= 1
            continue
        x[i - 1] += 1
        t -= int(t_list[i - 1])
        k -= 1
    return x


def problem(c: dict, sub: dict, lp_clock: float, t_slice_ns: float) -> dict:
    """One clock point's discretization: the energy model, the weight
    group, the t-grid, the tick horizon ``T``, the group count ``K``,
    the consulted rows and each pool's item ticks and energies."""
    pools = arch(sub["n_hp_clusters"], sub["n_lp_clusters"], lp_clock)
    model = Model(c, sub["tokens_per_task"])
    em = Energy(pools, model, sub["rho"])
    group = max(1, math.ceil(model.n_params / sub["k_groups"]))
    pl_peak = em.peak()
    t_peak = em.task_cost(pl_peak)[0]
    n_points = sub["lut_points"]
    t_grid = np.linspace(t_slice_ns / n_points, t_slice_ns, n_points)
    if t_peak <= t_slice_ns:
        t_grid = np.unique(np.concatenate([t_grid, [t_peak]]))
    tick = t_slice_ns / float(sub["dp_ticks"])
    min_item = min((em.wt(s) * group for _, _, ss in pools for s in ss
                    if em.wt(s) > 0), default=0.0)
    if min_item and min_item / tick < 8:
        tick = min_item / 8
    T = min(int(math.ceil(t_slice_ns / tick)), 16384)
    tick = t_slice_ns / T
    return {"em": em, "group": group, "pl_peak": pl_peak, "t_peak": t_peak,
            "t_grid": t_grid, "T": T,
            "K": math.ceil(model.n_params / group),
            "rows": [int(t_c / tick) for t_c in t_grid],
            "t_items": [[max(1, int(math.ceil(em.wt(s) * group / tick
                                              - 1e-9))) for s in ss]
                        for _, _, ss in pools],
            "e_items": [[em.we(s) * group for s in ss]
                        for _, _, ss in pools]}


def lut(c: dict, sub: dict, lp_clock: float, t_slice_ns: float) -> list:
    """One clock point's LUT entries: (t_constraint_ns, placement,
    e_task_pj, t_task_ns, feasible)."""
    p = problem(c, sub, lp_clock, t_slice_ns)
    em, group, Kg, rows = p["em"], p["group"], p["K"], p["rows"]
    pl_peak, t_peak = p["pl_peak"], p["t_peak"]
    window = t_slice_ns                        # static window: the slice
    tables = [stage_tables(tl, el, p["T"], Kg)
              for tl, el in zip(p["t_items"], p["e_items"])]
    f0, f1 = (tb[-1][rows] for tb in tables)
    cand = f0 + f1[:, ::-1]
    min_e = cand.min(axis=1)
    i_opt = np.argmax(cand == min_e[:, None], axis=1)
    entries = []
    for r, t_c in enumerate(p["t_grid"]):
        if np.isfinite(min_e[r]):
            counts = {}
            for (_, _, ss), tb, tl, k in zip(em.pools, tables, p["t_items"],
                                            (i_opt[r], Kg - i_opt[r])):
                for s, x in zip(ss, backtrace(tb, tl, rows[r], int(k))):
                    counts[s.name] = x
            pl = {k: int(v) * group for k, v in counts.items()}
            diff = em.model.n_params - sum(pl.values())
            if diff:
                pl[max(pl, key=lambda k: pl[k])] += diff
            entries.append(em.entry(t_c, pl, window))
        elif t_c >= t_peak:
            entries.append(em.entry(t_c, pl_peak, window))
        else:
            entries.append((float(t_c), {}, INF, INF, False))
    peak = em.entry(t_peak, pl_peak, window)
    entries = [e for e in entries if abs(e[0] - peak[0]) > 1e-6] + [peak]
    entries.sort(key=lambda e: e[0])
    return entries


# -- the per-slice choice of a DVFS scheduler ---------------------------------

def lookup(entries: list, t_ns: float):
    """The entry of the largest grid point within ``t_ns`` that is
    feasible; with none, the first feasible entry (the fastest)."""
    tol = t_ns * 1e-9 + 1e-3
    best = None
    for e in entries:
        if e[0] <= t_ns + tol and e[4]:
            best = e
    if best is None:
        best = next(e for e in entries if e[4])
    return best


def shape(sub: dict, index: int, mixed: bool) -> dict:
    """The substrate parameters of fleet engine ``index``: a mixed fleet
    gives odd engines half of each pool (at least one cluster)."""
    if not (mixed and index % 2 == 1):
        return dict(sub)
    return dict(sub, n_hp_clusters=max(sub["n_hp_clusters"] // 2, 1),
                n_lp_clusters=max(sub["n_lp_clusters"] // 2, 1))


def grid(c: dict, sub: dict, t_slice_ns: float) -> list:
    """``[(clock, Energy, LUT entries)]`` over the DVFS clock grid, in
    ascending clock order."""
    return [(clock, Energy(arch(sub["n_hp_clusters"], sub["n_lp_clusters"],
                                clock),
                           Model(c, sub["tokens_per_task"]), sub["rho"]),
             lut(c, sub, clock, t_slice_ns))
            for clock in clock_grid(sub["n_clocks"], (sub["lp_clock"],))]


def choose(points: list, t_slice_ns: float, n_tasks: int, lookup_tasks,
           prev: Dict[str, int]):
    """One slice of a DVFS scheduler: ``(clock, placement, tasks run)``.

    The clock is the grid point whose LUT placement for the planned tasks
    (``lookup_tasks``, else ``n_tasks``) fits the slice with the least
    slice energy (dynamic energy plus statics over the slice; ties to the
    lower clock), else the fastest point. If moving there from ``prev``
    takes time, the LUT is consulted again for the slice less that time;
    that entry is taken if it still fits, else ``prev`` is kept if it
    fits on its own. The tasks run are those that fit in the slice less
    the move, at most ``n_tasks``."""
    T = t_slice_ns
    n = max(lookup_tasks if lookup_tasks is not None else n_tasks, 1)
    best = fastest = None
    best_e = fastest_t = INF
    for point in points:
        clock, em, entries = point
        e = lookup(entries, T / n)
        t_task, t_cl, e_dyn = em.task_cost(e[1])
        if t_task < fastest_t:
            fastest_t, fastest = t_task, point
        if n * t_task > T * (1 + 1e-9):
            continue
        busy = {k: v * n for k, v in t_cl.items()}
        e_slice = n * e_dyn + em.static_pj(e[1], T, busy)
        if e_slice < best_e:
            best_e, best = e_slice, point
    clock, em, entries = best if best is not None else fastest
    e = lookup(entries, T / n)
    t_move = max(em.move_ns(prev, e[1]).values(), default=0.0)
    new = dict(e[1])
    if t_move > 0:
        e2 = lookup(entries, max(T - t_move, 0.0) / n)
        t_move2 = max(em.move_ns(prev, e2[1]).values(), default=0.0)
        if n * e2[3] + t_move2 <= T + 1e-9:
            new, t_move = dict(e2[1]), t_move2
        elif n * em.task_cost(prev)[0] <= T + 1e-9:
            new, t_move = dict(prev), 0.0
    t_task = em.task_cost(new)[0]
    n_run = n_tasks
    if t_task > 0:
        n_run = min(n_tasks, max(int((T - t_move + 1e-6) // t_task), 0))
    return clock, new, n_run
