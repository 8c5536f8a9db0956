"""Fleet-level serving metrics.

Aggregates a :class:`~repro_torch.fleet.router.FleetResult` into the
numbers the paper's evaluation cares about, lifted to fleet scale: tail latency
(p50/p95/p99), energy per decoded token, deadline-miss rate against the
<= 2T operational SLO, and weight-migration counts (placement churn).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.fleet.router import FleetResult


def percentile(xs: Sequence[float], q: float) -> float:
    """NaN on empty input: callers that aggregate decide the fallback
    (``summarize`` maps the no-completions case to 0.0 + ``degenerate``
    instead of letting NaN poison downstream JSON/gates)."""
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q))


@dataclasses.dataclass
class FleetSummary:
    trace: str
    n_slices: int
    n_engines: int
    n_submitted: int
    n_completed: int
    n_rejected: int
    n_unfinished: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    slo_ms: float
    deadline_miss_rate: float     # SLO violations (+ rejections) / submitted
    energy_uj: float
    energy_per_token_uj: float
    tokens: int
    migrations: int               # slices where weights actually moved
    weights_moved: int
    mean_backlog: float
    peak_backlog: int
    # no request ever completed: latency stats are 0.0 placeholders, not
    # NaN (NaN breaks JSON round-trips and silently un-gates CI checks)
    degenerate: bool = False

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def class_breakdown(res: FleetResult,
                    budgets: Optional[Dict[str, float]] = None
                    ) -> Dict[str, Dict]:
    """Per-SLO-class outcome stats for a (possibly hierarchical) run.

    ``budgets`` maps class -> SLO budget in slices (the
    :class:`~repro_torch.fleet.hierarchy.CellRouter` budgets); a class without
    one is judged against the fleet-wide ``res.slo_ns``. Miss accounting
    matches :func:`summarize`: rejected + unfinished requests count as
    misses of their class."""
    res = getattr(res, "result", res)
    budgets = budgets or {}
    default = budgets.get("default")
    out: Dict[str, Dict] = {}
    groups: Dict[str, Dict[str, list]] = {}
    for r in res.completed:
        groups.setdefault(r.slo_class, {"lat": [], "rej": 0, "unf": 0})[
            "lat"].append(r.latency_ns)
    for r in res.rejected:
        groups.setdefault(r.slo_class, {"lat": [], "rej": 0, "unf": 0})[
            "rej"] += 1
    for r in res.unfinished:
        groups.setdefault(r.slo_class, {"lat": [], "rej": 0, "unf": 0})[
            "unf"] += 1
    for cls, g in sorted(groups.items()):
        budget = budgets.get(cls, default)
        slo_ns = (budget * res.t_slice_ns if budget is not None
                  else res.slo_ns)
        lat = g["lat"]
        n = len(lat) + g["rej"] + g["unf"]
        misses = sum(t > slo_ns for t in lat) + g["rej"] + g["unf"]
        out[cls] = {
            "n_submitted": n,
            "n_completed": len(lat),
            "n_rejected": g["rej"],
            "n_unfinished": g["unf"],
            "slo_ms": slo_ns / 1e6,
            "deadline_miss_rate": misses / n if n else 0.0,
            "p99_ms": (percentile([t / 1e6 for t in lat], 99)
                       if lat else 0.0),
        }
    return out


def summarize(res: FleetResult) -> FleetSummary:
    # a HierarchyResult wraps its FleetResult; accept both
    res = getattr(res, "result", res)
    lat_ms = [r.latency_ns / 1e6 for r in res.completed]
    slo_ms = res.slo_ns / 1e6
    n_sub = (len(res.completed) + len(res.rejected)
             + len(res.unfinished))
    # rejected and never-finished requests both count against the SLO
    misses = (sum(t > slo_ms for t in lat_ms) + len(res.rejected)
              + len(res.unfinished))
    all_reports = [r for reps in res.reports.values() for r in reps]
    energy_pj = sum(r.energy_pj for r in all_reports)
    tokens = sum(r.tokens for r in res.completed)
    backlogs = [r.n_tasks for r in all_reports]
    if not lat_ms:
        # degenerate trace (zero completions): report zeros explicitly
        # instead of percentile([]) = NaN / 0-token division
        return FleetSummary(
            trace=res.trace, n_slices=res.n_slices,
            n_engines=len(res.reports), n_submitted=n_sub,
            n_completed=0, n_rejected=len(res.rejected),
            n_unfinished=len(res.unfinished),
            p50_ms=0.0, p95_ms=0.0, p99_ms=0.0, mean_ms=0.0,
            slo_ms=slo_ms,
            deadline_miss_rate=misses / n_sub if n_sub else 0.0,
            energy_uj=energy_pj * 1e-6, energy_per_token_uj=0.0,
            tokens=0,
            migrations=sum(r.moved_weights > 0 for r in all_reports),
            weights_moved=sum(r.moved_weights for r in all_reports),
            mean_backlog=float(np.mean(backlogs)) if backlogs else 0.0,
            peak_backlog=max(backlogs) if backlogs else 0,
            degenerate=True)
    return FleetSummary(
        trace=res.trace,
        n_slices=res.n_slices,
        n_engines=len(res.reports),
        n_submitted=n_sub,
        n_completed=len(res.completed),
        n_rejected=len(res.rejected),
        n_unfinished=len(res.unfinished),
        p50_ms=percentile(lat_ms, 50),
        p95_ms=percentile(lat_ms, 95),
        p99_ms=percentile(lat_ms, 99),
        mean_ms=float(np.mean(lat_ms)) if lat_ms else float("nan"),
        slo_ms=slo_ms,
        deadline_miss_rate=misses / n_sub if n_sub else 0.0,
        energy_uj=energy_pj * 1e-6,
        energy_per_token_uj=(energy_pj * 1e-6 / tokens) if tokens else 0.0,
        tokens=tokens,
        migrations=sum(r.moved_weights > 0 for r in all_reports),
        weights_moved=sum(r.moved_weights for r in all_reports),
        mean_backlog=float(np.mean(backlogs)) if backlogs else 0.0,
        peak_backlog=max(backlogs) if backlogs else 0,
    )
