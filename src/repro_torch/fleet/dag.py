"""``repro_torch.fleet.dag`` - multi-tenant DAG workloads + stage
co-scheduling.

The fleet so far serves independent single-request streams; this module
models requests as *pipelines* - DAGs of named stages with per-stage
token counts, compute classes and residency hints (after lumos-style
application modeling and the heterogeneous data-centric survey in
PAPERS.md) - and schedules *stages* rather than requests, so each stage
lands on the (cell, substrate) pool that suits it:

* :class:`StageSpec` / :class:`DagSpec` describe the workload shape;
  canonical specs ship for ``prefill_decode`` (prefill -> decode),
  ``agentic`` (prefill -> decode -> tool_call -> decode) and the
  two-model ``draft_verify`` pipeline. Specs validate at construction:
  duplicate stages, dangling edges and cycles all raise shaped errors.
* :class:`Tenant` / :class:`TenantRegistry` map tenants to an SLO
  class, an optional per-tenant budget override, an admission weight
  and the DAG spec their requests instantiate. Unknown tenants and
  unregistered SLO classes raise shaped errors naming the offender and
  listing what is registered (no silent defaults).
* :func:`dag_arrivals` layers seeded tenant draws on the existing
  arrival processes (:mod:`repro_torch.fleet.traces`), producing a
  :class:`DagTrace` - per-slice lists of arriving tenants; equal seeds
  give equal traces.
* :class:`DagCoScheduler` places ready stages (topological frontier) on
  cells, scored by expected queue latency over the tenant's budget, the
  stage's energy/token on that cell's substrate - read from the
  placement LUTs already compiled at fleet bring-up via
  :meth:`~repro_torch.core.scheduler.TimeSliceScheduler.stage_cost` (the SS.6
  variant-key cache; a DAG fleet pays **zero** LUT builds beyond the
  per-variant set a plain fleet of the same substrates pays) - plus a
  fixed per-edge handoff latency/energy tax when a stage runs in a
  different cell than its parent, and an optional residency-hint bonus.
* :class:`DagFleet` extends :class:`~repro_torch.fleet.hierarchy.
  HierarchicalFleet`: :meth:`DagFleet.run_dag` drives a
  :class:`DagTrace` (optionally with a plain background
  :class:`~repro_torch.fleet.traces.Trace` routed through the same cells, so
  DAG stages and plain requests coexist in one fleet) and returns a
  :class:`DagResult` whose stage-level
  :class:`~repro_torch.fleet.router.FleetResult` works with
  :func:`repro_torch.fleet.metrics.summarize` unchanged.

Construct through :func:`repro_torch.api.dag_fleet`; the fleet CLI exposes
``--workload dag:<spec>``. See DESIGN.md SS.11.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fleet.hierarchy import Cell, HierarchicalFleet
from repro_torch.fleet.router import (ADMIT_ACCEPT, ADMIT_REJECT,
                                      FleetRequest, FleetResult)
from repro_torch.fleet.traces import Trace, make_trace

#: admission reject reason for a DAG whose root stage cannot meet the
#: tenant's budget in any cell (complements SS.8/SS.9 reason codes)
REASON_TENANT_BUDGET = "tenant_budget_exhausted"

#: stage lifecycle states on a DagRequest
PENDING, QUEUED, DONE = "pending", "queued", "done"


def _unknown(kind: str, name, registered: Iterable[str]) -> ValueError:
    """The shaped unknown-reference error: names the offender and lists
    what is registered (the satellite contract - no silent defaults)."""
    return ValueError(
        f"unknown {kind} {name!r}; registered: {sorted(registered)}")


# -- workload model ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One named stage of a DAG request.

    ``tokens`` sizes the stage (decoded-token equivalents; the fleet
    splits it into ``ceil(tokens / tokens_per_task)`` scheduler tasks),
    ``compute_class`` labels its profile (prefill / decode / tool /
    draft / verify - attribution + future per-class costing), and
    ``residency`` optionally names a substrate-family hint (substring
    matched against a cell's substrate name; matching cells get a
    scoring bonus)."""
    name: str
    tokens: int
    compute_class: str = "decode"
    residency: Optional[str] = None

    def __post_init__(self):
        if self.tokens <= 0:
            raise ValueError(
                f"stage {self.name!r} needs tokens > 0, got {self.tokens}")


@dataclasses.dataclass(frozen=True)
class DagSpec:
    """A validated stage DAG: unique stage names, edges between known
    stages, acyclic (checked with Kahn's algorithm at construction; a
    cycle raises a shaped error naming its members)."""
    name: str
    stages: Tuple[StageSpec, ...]
    edges: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        names = [s.name for s in self.stages]
        if not names:
            raise ValueError(f"dag {self.name!r} needs at least one stage")
        dups = sorted({n for n in names if names.count(n) > 1})
        if dups:
            raise ValueError(
                f"dag {self.name!r} has duplicate stage names {dups}")
        known = set(names)
        for u, v in self.edges:
            for end in (u, v):
                if end not in known:
                    raise _unknown(
                        f"stage (edge {u!r}->{v!r} of dag {self.name!r})",
                        end, known)
            if u == v:
                raise ValueError(
                    f"dag {self.name!r} has a self-edge on stage {u!r}")
        self.topo_order()                    # raises on cycles

    def stage(self, name: str) -> StageSpec:
        for s in self.stages:
            if s.name == name:
                return s
        raise _unknown(f"stage of dag {self.name!r}", name,
                       [s.name for s in self.stages])

    def parents(self, name: str) -> List[str]:
        return [u for u, v in self.edges if v == name]

    def children(self, name: str) -> List[str]:
        return [v for u, v in self.edges if u == name]

    def roots(self) -> List[str]:
        has_parent = {v for _, v in self.edges}
        return [s.name for s in self.stages if s.name not in has_parent]

    def topo_order(self) -> List[str]:
        """Deterministic topological order (Kahn; ties broken by spec
        order). Raises a shaped error when a cycle remains."""
        order_ix = {s.name: i for i, s in enumerate(self.stages)}
        indeg = {s.name: 0 for s in self.stages}
        for _, v in self.edges:
            indeg[v] += 1
        frontier = sorted((n for n, d in indeg.items() if d == 0),
                          key=order_ix.get)
        out: List[str] = []
        while frontier:
            n = frontier.pop(0)
            out.append(n)
            for c in self.children(n):
                indeg[c] -= 1
                if indeg[c] == 0:
                    frontier.append(c)
            frontier.sort(key=order_ix.get)
        if len(out) != len(self.stages):
            cycle = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(
                f"dag {self.name!r} has a cycle through stages {cycle}; "
                f"edges must form a DAG")
        return out

    def critical_path_len(self) -> int:
        """Stages on the longest root->leaf path: the factor that scales
        a tenant's per-request SLO budget to a whole-DAG budget."""
        depth: Dict[str, int] = {}
        for n in self.topo_order():
            ps = self.parents(n)
            depth[n] = 1 + max((depth[p] for p in ps), default=0)
        return max(depth.values())

    @property
    def total_tokens(self) -> int:
        return sum(s.tokens for s in self.stages)


def prefill_decode_spec(*, prefill_tokens: int = 32,
                        decode_tokens: int = 8) -> DagSpec:
    """The canonical serving pipeline: one prefill stage feeding decode."""
    return DagSpec(
        "prefill_decode",
        (StageSpec("prefill", prefill_tokens, "prefill"),
         StageSpec("decode", decode_tokens, "decode")),
        (("prefill", "decode"),))


def agentic_spec(*, prefill_tokens: int = 32, decode_tokens: int = 8,
                 tool_tokens: int = 4) -> DagSpec:
    """Agentic chain: prefill -> decode -> tool_call -> decode (the
    second decode consumes the tool result)."""
    return DagSpec(
        "agentic",
        (StageSpec("prefill", prefill_tokens, "prefill"),
         StageSpec("decode", decode_tokens, "decode"),
         StageSpec("tool_call", tool_tokens, "tool"),
         StageSpec("decode2", decode_tokens, "decode")),
        (("prefill", "decode"), ("decode", "tool_call"),
         ("tool_call", "decode2")))


def draft_verify_spec(*, draft_tokens: int = 8,
                      verify_tokens: int = 16) -> DagSpec:
    """Two-model speculative pipeline: a cheap draft stage whose output
    a heavier verify stage checks (the compute classes attribute the
    two models; both run this fleet's model spec)."""
    return DagSpec(
        "draft_verify",
        (StageSpec("draft", draft_tokens, "draft"),
         StageSpec("verify", verify_tokens, "verify")),
        (("draft", "verify"),))


DAG_SPECS: Dict[str, DagSpec] = {
    "prefill_decode": prefill_decode_spec(),
    "agentic": agentic_spec(),
    "draft_verify": draft_verify_spec(),
}


def make_dag_spec(spec) -> DagSpec:
    """Resolve a canonical spec by name (instances pass through)."""
    if isinstance(spec, DagSpec):
        return spec
    if spec in DAG_SPECS:
        return DAG_SPECS[spec]
    raise _unknown("dag spec", spec, DAG_SPECS)


# -- tenants -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One tenant: SLO class, optional per-tenant budget override (in
    slices, per stage of critical path), admission weight (scales the
    wait-based admission headroom: > 1 admits deeper, < 1 shallower)
    and the DAG spec its requests instantiate."""
    name: str
    slo_class: str = "default"
    budget_slices: Optional[float] = None
    weight: float = 1.0
    dag: str = "prefill_decode"

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r} needs weight > 0, got {self.weight}")
        make_dag_spec(self.dag)              # shaped error on unknown spec


class TenantRegistry:
    """Name-keyed tenant registry; lookups of unregistered tenants raise
    shaped errors listing the registered set."""

    def __init__(self, tenants: Sequence[Tenant] = ()):
        self._tenants: Dict[str, Tenant] = {}
        for t in tenants:
            self.register(t)

    def register(self, tenant: Tenant) -> Tenant:
        if tenant.name in self._tenants:
            raise ValueError(f"tenant {tenant.name!r} already registered")
        self._tenants[tenant.name] = tenant
        return tenant

    def get(self, name: str) -> Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise _unknown("tenant", name, self._tenants) from None

    def names(self) -> List[str]:
        return sorted(self._tenants)

    def __iter__(self):
        return iter(self._tenants.values())

    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, name: str) -> bool:
        return name in self._tenants


def default_tenants() -> TenantRegistry:
    """The stock mixed-tenant registry the CLI and benches use: an
    interactive agentic tenant, a batch prefill/decode tenant and a
    lower-weight default-class draft/verify tenant."""
    return TenantRegistry((
        Tenant("acme", "interactive", weight=1.0, dag="agentic"),
        Tenant("batchco", "batch", weight=1.0, dag="prefill_decode"),
        Tenant("duo", "default", weight=0.5, dag="draft_verify"),
    ))


#: default budgets matching :func:`default_tenants` (slices per stage of
#: critical path; "default" inherits the fleet's slo_slices)
DEFAULT_DAG_BUDGETS = {"interactive": 3.0, "batch": 8.0}


# -- requests ----------------------------------------------------------------


@dataclasses.dataclass
class StageRequest(FleetRequest):
    """One scheduler task ("chunk") of a DAG stage; a stage with N
    tokens becomes ``ceil(N / tokens_per_task)`` chunks enqueued into
    the stage's chosen cell, and the stage completes when its last
    chunk does."""
    dag_rid: int = -1
    stage: str = ""
    chunk: int = 0
    n_chunks: int = 1


@dataclasses.dataclass
class DagRequest:
    """One in-flight DAG instance for a tenant."""
    rid: int
    tenant: str
    slo_class: str
    spec: DagSpec
    arrival_slice: int
    state: Dict[str, str] = dataclasses.field(default_factory=dict)
    cell_of: Dict[str, int] = dataclasses.field(default_factory=dict)
    queued_slice: Dict[str, int] = dataclasses.field(default_factory=dict)
    finish_slice_of: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: absolute ns of each stage's last chunk completion
    finish_ns_of: Dict[str, float] = dataclasses.field(default_factory=dict)
    chunks_left: Dict[str, int] = dataclasses.field(default_factory=dict)
    handoffs: int = 0
    rejected: bool = False
    finish_slice: Optional[int] = None
    latency_ns: Optional[float] = None

    def __post_init__(self):
        if not self.state:
            self.state = {s.name: PENDING for s in self.spec.stages}

    @property
    def done(self) -> bool:
        return all(v == DONE for v in self.state.values())

    def ready_stages(self) -> List[str]:
        """The topological frontier: pending stages whose parents are
        all complete, in deterministic topological order."""
        return [n for n in self.spec.topo_order()
                if self.state[n] == PENDING
                and all(self.state[p] == DONE for p in self.spec.parents(n))]


# -- traces ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DagTrace:
    """Per-slice lists of arriving tenant names (each arrival is one
    DAG instance of that tenant's spec)."""
    name: str
    arrivals: List[List[str]]

    def __len__(self) -> int:
        return len(self.arrivals)

    @property
    def total(self) -> int:
        return sum(len(a) for a in self.arrivals)

    @property
    def counts(self) -> List[int]:
        return [len(a) for a in self.arrivals]


def dag_arrivals(tenants: TenantRegistry, n_slices: int = 50, *,
                 base: str = "mmpp", mix: Optional[Dict[str, float]] = None,
                 seed: int = 0, **kw) -> DagTrace:
    """Seeded DAG trace layered on an existing arrival process: per-slice
    counts come from :func:`repro_torch.fleet.traces.make_trace` (``base`` +
    kwargs), and each arrival draws a tenant from ``mix`` (tenant ->
    probability weight; default: the registry's admission weights).
    Referencing an unregistered tenant raises a shaped error."""
    if not len(tenants):
        raise ValueError("dag_arrivals needs at least one tenant")
    if mix is None:
        mix = {t.name: t.weight for t in tenants}
    for name in mix:
        if name not in tenants:
            raise _unknown("tenant (in mix)", name, tenants.names())
    names = sorted(mix)
    total = sum(mix.values())
    probs = [mix[n] / total for n in names]
    counts = make_trace(base, n_slices=n_slices, seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    arrivals = [[names[int(i)] for i in rng.choice(len(names), size=n,
                                                   p=probs)]
                for n in counts.arrivals]
    return DagTrace(f"dag-{counts.name}", arrivals)


# -- stage co-scheduler ------------------------------------------------------


class DagCoScheduler:
    """Places ready DAG stages on cells.

    Score of placing a stage on cell ``c`` (lower is better)::

        expected_latency(c, n_chunks) / budget
          + energy_weight * stage_energy_norm(c, stage)
          + handoff_tax_slices / budget   per parent in another cell
          - affinity_bonus                if the residency hint matches

    ``stage_energy_norm`` is the stage's energy/token on the cell's
    substrate - looked up through the engine scheduler's
    :meth:`~repro_torch.core.scheduler.TimeSliceScheduler.stage_cost` hook
    against the placement LUT compiled at bring-up (SS.6 variant-key
    cache: **no** builds beyond the plain fleet's per-variant set) -
    min-max normalized across cells. With ``stage_affinity=False`` every
    non-root stage is pinned to its DAG's admission cell (request-level
    routing: the benchmark baseline)."""

    def __init__(self, cells: Sequence[Cell], *,
                 tokens_per_task: int = 2,
                 handoff_tax_slices: float = 0.25,
                 handoff_energy_pj: float = 2e5,
                 energy_weight: float = 0.05,
                 affinity_bonus: float = 0.1,
                 stage_affinity: bool = True):
        self.cells = list(cells)
        self.tokens_per_task = max(tokens_per_task, 1)
        self.handoff_tax_slices = handoff_tax_slices
        self.handoff_energy_pj = handoff_energy_pj
        self.energy_weight = energy_weight
        self.affinity_bonus = affinity_bonus
        self.stage_affinity = stage_affinity
        # (cid, n_tasks) -> energy/token pj; LUT-backed, static per run
        self._ecache: Dict[Tuple[int, int], float] = {}

    def n_chunks(self, spec: StageSpec) -> int:
        return max(math.ceil(spec.tokens / self.tokens_per_task), 1)

    def stage_energy_per_token(self, cell: Cell, spec: StageSpec) -> float:
        """Energy/token (pJ) the stage would pay on this cell, from the
        cell substrate's placement LUT at the stage's own load point."""
        n = self.n_chunks(spec)
        key = (cell.cid, n)
        if key not in self._ecache:
            _, e_task = cell.workers[0].sched.stage_cost(n)
            self._ecache[key] = e_task / self.tokens_per_task
        return self._ecache[key]

    def _scores(self, spec: StageSpec, budget: float,
                parent_cells: Sequence[int]) -> List[Tuple[float, float,
                                                           Cell]]:
        n = self.n_chunks(spec)
        es = [self.stage_energy_per_token(c, spec) for c in self.cells]
        lo, hi = min(es), max(es)
        spread = hi - lo
        scored = []
        for c, e in zip(self.cells, es):
            lat = c.expected_latency_slices(n)
            s = lat / budget
            s += self.energy_weight * ((e - lo) / spread if spread > 0
                                       else 0.0)
            s += sum(self.handoff_tax_slices / budget
                     for p in parent_cells if p != c.cid)
            if spec.residency and spec.residency in str(
                    getattr(c.substrate, "name", "")):
                s -= self.affinity_bonus
            scored.append((s, lat, c))
        scored.sort(key=lambda t: (t[0], t[2].cid))
        return scored

    def choose(self, dag: DagRequest, stage_name: str,
               budget: float) -> Cell:
        """Pick the cell for a ready stage (see class docstring)."""
        spec = dag.spec.stage(stage_name)
        parent_cells = [dag.cell_of[p]
                        for p in dag.spec.parents(stage_name)
                        if p in dag.cell_of]
        if not self.stage_affinity and parent_cells:
            # request-level routing baseline: follow the admission cell
            pinned = dag.cell_of[dag.spec.parents(stage_name)[0]]
            return next(c for c in self.cells if c.cid == pinned)
        return self._scores(spec, budget, parent_cells)[0][2]


# -- results -----------------------------------------------------------------


@dataclasses.dataclass
class DagResult:
    """Outcome of :meth:`DagFleet.run_dag`: DAG-level accounting plus
    the stage-level :class:`~repro_torch.fleet.router.FleetResult` (chunk
    requests), so :func:`repro_torch.fleet.metrics.summarize` applies to the
    stage stream unchanged."""
    trace: str
    completed: List[DagRequest]
    rejected: List[DagRequest]
    unfinished: List[DagRequest]
    stage_result: FleetResult
    #: (dag rid, stage, cell, slice queued) in placement order - the
    #: determinism contract: same trace + seed => identical sequence
    assignments: List[Tuple[int, str, int, int]]
    handoffs: int
    handoff_energy_pj: float
    background_result: Optional[FleetResult] = None

    @property
    def result(self) -> FleetResult:
        # summarize()/class_breakdown() unwrap via .result like
        # HierarchyResult; for a DAG run that is the stage stream
        return self.stage_result


def dag_budget_slices(dag: DagRequest, class_budget: float,
                      tenant: Tenant) -> float:
    """Whole-DAG latency budget in slices: the tenant's per-stage budget
    (override or SLO-class budget) times the spec's critical path."""
    per_stage = (tenant.budget_slices if tenant.budget_slices is not None
                 else class_budget)
    return per_stage * dag.spec.critical_path_len()


def tenant_breakdown(res: DagResult, fleet: "DagFleet") -> Dict[str, Dict]:
    """Per-tenant outcome stats for a DAG run (the CLI summary table and
    the bench's per-tenant columns)."""
    out: Dict[str, Dict] = {}
    T = res.stage_result.t_slice_ns
    groups: Dict[str, Dict[str, list]] = {}
    for d in res.completed:
        groups.setdefault(d.tenant, {"lat": [], "rej": 0, "unf": 0,
                                     "hand": 0, "miss": 0})
        g = groups[d.tenant]
        g["lat"].append(d.latency_ns)
        g["hand"] += d.handoffs
        t = fleet.tenants.get(d.tenant)
        budget = dag_budget_slices(d, fleet.router.budget(d.slo_class), t)
        g["miss"] += (d.latency_ns / T) > budget
    for d in res.rejected:
        groups.setdefault(d.tenant, {"lat": [], "rej": 0, "unf": 0,
                                     "hand": 0, "miss": 0})["rej"] += 1
    for d in res.unfinished:
        groups.setdefault(d.tenant, {"lat": [], "rej": 0, "unf": 0,
                                     "hand": 0, "miss": 0})["unf"] += 1
    for name, g in sorted(groups.items()):
        lat_ms = [x / 1e6 for x in g["lat"]]
        n = len(lat_ms) + g["rej"] + g["unf"]
        misses = g["miss"] + g["rej"] + g["unf"]
        t = fleet.tenants.get(name)
        out[name] = {
            "slo_class": t.slo_class,
            "dag": t.dag,
            "n_submitted": n,
            "n_completed": len(lat_ms),
            "n_rejected": g["rej"],
            "n_unfinished": g["unf"],
            "deadline_miss_rate": misses / n if n else 0.0,
            "p95_ms": (float(np.percentile(lat_ms, 95)) if lat_ms
                       else 0.0),
            "mean_ms": float(np.mean(lat_ms)) if lat_ms else 0.0,
            "handoffs": g["hand"],
        }
    return out


# -- the fleet ---------------------------------------------------------------


class DagFleet(HierarchicalFleet):
    """A hierarchical fleet that also co-schedules DAG stages.

    Inherits the cells, the two-level router, budgets and
    :meth:`~repro_torch.fleet.hierarchy.HierarchicalFleet.run` (plain traces
    keep working), and adds :meth:`run_dag`: per slice, completed stage
    chunks advance their DAGs' topological frontiers, newly ready
    stages are placed by the :class:`DagCoScheduler`, new DAG arrivals
    pass per-tenant wait-based admission (SS.9 reason codes with a
    ``tenant`` label), and an optional plain background trace shares
    the same cells. Every tenant's SLO class must be registered in the
    router budgets - an unregistered class raises a shaped error at
    construction."""

    def __init__(self, cells: Sequence[Cell], *,
                 tenants: Optional[TenantRegistry] = None,
                 stage_affinity: bool = True,
                 handoff_tax_slices: float = 0.25,
                 handoff_energy_pj: float = 2e5,
                 affinity_bonus: float = 0.1,
                 **hier_kw):
        super().__init__(cells, **hier_kw)
        self.tenants = tenants if tenants is not None else default_tenants()
        for t in self.tenants:
            if t.slo_class not in self.router.budgets:
                raise _unknown(
                    f"SLO class (tenant {t.name!r})", t.slo_class,
                    self.router.budgets)
        self.cosched = DagCoScheduler(
            self.cells, tokens_per_task=self.tokens_per_request,
            handoff_tax_slices=handoff_tax_slices,
            handoff_energy_pj=handoff_energy_pj,
            energy_weight=self.router.energy_weight,
            affinity_bonus=affinity_bonus, stage_affinity=stage_affinity)
        self._dag_rid = itertools.count()

    # -- stage dispatch ------------------------------------------------------
    def _place_stage(self, dag: DagRequest, stage_name: str,
                     slice_idx: int,
                     assignments: List[Tuple[int, str, int, int]]) -> None:
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        spec = dag.spec.stage(stage_name)
        budget = self.router.budget(dag.slo_class)
        cell = self.cosched.choose(dag, stage_name, budget)
        n_chunks = self.cosched.n_chunks(spec)
        crossings = sum(dag.cell_of[p] != cell.cid
                        for p in dag.spec.parents(stage_name)
                        if p in dag.cell_of)
        dag.handoffs += crossings
        if crossings and _obs:
            obs.counter("dag.handoff", crossings, tenant=dag.tenant)
            obs.instant("dag.handoff", cat="dag", args={
                "dag": dag.rid, "stage": stage_name, "tenant": dag.tenant,
                "to_cell": cell.cid, "crossings": crossings,
                "tax_slices": self.cosched.handoff_tax_slices})
        left = spec.tokens
        for k in range(n_chunks):
            tok = min(self.cosched.tokens_per_task, left)
            left -= tok
            req = StageRequest(
                rid=next(self._rid), arrival_slice=slice_idx, tokens=tok,
                slo_class=dag.slo_class, tenant=dag.tenant,
                dag_rid=dag.rid, stage=stage_name, chunk=k,
                n_chunks=n_chunks)
            req.admission = ADMIT_ACCEPT
            cell.dispatch(req, self.router.cell_policy)
        dag.state[stage_name] = QUEUED
        dag.cell_of[stage_name] = cell.cid
        dag.queued_slice[stage_name] = slice_idx
        dag.chunks_left[stage_name] = n_chunks
        assignments.append((dag.rid, stage_name, cell.cid, slice_idx))
        if _obs:
            obs.complete("dag.stage", _t0, cat="dag", args={
                "dag": dag.rid, "stage": stage_name, "tenant": dag.tenant,
                "cell": cell.cid, "chunks": n_chunks,
                "tokens": spec.tokens, "crossings": crossings})

    def _admit_dag(self, tenant: Tenant, slice_idx: int) -> DagRequest:
        """Per-tenant wait-based admission of a new DAG: the root
        stage's best cell must fit the tenant's (weighted) budget."""
        spec = make_dag_spec(tenant.dag)
        dag = DagRequest(rid=next(self._dag_rid), tenant=tenant.name,
                         slo_class=tenant.slo_class, spec=spec,
                         arrival_slice=slice_idx)
        budget = self.router.budget(tenant.slo_class)
        if tenant.budget_slices is not None:
            budget = tenant.budget_slices
        root = spec.roots()[0]
        best = self.cosched._scores(spec.stage(root), budget, ())[0]
        limit = budget * self.router.admit_headroom * tenant.weight
        admitted = best[1] <= limit
        decision = ADMIT_ACCEPT if admitted else ADMIT_REJECT
        reason = "ok" if admitted else REASON_TENANT_BUDGET
        if obs.enabled():
            obs.counter("fleet.admission", decision=decision,
                        reason=reason, cls=tenant.slo_class,
                        tenant=tenant.name)
            if not admitted:
                obs.instant("fleet.reject", cat="fleet", args={
                    "dag": dag.rid, "tenant": tenant.name,
                    "reason": reason, "budget": budget})
        dag.rejected = not admitted
        return dag

    # -- completion bookkeeping ----------------------------------------------
    def _finish_chunk(self, req: StageRequest,
                      dags: Dict[int, DagRequest]) -> Optional[DagRequest]:
        """Record a completed chunk; returns the DAG when the chunk
        finished its stage (caller advances the frontier)."""
        dag = dags[req.dag_rid]
        T = self.cells[0].t_slice_ns
        abs_ns = req.arrival_slice * T + req.latency_ns
        prev = dag.finish_ns_of.get(req.stage, 0.0)
        dag.finish_ns_of[req.stage] = max(prev, abs_ns)
        dag.chunks_left[req.stage] -= 1
        if dag.chunks_left[req.stage] > 0:
            return None
        dag.state[req.stage] = DONE
        dag.finish_slice_of[req.stage] = req.finish_slice
        if obs.enabled():
            obs.counter("dag.stage.done", tenant=dag.tenant,
                        stage=req.stage)
        return dag

    def _finalize_dag(self, dag: DagRequest, slice_idx: int) -> None:
        T = self.cells[0].t_slice_ns
        dag.finish_slice = slice_idx
        last = max(dag.finish_ns_of.values())
        tax = dag.handoffs * self.cosched.handoff_tax_slices * T
        dag.latency_ns = (last - dag.arrival_slice * T) + tax
        if obs.enabled():
            obs.counter("dag.request.done", tenant=dag.tenant)

    def _record_dag_frame(self, recorder, s: int, arrivals: List[str],
                          done_dags: int, rejected_now: Dict[str, int],
                          trace_name: str, lat_ms: List[float],
                          n_miss: int, n_known: int) -> None:
        """Flight frame for a DAG slice: SS.9 cell aggregates plus
        per-tenant attribution (the breach-dump satellite)."""
        by_tenant: Dict[str, Dict[str, int]] = {}
        for t in arrivals:
            by_tenant.setdefault(t, {"arrivals": 0, "rejected": 0})
            by_tenant[t]["arrivals"] += 1
        for t, n in rejected_now.items():
            by_tenant.setdefault(t, {"arrivals": 0, "rejected": 0})
            by_tenant[t]["rejected"] += n
        miss_rate = (n_miss / n_known) if n_known else 0.0
        p99 = (float(np.percentile(lat_ms, 99)) if lat_ms else None)
        recorder.record(s, {
            "arrivals": len(arrivals),
            "rejected": sum(rejected_now.values()),
            "completed_dags": done_dags,
            "tenants": by_tenant,
            "cells": self._cell_states(),
            "running": {"deadline_miss_rate": round(miss_rate, 4),
                        "p99_ms": p99},
        })
        recorder.check(deadline_miss_rate=miss_rate, p99_ms=p99,
                       context={"trace": trace_name, "slice": s,
                                "dag": True})

    # -- the loop ------------------------------------------------------------
    def run_dag(self, dag_tr: DagTrace, *,
                background: Optional[Trace] = None,
                max_drain_slices: int = 200,
                verbose_cb=None) -> DagResult:
        rng = np.random.default_rng(self.seed)
        dags: Dict[int, DagRequest] = {}
        completed: List[DagRequest] = []
        rejected: List[DagRequest] = []
        stage_done: List[FleetRequest] = []
        bg_done: List[FleetRequest] = []
        bg_rejected: List[FleetRequest] = []
        assignments: List[Tuple[int, str, int, int]] = []
        recorder = obs.flight_recorder()
        if obs.enabled():
            for c in self.cells:
                obs.tracer().name_track(c.cid, f"cell-{c.cid}")
            obs.instant("fleet.run", cat="fleet", args={
                "trace": dag_tr.name, "cells": len(self.cells),
                "engines": self.n_engines, "dag": True,
                "tenants": self.tenants.names(),
                "stage_affinity": self.cosched.stage_affinity})
        T = self.cells[0].t_slice_ns
        lat_ms: List[float] = []
        n_miss = 0
        n_known = 0                   # dags with a final outcome so far
        s = 0
        n_slices = len(dag_tr)
        bg_arr = background.arrivals if background is not None else []
        while True:
            draining = s >= n_slices
            active = [d for d in dags.values()
                      if not d.rejected and not d.done]
            if draining and ((not active
                              and all(c.backlog == 0 for c in self.cells))
                             or s >= n_slices + max_drain_slices):
                break
            _obs = obs.enabled()
            _t0 = obs.now_ns() if _obs else 0
            self.router.refresh()
            # 1) execute backlog; completed chunks advance their DAGs
            done_now: List[FleetRequest] = []
            for c in self.cells:
                done_now.extend(c.step(s, self.router.budget))
            ready: List[Tuple[DagRequest, str]] = []
            seen_ready: set = set()
            done_dags = 0
            for r in done_now:
                if isinstance(r, StageRequest):
                    stage_done.append(r)
                    dag = self._finish_chunk(r, dags)
                    if dag is None:
                        continue
                    if dag.done:
                        self._finalize_dag(dag, s)
                        completed.append(dag)
                        done_dags += 1
                        budget = dag_budget_slices(
                            dag, self.router.budget(dag.slo_class),
                            self.tenants.get(dag.tenant))
                        lat_ms.append(dag.latency_ns / 1e6)
                        n_known += 1
                        n_miss += (dag.latency_ns / T) > budget
                    else:
                        # two parents finishing in one slice both see the
                        # child as ready: place it once
                        for nm in dag.ready_stages():
                            if (dag.rid, nm) not in seen_ready:
                                seen_ready.add((dag.rid, nm))
                                ready.append((dag, nm))
                else:
                    bg_done.append(r)
            # 2) new DAG arrivals (per-tenant wait-based admission)
            arrivals = dag_tr.arrivals[s] if not draining else []
            rejected_now: Dict[str, int] = {}
            for tname in arrivals:
                tenant = self.tenants.get(tname)
                dag = self._admit_dag(tenant, s)
                dags[dag.rid] = dag
                if dag.rejected:
                    rejected.append(dag)
                    rejected_now[tname] = rejected_now.get(tname, 0) + 1
                    n_known += 1
                    n_miss += 1
                    continue
                for nm in dag.ready_stages():
                    ready.append((dag, nm))
            # 3) place the ready frontier (deterministic order)
            ready.sort(key=lambda t: (t[0].rid,
                                      t[0].spec.topo_order().index(t[1])))
            for dag, nm in ready:
                self._place_stage(dag, nm, s, assignments)
            # 4) plain background arrivals share the same cells
            n_bg = bg_arr[s] if (not draining and s < len(bg_arr)) else 0
            for _ in range(n_bg):
                cls = (self._classes[0] if len(self._classes) == 1 else
                       self._classes[int(rng.choice(len(self._classes),
                                                    p=self._probs))])
                req = FleetRequest(rid=next(self._rid), arrival_slice=s,
                                   tokens=self.tokens_per_request,
                                   slo_class=cls)
                if not self.router.route(req):
                    bg_rejected.append(req)
            if self.autoscaler is not None and not draining:
                self.autoscaler.observe(s, self.cells)
            for c in self.cells:
                c.end_of_slice()
            if _obs:
                obs.complete("fleet.slice", _t0, cat="fleet", args={
                    "slice": s, "dag_arrivals": len(arrivals),
                    "stages_placed": len(ready),
                    "chunks_done": len(done_now),
                    "dags_done": done_dags,
                    "backlog": sum(c.backlog for c in self.cells)})
            if recorder is not None:
                self._record_dag_frame(
                    recorder, s, arrivals, done_dags, rejected_now,
                    dag_tr.name, lat_ms, n_miss, n_known)
            if verbose_cb is not None:
                verbose_cb(s, arrivals, done_dags, self.cells)
            s += 1
        unfinished = [d for d in dags.values()
                      if not d.rejected and not d.done]
        workers = self.workers
        leftover = [r for w in workers for r in w.backlog]
        stage_result = FleetResult(
            trace=dag_tr.name, completed=stage_done, rejected=[],
            unfinished=[r for r in leftover
                        if isinstance(r, StageRequest)],
            reports={w.wid: w.reports for w in workers},
            t_slice_ns=T, slo_ns=self.slo_slices * T, n_slices=s)
        bg_result = None
        if background is not None:
            bg_result = FleetResult(
                trace=background.name, completed=bg_done,
                rejected=bg_rejected,
                unfinished=[r for r in leftover
                            if not isinstance(r, StageRequest)],
                reports={}, t_slice_ns=T,
                slo_ns=self.slo_slices * T, n_slices=s)
        if recorder is not None:
            n_sub = n_known + len(unfinished)
            recorder.check(
                deadline_miss_rate=((n_miss + len(unfinished)) / n_sub
                                    if n_sub else 0.0),
                p99_ms=(float(np.percentile(lat_ms, 99)) if lat_ms
                        else None),
                context={"trace": dag_tr.name, "phase": "end_of_run",
                         "dag": True, "n_slices": s})
        return DagResult(
            trace=dag_tr.name, completed=completed, rejected=rejected,
            unfinished=unfinished, stage_result=stage_result,
            assignments=assignments,
            handoffs=sum(d.handoffs for d in dags.values()),
            handoff_energy_pj=(sum(d.handoffs for d in dags.values())
                               * self.cosched.handoff_energy_pj),
            background_result=bg_result)
