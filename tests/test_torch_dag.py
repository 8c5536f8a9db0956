"""The port's multi-tenant DAG fleet against the JAX package's, on the
CPU.

Both packages run the same DAG fleet on the same DAG trace and seed
(``device="cpu"`` for the port), over the fleets of tests/test_dag.py
and a cxl-tier-3 dp fleet (C=3). The stage co-scheduler is host code
over bitwise-equal LUTs, so the whole ``DagResult`` must be *equal*:
its stage placement order (``assignments``, the determinism contract),
every DAG's per-stage cells and latency, the handoffs, the stage-level
``FleetResult`` and ``FleetSummary``, the ``tenant_breakdown`` and the
per-tenant metrics; a DAG fleet pays 0 LUT builds beyond the plain
per-variant set. The spec and tenant registries raise the reference's
shaped errors, and the topological frontier agrees with the
reference's on random DAGs.
"""
import dataclasses

import pytest

from conftest import given, settings, st

torch = pytest.importorskip("torch")

from repro import api as jax_api  # noqa: E402
from repro import fleet as jax_fleet  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.fleet import dag as jax_dag  # noqa: E402
from repro_torch import api, fleet, obs  # noqa: E402
from repro_torch.fleet import dag  # noqa: E402
from test_torch_fleet import PACKAGES, assert_same_stats  # noqa: E402

asdict = dataclasses.asdict
DAG_MODULES = ((jax_dag, jax_fleet), (dag, fleet))


def small_fleet(mod_api, dev, sub=("tpu-pool", "gpu-pool"), **kw):
    kw.setdefault("n_cells", 2)
    kw.setdefault("engines_per_cell", 1)
    kw.setdefault("seed", 0)
    return mod_api.dag_fleet(list(sub), **dev, **kw)


def small_trace(mod_dag, f, n_slices=10, seed=0):
    return mod_dag.dag_arrivals(f.tenants, n_slices=n_slices,
                                base="poisson", seed=seed, rate=1.0)


def assert_same_dag_result(ours, ref, f_ours, f_ref):
    assert asdict(ours) == asdict(ref)
    assert ours.assignments == ref.assignments
    assert (ours.handoffs, ours.handoff_energy_pj) == (
        ref.handoffs, ref.handoff_energy_pj)
    assert asdict(fleet.summarize(ours)) == asdict(
        jax_fleet.summarize(ref))
    assert dag.tenant_breakdown(ours, f_ours) == jax_dag.tenant_breakdown(
        ref, f_ref)


# -- specs, tenants, traces --------------------------------------------------


def test_canonical_specs_match():
    assert sorted(dag.DAG_SPECS) == sorted(jax_dag.DAG_SPECS)
    for name, ref in jax_dag.DAG_SPECS.items():
        ours = dag.make_dag_spec(name)
        assert asdict(ours) == asdict(ref)
        assert ours.topo_order() == ref.topo_order()
        assert ours.roots() == ref.roots()
        assert ours.critical_path_len() == ref.critical_path_len()
        assert ours.total_tokens == ref.total_tokens
        for s in ref.stages:
            assert ours.parents(s.name) == ref.parents(s.name)
            assert ours.children(s.name) == ref.children(s.name)
    assert dag.DEFAULT_DAG_BUDGETS == jax_dag.DEFAULT_DAG_BUDGETS
    assert [asdict(t) for t in dag.default_tenants()] == [
        asdict(t) for t in jax_dag.default_tenants()]


SHAPED_ERRORS = [
    lambda d, f, a, dev: d.make_dag_spec("nope"),
    lambda d, f, a, dev: d.DAG_SPECS["agentic"].stage("missing"),
    lambda d, f, a, dev: d.DagSpec("d", (d.StageSpec("a", 1),
                                         d.StageSpec("a", 1))),
    lambda d, f, a, dev: d.DagSpec("d", (d.StageSpec("a", 1),),
                                   (("a", "ghost"),)),
    lambda d, f, a, dev: d.DagSpec("d", (d.StageSpec("a", 1),),
                                   (("a", "a"),)),
    lambda d, f, a, dev: d.StageSpec("a", 0),
    lambda d, f, a, dev: d.DagSpec("d", (d.StageSpec("a", 1),
                                         d.StageSpec("b", 1)),
                                   (("a", "b"), ("b", "a"))),
    lambda d, f, a, dev: d.default_tenants().get("ghost"),
    lambda d, f, a, dev: d.default_tenants().register(d.Tenant("acme")),
    lambda d, f, a, dev: d.Tenant("t", weight=0),
    lambda d, f, a, dev: d.Tenant("t", dag="ghost_spec"),
    lambda d, f, a, dev: d.dag_arrivals(d.default_tenants(),
                                        mix={"ghost": 1.0}),
    lambda d, f, a, dev: d.dag_arrivals(d.TenantRegistry()),
    lambda d, f, a, dev: small_fleet(a, dev, budgets={"batch": 8.0}),
    lambda d, f, a, dev: small_fleet(a, dev).router.budget("nope"),
]


@pytest.mark.parametrize("i", range(len(SHAPED_ERRORS)))
def test_shaped_errors_match_jax(i):
    msgs = []
    for (mod_dag, mod_fleet), (mod_api, _, dev) in zip(DAG_MODULES,
                                                       PACKAGES):
        with pytest.raises(ValueError) as e:
            SHAPED_ERRORS[i](mod_dag, mod_fleet, mod_api, dev)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("base,seed,kw", [
    ("mmpp", 3, {}), ("mmpp", 4, {}), ("poisson", 0, {"rate": 1.0}),
    ("flash", 1, {}), ("diurnal", 2, {})])
def test_dag_arrivals_match_jax(base, seed, kw):
    mix = {"acme": 2.0, "duo": 1.0}
    for m in (None, mix):
        ref = jax_dag.dag_arrivals(jax_dag.default_tenants(), n_slices=20,
                                   seed=seed, base=base, mix=m, **kw)
        ours = dag.dag_arrivals(dag.default_tenants(), n_slices=20,
                                seed=seed, base=base, mix=m, **kw)
        assert asdict(ours) == asdict(ref)
        assert (ours.total, ours.counts) == (ref.total, ref.counts)


def _random_dag(mod_dag, n, edge_bits):
    """A guaranteed-acyclic DAG on n stages: forward edges only."""
    stages = tuple(mod_dag.StageSpec(f"s{i}", 2) for i in range(n))
    edges, k = [], 0
    for i in range(n):
        for j in range(i + 1, n):
            if edge_bits & (1 << k):
                edges.append((f"s{i}", f"s{j}"))
            k += 1
    return mod_dag.DagSpec("rand", stages, tuple(edges))


@settings(max_examples=50, deadline=None)
@given(st.integers(2, 6), st.integers(0, 2 ** 15 - 1),
       st.randoms(use_true_random=False))
def test_frontier_matches_jax_on_random_dags(n, edge_bits, rnd):
    """Both packages' frontier, topological order and critical path on
    the same random DAG, completing the same ready stage each step."""
    reqs = []
    for mod_dag, _ in DAG_MODULES:
        spec = _random_dag(mod_dag, n, edge_bits)
        reqs.append(mod_dag.DagRequest(rid=0, tenant="t",
                                       slo_class="default", spec=spec,
                                       arrival_slice=0))
    ref, ours = reqs
    assert ours.spec.topo_order() == ref.spec.topo_order()
    assert ours.spec.critical_path_len() == ref.spec.critical_path_len()
    while not ref.done:
        ready = ref.ready_stages()
        assert ours.ready_stages() == ready
        for nm in ready:
            assert all(ours.state[p] == dag.DONE
                       for p in ours.spec.parents(nm))
        nm = rnd.choice(ready)
        ref.state[nm] = jax_dag.DONE
        ours.state[nm] = dag.DONE
    assert ours.done


# -- the fleet ---------------------------------------------------------------

DAG_CASES = {
    "stage-level": ({}, dict(n_slices=10)),
    "request-level": ({"stage_affinity": False}, dict(n_slices=10)),
    "longer-seed1": ({"forecaster": "holt"}, dict(n_slices=14, seed=1)),
    "autoscale": ({"autoscale": True, "max_engines": 3,
                   "engines_per_cell": 2, "affinity_bonus": 0.3,
                   "handoff_tax_slices": 0.5},
                  dict(n_slices=12, seed=2)),
    "cxl3-dp": ({"sub": ("cxl-tier-3",), "n_cells": 4,
                 "engines_per_cell": 2, "solver": "dp"},
                dict(n_slices=12)),
}


def run_dag(mod_api, dev, mod_dag, case, background=None):
    kw, tr_kw = DAG_CASES[case]
    pc = mod_api.compiler(**dev)
    f = small_fleet(mod_api, dev, compiler=pc, **kw)
    res = f.run_dag(small_trace(mod_dag, f, **tr_kw), background=background)
    return f, res, pc


@pytest.mark.parametrize("case", sorted(DAG_CASES))
def test_dag_fleet_matches_jax(case):
    (fj, rj, pj), (ft, rt, pt) = [
        run_dag(mod_api, dev, mod_dag, case)
        for (mod_api, _, dev), (mod_dag, _) in zip(PACKAGES, DAG_MODULES)]
    assert_same_dag_result(rt, rj, ft, fj)
    assert_same_stats(pt, pj)
    n = len(rt.completed) + len(rt.rejected) + len(rt.unfinished)
    assert n == small_trace(dag, ft, **DAG_CASES[case][1]).total
    assert rt.completed
    for d in rt.completed:
        assert d.done and set(d.cell_of) == {s.name for s in d.spec.stages}
    if case == "request-level":
        assert rt.handoffs == 0
    if DAG_CASES[case][0].get("solver") == "dp":
        assert pt.stats()["builds_by_backend"] == {"cpu": pt.n_builds}


def test_dag_fleet_pays_zero_extra_lut_builds_match_jax():
    counts = []
    for (mod_api, _, dev), (mod_dag, _) in zip(PACKAGES, DAG_MODULES):
        pc_plain = mod_api.compiler(**dev)
        mod_api.hierarchical_fleet(["tpu-pool", "gpu-pool"], n_cells=2,
                                   engines_per_cell=1, compiler=pc_plain,
                                   **dev)
        pc = mod_api.compiler(**dev)
        f = small_fleet(mod_api, dev, compiler=pc)
        at_bring_up = pc.n_builds
        f.run_dag(small_trace(mod_dag, f))
        counts.append((pc_plain.n_builds, at_bring_up, pc.n_builds,
                       pc.n_hits))
    assert counts[1] == counts[0]
    plain, at_bring_up, after, _ = counts[1]
    assert plain == at_bring_up == after


def test_stage_cost_matches_jax():
    scheds = [small_fleet(mod_api, dev).cells[c].workers[0].sched
              for mod_api, _, dev in PACKAGES for c in (0, 1)]
    for n in (1, 2, 4, 9):
        for ref, ours in zip(scheds[:2], scheds[2:]):
            assert ours.stage_cost(n) == ref.stage_cost(n)


def test_background_trace_matches_jax():
    runs = []
    for (mod_api, mod_fleet, dev), (mod_dag, _) in zip(PACKAGES,
                                                      DAG_MODULES):
        bg = mod_fleet.make_trace("poisson", n_slices=10, seed=1, rate=1.0)
        runs.append(run_dag(mod_api, dev, mod_dag, "stage-level", bg))
    (fj, rj, _), (ft, rt, _) = runs
    assert_same_dag_result(rt, rj, ft, fj)
    assert rt.background_result is not None
    assert all(r.dag_rid >= 0 for r in rt.stage_result.completed)


def test_per_tenant_observability_matches_jax():
    """tests/test_dag.py's instrumented run: per-tenant counters and
    admissions, flight frames with tenants and cells, span names and
    arguments - the same in both packages."""
    runs = []
    for (mod_api, _, dev), (mod_dag, _) in zip(PACKAGES, DAG_MODULES):
        o = jax_obs if mod_api is jax_api else obs
        o.reset()
        rec = o.FlightRecorder(capacity=64)
        o.enable(flight_recorder=rec)
        try:
            f = small_fleet(mod_api, dev)
            res = f.run_dag(small_trace(mod_dag, f, n_slices=12))
            runs.append((asdict(res), o.metrics().as_dict(),
                         list(rec.frames),
                         [(e["name"], e.get("cat"), e.get("args"))
                          for e in o.tracer().events()]))
        finally:
            o.reset()
    assert runs[1] == runs[0]
    _, metrics, frames, _ = runs[1]
    admission = [k for k in metrics["counters"]
                 if k.startswith("fleet.admission{")]
    assert admission and all("tenant=" in k for k in admission)
    assert any(k.startswith("dag.stage.done{") for k in metrics["counters"])
    assert {"tenants", "cells", "running"} <= set(frames[-1])
