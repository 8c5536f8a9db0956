"""The port's hierarchical fleet against the JAX package's, on the CPU.

Both packages run the same two-level (cell -> engine) fleet on the same
trace and seed (``device="cpu"`` for the port), over the fleets of
tests/test_hierarchy.py and a dp fleet with the autoscaler. Everything
is host code over bitwise-equal LUTs, so it must be *equal*: the
``HierarchyResult`` (its ``assignments`` are the reference's
determinism contract, its ``scale_events`` the warm-start audit trail),
the ``FleetSummary``, the per-class breakdown, the compiler's counts
and a saved LUT cache, the global tier's admission decisions and the
flight-recorder frames. Scale-ups pay 0 LUT builds cold and warm, and a
scale-up or straggler rebuild that does miss the shared cache builds on
the fleet's device.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro import api as jax_api  # noqa: E402
from repro import fleet as jax_fleet  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.fleet import hierarchy as jax_hierarchy  # noqa: E402
from repro_torch import api, fleet, obs  # noqa: E402
from repro_torch.fleet import hierarchy  # noqa: E402
from test_torch_fleet import (PACKAGES, assert_same_stats,  # noqa: E402
                              make_trace)

asdict = dataclasses.asdict

HIER_CASES = {
    "determinism": (dict(sub="tpu-pool", n_cells=3, engines_per_cell=2,
                         seed=7, class_mix={"interactive": 0.3,
                                            "batch": 0.2, "default": 0.5},
                         budgets={"interactive": 2.0, "batch": 8.0}),
                    ("mmpp", dict(n_slices=20, seed=3))),
    "step-autoscale": (dict(sub="tpu-pool", n_cells=2, engines_per_cell=2,
                            autoscale=True, max_engines=6),
                       ("replay", [40] * 12 + [2] * 20)),
    "bounds": (dict(sub="tpu-pool", n_cells=2, engines_per_cell=1,
                    autoscale=True, max_engines=3), ("replay", [60] * 10)),
    "scale-up-serves": (dict(sub="tpu-pool", n_cells=1, engines_per_cell=1,
                             autoscale=True, max_engines=4),
                        ("replay", [50] * 12)),
    "classes": (dict(sub="tpu-pool", n_cells=2, engines_per_cell=2,
                     class_mix={"interactive": 0.5, "default": 0.5},
                     budgets={"interactive": 2.0}),
                ("mmpp", dict(n_slices=20, seed=0))),
    "jsq": (dict(sub="tpu-pool", n_cells=2, engines_per_cell=2,
                 cell_policy="jsq"), ("replay", [12] * 8)),
    "cycled-substrates": (dict(sub=["tpu-pool", "gpu-pool"], n_cells=2,
                               engines_per_cell=1, forecaster="holt"),
                          ("diurnal", dict(n_slices=16, seed=1))),
    "cxl3-mixed-energy": (dict(sub="cxl-tier-3-mixed", n_cells=3,
                               engines_per_cell=2, energy_weight=0.5,
                               admit_headroom=0.8, autoscale=True,
                               min_engines=2, autoscale_kw={"patience": 1}),
                          ("ramp", dict(n_slices=18, seed=2, end=30))),
    "gpu-mixed-dp-flash": (dict(sub="gpu-pool-mixed", n_cells=4,
                                engines_per_cell=4, autoscale=True,
                                max_engines=8, solver="dp"),
                           ("flash", dict(n_slices=24, seed=0,
                                          spike=300.0, spike_slice=0,
                                          decay=0.9))),
}


def run_hier(mod_api, mod_fleet, dev, case, compiler=None):
    kw, trace_spec = HIER_CASES[case]
    kw = dict(kw)
    sub = kw.pop("sub")
    pc = compiler if compiler is not None else mod_api.compiler(**dev)
    hf = mod_api.hierarchical_fleet(sub, compiler=pc, **dev, **kw)
    res = hf.run(make_trace(mod_fleet, trace_spec))
    return hf, res, pc


def assert_same_hierarchy(ours, ref, budgets=None):
    assert asdict(ours) == asdict(ref)
    assert ours.assignments == ref.assignments
    assert (ours.scale_up_builds, ours.n_scale_ups, ours.n_scale_downs) \
        == (ref.scale_up_builds, ref.n_scale_ups, ref.n_scale_downs)
    assert asdict(fleet.summarize(ours)) == asdict(
        jax_fleet.summarize(ref))
    assert fleet.class_breakdown(ours, budgets) == \
        jax_fleet.class_breakdown(ref, budgets)


@pytest.mark.parametrize("case", sorted(HIER_CASES))
def test_hierarchical_fleet_matches_jax(case):
    (hj, rj, pj), (ht, rt, pt) = [run_hier(*p, case) for p in PACKAGES]
    assert_same_hierarchy(rt, rj, HIER_CASES[case][0].get("budgets"))
    assert_same_stats(pt, pj)
    assert rt.scale_up_builds == 0
    assert rt.assignments, "no request was ever admitted"
    if case == "gpu-mixed-dp-flash":      # new workers, not only unparked
        assert any(e.direction == "up" and not e.unparked
                   for e in rt.scale_events)
    assert ht.n_engines == hj.n_engines
    assert [(c.cid, c.substrate.name, c.n_active, len(c.workers))
            for c in ht.cells] == [(c.cid, c.substrate.name, c.n_active,
                                    len(c.workers)) for c in hj.cells]
    assert ht.router.budgets == hj.router.budgets
    if HIER_CASES[case][0].get("solver") == "dp":
        assert pt.stats()["builds_by_backend"] == {"cpu": pt.n_builds}


def test_scale_ups_cost_zero_lut_builds_cold_and_warm_match_jax(tmp_path):
    """tests/test_hierarchy.py's warm-start pin in both packages: one
    build at bring-up, 0 on scale-up, and a restarted process that
    loads the saved cache (the same file in both) builds nothing."""
    kw = dict(n_cells=2, engines_per_cell=1, autoscale=True,
              max_engines=4)
    runs = []
    for mod_api, mod_fleet, dev in PACKAGES:
        tr = mod_fleet.traces.replay_trace([50] * 10 + [1] * 12)
        pc = mod_api.compiler(**dev)
        res = mod_api.hierarchical_fleet("tpu-pool", compiler=pc, **dev,
                                         **kw).run(tr)
        path = tmp_path / ("ours.json" if dev else "ref.json")
        pc.save(path)
        pc2 = mod_api.compiler(**dev)
        assert pc2.load(path) == 1
        res2 = mod_api.hierarchical_fleet("tpu-pool", compiler=pc2, **dev,
                                          **kw).run(tr)
        runs.append((res, res2, pc, pc2, json.loads(path.read_text())))
    (rt, rt2, pt, pt2, saved_t), (rj, rj2, pj, pj2, saved_j) = runs[1], \
        runs[0]
    assert_same_hierarchy(rt, rj)
    assert_same_hierarchy(rt2, rj2)
    assert_same_stats(pt, pj)
    assert_same_stats(pt2, pj2)
    assert saved_t == saved_j
    assert rt.n_scale_ups > 0 and rt.scale_up_builds == 0
    assert pt.n_builds == 1
    assert pt2.n_builds == 0 and pt2.n_loaded == 1
    assert rt2.scale_up_builds == 0
    assert all(e.lut_builds == 0 for e in rt.scale_events
               if e.direction == "up" and e.unparked)


def test_cold_scale_up_and_straggler_misses_build_on_the_fleet_device():
    """A LUT the shared cache does not hold is built by the worker's own
    solver: a CPU fleet must build it on the CPU (a solver resolved on
    the default device would reach for the card and raise here)."""
    runs = []
    for mod_api, mod_fleet, dev in PACKAGES:
        pc = mod_api.compiler(**dev)
        hf = mod_api.hierarchical_fleet(
            "gpu-pool", n_cells=2, engines_per_cell=1, autoscale=True,
            max_engines=3, solver="dp", compiler=pc, **dev)
        pc._cache.clear()                 # every scale-up now misses
        res = hf.run(mod_fleet.traces.replay_trace([50] * 10))
        sched = hf.cells[0].workers[0].sched
        sched.observe_slowdown(sched.arch.clusters[0].name, 2.0)
        sched.step(4)                     # the straggler rebuild
        runs.append((res, pc))
    (rt, pt), (rj, pj) = runs[1], runs[0]
    assert_same_hierarchy(rt, rj)
    assert_same_stats(pt, pj)
    assert rt.scale_up_builds > 0
    assert pt.stats()["builds_by_backend"] == {"cpu": pt.n_builds}
    assert pt.n_builds == 1 + rt.scale_up_builds + 1


def _one_cell_router(mod_api, mod_fleet, dev, budgets=None):
    fl = mod_api.fleet("tpu-pool", n_engines=1, forecaster="none", **dev)
    cell = mod_fleet.Cell(0, fl.workers, tokens_per_task=2)
    router = mod_fleet.CellRouter([cell], budgets=budgets)
    router.refresh()
    return cell, router


def test_cell_router_admission_matches_jax():
    """The global tier's wait-based admission, class by class: the same
    decision, reason and expected wait for every request."""
    budgets = {"batch": 8.0, "interactive": 2.0}
    runs = []
    for mod_api, mod_fleet, dev in PACKAGES:
        cell, router = _one_cell_router(mod_api, mod_fleet, dev, budgets)
        log = []
        for rid, cls in enumerate(["interactive"] * 60 + ["batch"] * 200
                                  + ["default"] * 5):
            req = mod_fleet.FleetRequest(rid=rid, arrival_slice=0,
                                         slo_class=cls)
            ok = router.route(req)
            log.append((ok, req.admission, req.cell, req.wait_est,
                        cell.backlog, cell.expected_wait_slices(0),
                        cell.expected_latency_slices(1)))
        runs.append(log)
    assert runs[1] == runs[0]
    admitted = {cls: sum(ok for (ok, *_), c in zip(
        runs[1], ["interactive"] * 60 + ["batch"] * 200 + ["default"] * 5)
        if c == cls) for cls in ("interactive", "batch")}
    assert 0 < admitted["interactive"] < 60
    assert admitted["batch"] > admitted["interactive"]


def test_construction_errors_match_jax():
    cases = [
        (lambda f, a, d: f.Cell(0, []), ValueError),
        (lambda f, a, d: f.HierarchicalFleet([]), ValueError),
        (lambda f, a, d: a.hierarchical_fleet(
            "tpu-pool", n_cells=1, engines_per_cell=1,
            cell_policy="fastest", **d), ValueError),
        (lambda f, a, d: _one_cell_router(a, f, d, {"batch": 8.0})[1]
         .budget("nope"), ValueError),
    ]
    for call, exc in cases:
        msgs = []
        for mod_api, mod_fleet, dev in PACKAGES:
            with pytest.raises(exc) as e:
                call(mod_fleet, mod_api, dev)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    hf = api.hierarchical_fleet("tpu-pool", n_cells=1, engines_per_cell=1,
                                class_mix={"interactive": 0.5,
                                           "bulk": 0.5},
                                budgets={"interactive": 1.5},
                                device="cpu")
    assert hf.router.budget("interactive") == 1.5
    assert hf.router.budget("bulk") == 2.0
    assert hierarchy.REASON_BUDGET == jax_hierarchy.REASON_BUDGET


def test_hierarchy_flight_frames_and_admission_metrics_match_jax():
    """tests/test_hierarchy.py's instrumented autoscaling run: the same
    frames (cell aggregates, scale events, cache counters), metrics and
    span names and arguments."""
    runs = []
    for mod_api, mod_fleet, dev in PACKAGES:
        o = jax_obs if mod_api is jax_api else obs
        o.reset()
        rec = o.FlightRecorder(capacity=16, miss_rate_threshold=2.0)
        o.enable(flight_recorder=rec)
        try:
            hf = mod_api.hierarchical_fleet(
                "tpu-pool", n_cells=2, engines_per_cell=1, autoscale=True,
                max_engines=2, **dev)
            hf.run(mod_fleet.traces.replay_trace([8] * 6))
            cell, router = _one_cell_router(mod_api, mod_fleet, dev)
            for rid in range(200):
                router.route(mod_fleet.FleetRequest(rid=rid,
                                                    arrival_slice=0))
            runs.append((list(rec.frames), o.metrics().as_dict(),
                         [(e["name"], e.get("cat"), e.get("args"))
                          for e in o.tracer().events()]))
        finally:
            o.reset()
    assert runs[1] == runs[0]
    frames, metrics, _ = runs[1]
    assert {"arrivals", "admitted", "rejected", "cells", "scale_events",
            "lut_cache", "running"} <= set(frames[-1])
    json.dumps(frames[-1])
    assert any(k.startswith("fleet.admission{") and
               f"reason={hierarchy.REASON_BUDGET}" in k
               for k in metrics["counters"])
