"""The port's flat serving fleet against the JAX package's, on the CPU.

Both packages run the same fleet on the same trace (``device="cpu"`` for
the port). The fleet is host code (float64 numpy) over bitwise-equal
LUTs, so everything it reports must be *equal*, with no tolerance:

* traces and forecaster predictions;
* the scheduler's predicted-load hooks (``lookup_tasks``,
  ``cap_to_capacity``), also through ``HeteroServeEngine.run_slice``;
* per-worker ``SliceReport`` sequences, every request's stamps, the
  ``FleetSummary``, the per-class breakdown and the compiler's build
  and hit counts, over the reference tests' fleets (tests/test_fleet.py)
  and over the dp solver with the DVFS controller;
* the spans, metrics and flight-recorder frames of an instrumented run
  (tests/test_obs.py);
* the ``--json`` output and stdout of ``launch/fleet.py --no-decode``
  on the flat, ``--cells`` and ``dag:mixed`` paths, and ``launch/obs``.

A ``decode=True`` fleet (gpu-pool-mixed, dp, DVFS) runs the same
weights (JAX's init carried over by ``lm.params_from_numpy``): every
worker's int8 tiers and scales bitwise, bf16 tiers equal, each decode
step's tokens equal, and reports equal to the same fleet with
``decode=False``. tests/test_torch_hierarchy.py and
tests/test_torch_dag.py hold the cell and DAG fleets.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as jax_api  # noqa: E402
from repro import fleet as jax_fleet  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import fleet as jax_cli  # noqa: E402
from repro.launch import obs as jax_obs_cli  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import api, fleet, obs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.compiler import PlacementCompiler  # noqa: E402
from repro_torch.launch import fleet as cli  # noqa: E402
from repro_torch.launch import obs as obs_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_serve import (LOGIT_ATOL, _jax_params, _np,  # noqa: E402
                              _Recorder, _top2_margin)

asdict = dataclasses.asdict

# (api module, fleet module, device keywords): the reference first
PACKAGES = ((jax_api, jax_fleet, {}), (api, fleet, {"device": "cpu"}))


def assert_same_stats(ours, ref):
    """``pc.stats()`` equal. The backend labels name each package's own
    engine (the port's "cpu"/"cuda", the reference's), so the per-label
    counts are held by their total and the port's labels by name."""
    a, b = ours.stats(), ref.stats()
    by_a, by_b = a.pop("builds_by_backend"), b.pop("builds_by_backend")
    assert a == b
    assert sum(by_a.values()) == sum(by_b.values()) == a["builds"]
    assert set(by_a) <= {"cpu", "host"}, by_a
    assert by_a.get("host", 0) == by_b.get("host", 0)


def assert_same_fleet_result(ours, ref):
    assert asdict(ours) == asdict(ref)
    assert asdict(fleet.summarize(ours)) == asdict(
        jax_fleet.summarize(ref))
    assert fleet.class_breakdown(ours) == jax_fleet.class_breakdown(ref)


def make_trace(fl_mod, spec):
    if spec[0] == "replay":
        return fl_mod.traces.replay_trace(spec[1])
    return fl_mod.make_trace(spec[0], **spec[1])


# -- traces and forecasters --------------------------------------------------

TRACE_SPECS = [(name, dict(n_slices=30, seed=3)) for name in
               sorted(jax_fleet.TRACES)] + [
    ("flash", dict(n_slices=30, seed=0, spike_slice=10, spike=40.0,
                   base=1.0)),
    ("ramp", dict(n_slices=40, seed=1, end=12)),
    ("poisson", dict(n_slices=50, seed=1, rate=1.0)),
    ("case3_periodic_spike", {}), ("case6_random", {}),
]


@pytest.mark.parametrize("spec", TRACE_SPECS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(TRACE_SPECS)])
def test_traces_match(spec):
    ref = jax_fleet.make_trace(spec[0], **spec[1])
    ours = fleet.make_trace(spec[0], **spec[1])
    assert asdict(ours) == asdict(ref)
    assert (ours.total, ours.peak, len(ours)) == (ref.total, ref.peak,
                                                  len(ref))
    assert asdict(ours.truncated(ref.total // 2)) == asdict(
        ref.truncated(ref.total // 2))


def test_registries_and_errors_match():
    assert sorted(fleet.TRACES) == sorted(jax_fleet.TRACES)
    assert fleet.BURSTY == jax_fleet.BURSTY
    assert sorted(fleet.FORECASTERS) == sorted(jax_fleet.FORECASTERS)
    assert fleet.POLICIES == jax_fleet.POLICIES
    assert fleet.CELL_POLICIES == jax_fleet.CELL_POLICIES
    assert fleet.__all__ == jax_fleet.__all__
    for ours, ref in ((lambda: fleet.make_trace("nope"),
                       lambda: jax_fleet.make_trace("nope")),
                      (lambda: fleet.make_forecaster("oracle"),
                       lambda: jax_fleet.make_forecaster("oracle")),
                      (lambda: api.fleet("tpu-pool", n_engines=1,
                                         policy="fastest", device="cpu"),
                       lambda: jax_api.fleet("tpu-pool", n_engines=1,
                                             policy="fastest")),
                      (lambda: fleet.Fleet([]), lambda: jax_fleet.Fleet([]))):
        with pytest.raises(ValueError) as ej:
            ref()
        with pytest.raises(ValueError, match=None) as et:
            ours()
        assert str(et.value) == str(ej.value)


FORECASTS = [("none", {}), ("last", {}), ("ewma", {}), ("ewma",
             {"alpha": 0.3}), ("ar1", {}), ("ar1", {"min_obs": 1}),
             ("holt", {}), ("holt", {"alpha": 0.6, "beta": 0.4}),
             ("seasonal", {}), ("seasonal", {"period": 3})]


@pytest.mark.parametrize("name,kw", FORECASTS,
                         ids=[f"{n}{sorted(k.items())}" for n, k in
                              FORECASTS])
def test_forecaster_predictions_match(name, kw):
    rng = np.random.default_rng(0)
    series = list(jax_fleet.make_trace("mmpp", n_slices=40).arrivals)
    series += list(rng.poisson(5.0, size=20)) + list(range(1, 11))
    ours = fleet.make_forecaster(name, **kw)
    ref = jax_fleet.make_forecaster(name, **kw)
    preds = []
    for x in series:
        ours.observe(int(x))
        ref.observe(int(x))
        preds.append((ours.predict(), ref.predict()))
    assert all(a == b for a, b in preds), preds
    assert all(a >= 0.0 for a, _ in preds)


# -- the scheduler's predicted-load hooks ------------------------------------

HOOK_CALLS = [((2,), {}), ((2,), {"lookup_tasks": 10}), ((10,), {}),
              ((500,), {"cap_to_capacity": True}),
              ((1,), {"cap_to_capacity": True}),
              ((3,), {"lookup_tasks": 0, "cap_to_capacity": True}),
              ((5,), {})]


@pytest.mark.parametrize("sub,kw", [("tpu-pool", {}),
                                    ("gpu-pool", {"solver": "dp"})])
def test_scheduler_hooks_match(sub, kw):
    ref = jax_api.fleet(sub, n_engines=1, forecaster="none", **kw)
    ours = api.fleet(sub, n_engines=1, forecaster="none", device="cpu",
                     **kw)
    for a, k in HOOK_CALLS:
        rj = ref.workers[0].sched.step(*a, **k)
        rt = ours.workers[0].sched.step(*a, **k)
        assert asdict(rt) == asdict(rj), (a, k)


@pytest.fixture(scope="module")
def smoke_params():
    cfg_j, cfg_t = jax_smoke("internlm2_1_8b"), get_smoke_config(
        "internlm2_1_8b")
    pj, pt = _jax_params(cfg_j)
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("kw", [
    {"lookup_tasks": 10}, {"cap_to_capacity": True},
    {"lookup_tasks": 6, "cap_to_capacity": True}],
    ids=["lookup", "cap", "both"])
def test_run_slice_keywords_match(kw, smoke_params, monkeypatch):
    """``HeteroServeEngine.run_slice(lookup_tasks=, cap_to_capacity=)``:
    the reference's reports, re-tiering and tokens."""
    cfg_j, cfg_t, pj, pt = smoke_params
    rec = _Recorder(jax_lm, monkeypatch)
    ej = jax_api.engine("gpu-pool", cfg_j, pj, max_batch=4, lut_points=16)
    et = api.engine("gpu-pool", cfg_t, pt, max_batch=4, lut_points=16,
                    device="cpu")
    capped = 0
    for n in (1, 3, 40, 2, 0, 9):
        rj, rt = ej.run_slice(n, **kw), et.run_slice(n, **kw)
        assert asdict(rt.report) == asdict(rj.report)
        assert rt.retiered == rj.retiered
        capped += rj.report.n_executed is not None \
            and rj.report.n_executed < n
        if rj.tokens.size:
            assert _top2_margin(rec.logits[-1][:rj.tokens.size]) \
                > LOGIT_ATOL
        np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert (capped > 0) == bool(kw.get("cap_to_capacity"))


# -- flat fleets -------------------------------------------------------------

# the fleets of tests/test_fleet.py and tests/test_obs.py, plus the dp
# solver with and without the DVFS controller
FLAT_CASES = {
    "mmpp-ewma": (dict(sub="tpu-pool", n_engines=2, forecaster="ewma"),
                  ("mmpp", dict(n_slices=20, seed=0)), {}),
    "mixed-slo": (dict(sub="tpu-pool-mixed", n_engines=2,
                       forecaster="none", policy="slo"),
                  ("replay", [8, 8, 8, 8]), {}),
    "least-loaded": (dict(sub="tpu-pool", n_engines=2, forecaster="none",
                          policy="least_loaded"), ("replay", [10, 10]), {}),
    "round-robin": (dict(sub="tpu-pool-mixed", n_engines=3,
                         forecaster="last", policy="round_robin"),
                    ("diurnal", dict(n_slices=20, seed=2)), {}),
    "admission": (dict(sub="tpu-pool", n_engines=1, forecaster="none",
                       admission_limit=4), ("replay", [10, 0, 0, 0, 0, 0]),
                  {}),
    "degenerate": (dict(sub="tpu-pool", n_engines=1, forecaster="none",
                        admission_limit=0), ("replay", [3, 2]), {}),
    "unfinished": (dict(sub="tpu-pool", n_engines=1, forecaster="none"),
                   ("replay", [200]), {"max_drain_slices": 2}),
    "ramp-margin": (dict(sub="tpu-pool", n_engines=1, forecaster="ewma",
                         forecast_margin=1.3),
                    ("ramp", dict(n_slices=40, seed=1, end=12)), {}),
    "light": (dict(sub="tpu-pool", n_engines=2, forecaster="none"),
              ("replay", [2] * 15), {}),
    "gpu-mixed-dp-dvfs": (dict(sub="gpu-pool-mixed", n_engines=4,
                               forecaster="holt", solver="dp", dvfs=True),
                          ("mmpp", dict(n_slices=16, seed=0)), {}),
    "cxl3-dp-dvfs3": (dict(sub="cxl-tier-3", n_engines=2, solver="dp",
                           dvfs=3, forecaster="ar1", lut_points=12),
                      ("flash", dict(n_slices=14, seed=4)), {}),
    "edge-dp": (dict(sub="edge-hhpim", n_engines=2, solver="dp",
                     forecaster="seasonal", forecaster_kw={"period": 4},
                     t_slice_ms=0.5), ("replay", [1, 3, 0, 5, 2]), {}),
}


def run_flat(mod_api, mod_fleet, dev, case):
    kw, trace_spec, run_kw = FLAT_CASES[case]
    kw = dict(kw)
    sub = kw.pop("sub")
    pc = mod_api.compiler(**dev)
    fl = mod_api.fleet(sub, compiler=pc, **dev, **kw)
    res = fl.run(make_trace(mod_fleet, trace_spec), **run_kw)
    return fl, res, pc


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_fleet_matches_jax(case):
    (fj, rj, pj), (ft, rt, pt) = [run_flat(*p, case) for p in PACKAGES]
    assert_same_fleet_result(rt, rj)
    assert_same_stats(pt, pj)
    for wt, wj in zip(ft.workers, fj.workers, strict=True):
        assert wt.tokens_decoded == wj.tokens_decoded
        assert wt.forecaster.predict() == wj.forecaster.predict()
        assert wt.expected_wait_slices(3) == wj.expected_wait_slices(3)
    s = fleet.summarize(rt)
    assert s.n_submitted == (len(rt.completed) + len(rt.rejected)
                             + len(rt.unfinished))
    if "solver" in FLAT_CASES[case][0]:
        assert pt.stats()["builds_by_backend"] == {"cpu": pt.n_builds}
    if FLAT_CASES[case][0].get("dvfs"):
        assert all(r.clock is not None for w in ft.workers
                   for r in w.reports)


def test_straggler_rebuild_builds_on_the_fleet_device():
    """A worker told that a pool runs 2x slower rebuilds its LUT through
    the shared compiler with its own solver: on a CPU fleet that build
    runs on the CPU (a solver resolved on the default device would reach
    for the card), and the re-solved placements match the reference."""
    runs = []
    for mod_api, mod_fleet, dev in PACKAGES:
        pc = mod_api.compiler(**dev)
        fl = mod_api.fleet("gpu-pool", n_engines=2, solver="dp",
                           forecaster="none", compiler=pc, **dev)
        sched = fl.workers[1].sched
        sched.observe_slowdown(sched.arch.clusters[0].name, 2.0)
        res = fl.run(mod_fleet.make_trace("mmpp", n_slices=10, seed=5))
        runs.append((res, pc))
    (rt, pt), (rj, pj) = runs[1], runs[0]
    assert_same_fleet_result(rt, rj)
    assert_same_stats(pt, pj)
    assert pt.stats()["builds_by_backend"] == {"cpu": 2}


def test_instrumented_fleet_matches_jax(tmp_path):
    """tests/test_obs.py's instrumented fleet: the same spans (names,
    categories, arguments), metrics, flight-recorder frames and dumps,
    and the exported engine tracks."""
    seen = []
    for mod_api, mod_fleet, dev in PACKAGES:
        o = jax_obs if mod_api is jax_api else obs
        o.reset()
        rec = o.FlightRecorder(capacity=16, miss_rate_threshold=0.0)
        o.enable(flight_recorder=rec)
        try:
            fl = mod_api.fleet("tpu-pool", n_engines=2, forecaster="ewma",
                               **dev)
            s = mod_fleet.summarize(fl.run(mod_fleet.make_trace(
                "mmpp", n_slices=12, seed=0)))
            events = [(e["name"], e.get("cat"), e.get("args"))
                      for e in o.tracer().events()]
            out = tmp_path / ("ours" if dev else "ref")
            paths = o.export(trace_path=out / "trace.json",
                             metrics_path=out / "metrics.json")
            doc = json.loads(paths["trace"].read_text())
            tracks = sorted(e["args"]["name"] for e in doc["traceEvents"]
                            if e["ph"] == "M")
            seen.append((asdict(s), events, o.metrics().as_dict(),
                         list(rec.frames), rec.n_dumps,
                         rec.last_dump["reason"], tracks))
        finally:
            o.reset()
    (s, events, metrics, frames, n_dumps, reason, tracks), ref = seen[1], \
        seen[0]
    assert (s, events, metrics, frames, n_dumps, reason, tracks) == ref
    assert s["n_completed"] > 0 and n_dumps >= 1
    assert {"fleet.slice", "worker.step", "sched.slice"} <= {
        e[0] for e in events}
    assert {"engine-0", "engine-1"} <= set(tracks)


# -- the decoding fleet ------------------------------------------------------

DECODE_KW = dict(n_engines=2, solver="dp", dvfs=True, forecaster="holt",
                 max_batch=4)


@pytest.fixture(scope="module")
def decode_fleets(smoke_params):
    """gpu-pool-mixed with decode=True in both packages (each decode
    step's logits recorded), and the port's fleet with decode=False."""
    cfg_j, cfg_t, pj, pt = smoke_params
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        recs = {"ref": _Recorder(jax_lm, mp), "ours": _Recorder(lm, mp)}
        for key, mod_api, mod_fleet, cfg, params, dev in (
                ("ref", jax_api, jax_fleet, cfg_j, pj, {}),
                ("ours", api, fleet, cfg_t, pt, {"device": "cpu"})):
            pc = mod_api.compiler(**dev)
            fl = mod_api.fleet("gpu-pool-mixed", cfg, params=params,
                               decode=True, compiler=pc, **DECODE_KW, **dev)
            res = fl.run(mod_fleet.make_trace("mmpp", n_slices=8, seed=0))
            out[key] = dict(fleet=fl, res=res, pc=pc,
                            logits=recs[key].logits)
    analytic = {}
    for key, mod_api, mod_fleet, cfg, dev in (
            ("ref", jax_api, jax_fleet, cfg_j, {}),
            ("ours", api, fleet, cfg_t, {"device": "cpu"})):
        pc = mod_api.compiler(**dev)
        fl = mod_api.fleet("gpu-pool-mixed", cfg, decode=False,
                           compiler=pc, **DECODE_KW, **dev)
        analytic[key] = dict(res=fl.run(mod_fleet.make_trace(
            "mmpp", n_slices=8, seed=0)), pc=pc)
    out["analytic"] = analytic
    return out


def test_decode_fleet_reports_match_jax_and_the_analytic_fleet(
        decode_fleets):
    ours, ref = decode_fleets["ours"], decode_fleets["ref"]
    assert_same_fleet_result(ours["res"], ref["res"])
    assert_same_stats(ours["pc"], ref["pc"])
    assert ours["pc"].stats()["builds_by_backend"] == {
        "cpu": ours["pc"].n_builds}
    # scheduling does not read decoding: the same reports, summary and
    # builds as the fleet without engines, in both packages
    for key in ("ours", "ref"):
        plain = decode_fleets["analytic"][key]
        assert asdict(decode_fleets[key]["res"]) == asdict(plain["res"])
        assert decode_fleets[key]["pc"].stats() == plain["pc"].stats()
    assert sum(r.moved_weights > 0 for reps in ours["res"].reports.values()
               for r in reps) > 0


def test_decode_fleet_tiers_match_jax(decode_fleets):
    cfg = get_smoke_config("internlm2_1_8b")
    for wt, wj in zip(decode_fleets["ours"]["fleet"].workers,
                      decode_fleets["ref"]["fleet"].workers, strict=True):
        et, ej = wt.hetero, wj.hetero
        assert et._tiered_placement == ej._tiered_placement
        assert list(et._tiered) == list(ej._tiered)
        assert len(et._tiered) == 2 * cfg.n_layers
        for key, segs in ej._tiered.items():
            assert list(et._tiered[key]) == list(segs)
            for tier, seg in segs.items():
                ours = et._tiered[key][tier]
                assert sorted(ours) == sorted(seg)
                for f, v in seg.items():
                    if f == "empty":
                        assert ours[f] == v
                        continue
                    assert str(ours[f].dtype).removeprefix("torch.") == \
                        str(v.dtype), (key, tier, f)
                    # int8 tiers and scales bitwise, bf16 tiers equal
                    np.testing.assert_array_equal(_np(ours[f]), _np(v),
                                                  err_msg=str((key, tier)))


def test_decode_fleet_tokens_match_jax(decode_fleets):
    lt = decode_fleets["ours"]["logits"]
    lj = decode_fleets["ref"]["logits"]
    assert len(lt) == len(lj) > 0
    for step, (a, b) in enumerate(zip(lt, lj)):
        assert _top2_margin(b) > LOGIT_ATOL, \
            f"step {step}: near-tie, pick another seed"
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1),
                                      err_msg=f"step {step}")
    for wt, wj in zip(decode_fleets["ours"]["fleet"].workers,
                      decode_fleets["ref"]["fleet"].workers):
        np.testing.assert_array_equal(wt.hetero._toks.numpy(),
                                      np.asarray(wj.hetero._toks))
        assert wt.hetero._pos == wj.hetero._pos > 0


# -- entry points and CLIs ---------------------------------------------------


def test_fleet_entry_points_default_to_cuda_and_raise_without_a_card(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract does "
                    "not apply")
    calls = [
        lambda: api.fleet("tpu-pool", n_engines=1),
        lambda: api.hierarchical_fleet("tpu-pool", n_cells=1,
                                       engines_per_cell=1),
        lambda: api.dag_fleet("tpu-pool", n_cells=1, engines_per_cell=1),
        lambda: cli.main(["--no-decode", "--steps", "2"]),
        lambda: cli.main(["--workload", "dag:mixed", "--steps", "2"]),
        lambda: obs_cli.main(["--steps", "2", "--out-dir",
                              str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    # a build service on another device is refused, not used
    with pytest.raises(ValueError, match="compiler builds on 'cuda'"):
        api.fleet("tpu-pool", compiler=PlacementCompiler(device="cuda"),
                  device="cpu")


CLI_CASES = {
    "flat": ["--workload", "mmpp", "--engines", "2", "--steps", "12",
             "--no-decode"],
    "flat-dp-dvfs": ["--substrate", "gpu-pool-mixed", "--solver", "dp",
                     "--dvfs-controller", "3", "--engines", "2",
                     "--steps", "8", "--no-decode", "--requests", "40",
                     "--forecaster", "holt", "--admission-limit", "6"],
    "cells": ["--cells", "2", "--engines", "4", "--autoscale",
              "--max-engines", "8", "--workload", "flash", "--steps",
              "14", "--no-decode", "--cell-policy", "jsq"],
    "dag-mixed": ["--workload", "dag:mixed", "--cells", "2", "--engines",
                  "2", "--steps", "8", "--no-decode"],
    "dag-tenants": ["--workload", "dag:agentic", "--cells", "2",
                    "--engines", "4", "--steps", "6", "--no-decode",
                    "--tenants", "a:interactive:agentic:2,b:batch",
                    "--request-level", "--quiet"],
}


def _run_cli(main, argv, out, capsys, extra=()):
    main(list(argv) + ["--json", str(out / "summary.json"), *extra])
    text = capsys.readouterr().out.replace(str(out), "<out>")
    return json.loads((out / "summary.json").read_text()), text


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_fleet_cli_json_and_stdout_match_jax(case, tmp_path, capsys):
    runs = []
    for main, dev in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        out = tmp_path / ("ours" if dev else "ref")
        out.mkdir()
        runs.append(_run_cli(main, CLI_CASES[case] + dev, out, capsys))
    (jt, tt), (jj, tj) = runs[1], runs[0]
    assert jt == jj
    assert tt == tj
    assert "lut-cache:" in tt
    if case.startswith("dag"):
        assert set(jt["dag"]) >= {"n_completed", "handoffs", "tenants"}


def test_fleet_cli_cache_trace_and_recorder_match_jax(tmp_path, capsys):
    """``--lut-cache`` (a cold run saves, a warm one loads: 0 builds),
    ``--trace`` and ``--flight-recorder``: the same stdout, summaries,
    saved caches, metrics snapshots and event counts."""
    argv = ["--substrate", "cxl-tier-3", "--solver", "dp", "--engines",
            "2", "--steps", "10", "--no-decode"]
    runs = []
    for main, dev, o in ((jax_cli.main, [], jax_obs),
                         (cli.main, ["--device", "cpu"], obs)):
        out = tmp_path / ("ours" if dev else "ref")
        out.mkdir()
        extra = ["--lut-cache", str(out / "luts.json"), "--trace",
                 str(out / "trace.json"), "--flight-recorder",
                 str(out / "flight.json"), "--miss-threshold", "0.0"]
        try:
            cold = _run_cli(main, argv + dev, out, capsys, extra)
            warm = _run_cli(main, argv + dev, out, capsys, extra)
        finally:
            o.reset()
        runs.append((cold, warm,
                     json.loads((out / "luts.json").read_text()),
                     json.loads((out / "metrics.json").read_text()),
                     sorted(json.loads((out / "flight.json").read_text()))))
    assert runs[1] == runs[0]
    (_, cold_text), (_, warm_text) = runs[1][:2]
    assert "(1 builds, " in cold_text and "(0 builds, " in warm_text
    assert "warm-start: loaded 1 cached LUTs" in warm_text


def test_fleet_cli_shaped_errors_match_jax():
    for argv in (["--workload", "dag:nope", "--steps", "4"],
                 ["--workload", "mmpp", "--tenants", "a:interactive",
                  "--steps", "4"],
                 ["--workload", "dag:mixed", "--tenants", "bad"],
                 ["--autoscale", "--no-decode"],
                 ["--cells", "2", "--dvfs-controller", "--substrate",
                  "gpu-pool"],
                 ["--substrate", "edge-hhpim", "--dvfs-controller"],
                 ["--substrate", "tpu-pool", "--mixed"]):
        with pytest.raises(SystemExit) as ej:
            jax_cli.main(argv)
        with pytest.raises(SystemExit) as et:
            cli.main(argv + ["--device", "cpu"])
        assert str(et.value) == str(ej.value), argv


def test_obs_cli_matches_jax(tmp_path, capsys):
    snaps = []
    for main, dev, o in ((jax_obs_cli.main, [], jax_obs),
                         (obs_cli.main, ["--device", "cpu"], obs)):
        out = tmp_path / ("ours" if dev else "ref")
        try:
            main(["--engines", "2", "--steps", "10", "--out-dir", str(out),
                  "--miss-threshold", "0.0"] + dev)
        finally:
            o.reset()
        text = capsys.readouterr().out
        trace = json.loads((out / "trace.json").read_text())
        snaps.append((json.loads((out / "metrics.json").read_text()),
                      text.splitlines()[:2],
                      sorted(e["name"] for e in trace["traceEvents"]),
                      (out / "flight.json").exists()))
        main(["--summarize", str(out / "trace.json")])
        assert "spans (" in capsys.readouterr().out
    assert snaps[1] == snaps[0]
    assert snaps[1][3]
