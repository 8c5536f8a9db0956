"""The port's ``obs`` on the profiler's clock, and the decode split.

A clock anchor pairs the spans' ``perf_counter_ns`` with the Unix-epoch
clock of ``torch.profiler``'s events; the export carries it under
``otherData`` and adds no metadata event. A decoding engine's
``engine.decode`` span holds ``engine.decode.dispatch`` and
``engine.decode.wait`` on its own track, which tile it.
"""
import json
import statistics
import time

import pytest
import torch

from repro_torch import api, obs
from repro_torch.configs import get_smoke_config
from repro_torch.fleet import make_trace
from repro_torch.models import lm

# the spans' clock against the Unix clock: the anchor's bracket plus a
# read of each clock
CLOCK_SLACK_NS = 100_000
# an obs span opened inside a profiler range starts this close to it
RANGE_SLACK_NS = 250_000


@pytest.fixture
def fresh_obs():
    obs.reset()
    try:
        yield obs
    finally:
        obs.reset()


def test_enable_takes_an_anchor_and_reset_drops_it(fresh_obs):
    assert obs.tracer().anchor is None
    obs.enable()
    a = obs.tracer().anchor
    assert set(a) == {"perf_counter_ns", "unix_ns", "ts0_unix_ns",
                      "uncertainty_ns"}
    assert a["ts0_unix_ns"] == a["unix_ns"] - (a["perf_counter_ns"]
                                               - obs.tracer().t0_ns)
    assert 0 <= a["uncertainty_ns"] < CLOCK_SLACK_NS
    obs.reset()
    assert obs.tracer().anchor is None


def test_converted_spans_land_on_the_unix_clock(fresh_obs):
    obs.enable()
    u0 = time.time_ns()
    t0 = obs.now_ns()
    time.sleep(0.002)
    obs.complete("probe", t0)
    u1 = time.time_ns()
    ev, = obs.tracer().events()
    a = obs.tracer().anchor
    start = obs.to_unix_ns(ev["ts"], a)
    end = obs.to_unix_ns(ev["ts"] + ev["dur"], a)
    assert u0 - CLOCK_SLACK_NS <= start < end <= u1 + CLOCK_SLACK_NS
    assert end - start >= 2_000_000


def test_an_anchor_taken_again_agrees_with_the_first(fresh_obs):
    """The harness asks for a fresh anchor as its profile starts: both
    put the same span at the same Unix time."""
    obs.enable()
    first = dict(obs.tracer().anchor)
    t0 = obs.now_ns()
    obs.complete("probe", t0)
    time.sleep(0.01)
    again = obs.clock_anchor()
    assert obs.tracer().anchor == again
    assert again["perf_counter_ns"] > first["perf_counter_ns"]
    ts = obs.tracer().events()[0]["ts"]
    assert abs(obs.to_unix_ns(ts, again) - obs.to_unix_ns(ts, first)) \
        <= 2 * CLOCK_SLACK_NS


def test_export_carries_the_anchor_and_no_metadata_event(fresh_obs,
                                                          tmp_path):
    tr = obs.Tracer()
    tr.name_track(3, "engine-3")
    tr.complete("x", tr.t0_ns, tr.t0_ns + 1000, tid=3)
    assert "otherData" not in tr.to_chrome()
    anchor = tr.clock_anchor()
    doc = json.loads(tr.export(tmp_path / "trace.json").read_text())
    assert doc["otherData"] == {"clock_anchor": anchor}
    assert [e for e in doc["traceEvents"] if e["ph"] == "M"] == [
        {"name": "thread_name", "ph": "M", "pid": tr.pid, "tid": 3,
         "args": {"name": "engine-3"}}]
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == \
        ["x"]


def test_spans_meet_the_profilers_ranges(fresh_obs):
    """An obs span opened inside a ``record_function`` range converts to
    the range's start (the CPU profiler's host clock, as on the card)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        anchor = obs.clock_anchor()
        for i in range(6):
            with record_function(f"pb.range{i}"):
                t0 = obs.now_ns()
                torch.ones(64).sum()
                obs.complete(f"span{i}", t0)
    ranges = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pb.range")}
    # the first range pays the profiler's first-call costs
    gaps = [obs.to_unix_ns(ev["ts"], anchor) - ranges[f"pb.range{i}"]
            for ev in obs.tracer().events()
            for i in [int(ev["name"][4:])] if i > 0]
    assert len(gaps) == 5
    assert abs(statistics.median(gaps)) <= RANGE_SLACK_NS, gaps


@pytest.fixture(scope="module")
def decode_fleet_events():
    """A 2-engine decoding smoke fleet on the CPU, traced over 6 slices."""
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    obs.reset()
    try:
        obs.enable()
        fl = api.fleet("gpu-pool-mixed", cfg, params=params, decode=True,
                       n_engines=2, solver="dp", dvfs=True, max_batch=4,
                       device="cpu")
        fl.run(make_trace("mmpp", n_slices=6, seed=0))
        return obs.tracer().events()
    finally:
        obs.reset()


def test_decode_split_tiles_each_decode_on_its_track(decode_fleet_events):
    evs = decode_fleet_events
    decodes = [e for e in evs if e["name"] == "engine.decode"]
    assert decodes
    parts = {n: [e for e in evs if e["name"] == f"engine.decode.{n}"]
             for n in ("dispatch", "wait")}
    assert all(len(p) == len(decodes) for p in parts.values())
    order = {id(e): i for i, e in enumerate(evs)}
    for d in decodes:
        inside = {}
        for n, ps in parts.items():
            hit = [p for p in ps if p["tid"] == d["tid"]
                   and d["ts"] <= p["ts"]
                   and p["ts"] + p["dur"] <= d["ts"] + d["dur"] + 1e-3]
            assert len(hit) == 1, (n, d)
            inside[n] = hit[0]
        covered = inside["dispatch"]["dur"] + inside["wait"]["dur"]
        assert covered == pytest.approx(d["dur"], rel=0.05, abs=1e-3)
        assert inside["dispatch"]["ts"] <= inside["wait"]["ts"]
        # recorded parent first, so viewers nest the same-start child
        assert (order[id(d)] < order[id(inside["dispatch"])]
                < order[id(inside["wait"])])
        assert d["args"] == {"n_requests": d["args"]["n_requests"]}


def test_decode_split_records_nothing_with_tracing_off(fresh_obs):
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    eng = api.engine("gpu-pool", cfg, params, max_batch=4, lut_points=16,
                     device="cpu")
    eng.run_slice(3)
    assert len(obs.tracer()) == 0
