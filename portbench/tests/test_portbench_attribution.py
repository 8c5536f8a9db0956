"""The join of the program's spans with the profiler's device intervals
and their launches: a device interval belongs to the spans open when it
was launched, however late it ran; an idle stretch of the card to the
innermost span open while it lasted. Synthetic profiler-like events
here; on the card, the profiler's own."""
import pytest
import torch

from portbench.tests import smoke  # noqa: F401  (puts src on the path)
from portbench import attribution, bench
# spans are written in us on the tracer's clock; this anchor puts ts 0
# at 1,000,000 ns of the profiler's clock
ANCHOR = {"perf_counter_ns": 0, "unix_ns": 1_000_000,
          "ts0_unix_ns": 1_000_000, "uncertainty_ns": 0}
T0 = ANCHOR["ts0_unix_ns"]


def _span(name, a_ns, b_ns, tid=0):
    """An obs complete event whose ends lie at ``a_ns``, ``b_ns`` of the
    profiler's clock."""
    return {"name": name, "ph": "X", "ts": (a_ns - T0) / 1e3,
            "dur": (b_ns - a_ns) / 1e3, "tid": tid, "args": {}}


class _Event:
    def __init__(self, name, device, a, b, cid=0, annotation=False):
        self._v = (name, device, a, b, cid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return self._v[5]


def _profile(window, kernels, extra=()):
    """``kernels``: (name, launch or None, start, end); each launched by
    a ``cudaLaunchKernel`` of its own correlation id."""
    from torch.autograd import DeviceType
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    ev = [_Event("pb.window", cpu, *window, annotation=True)]
    for i, (name, t, a, b) in enumerate(kernels, start=100):
        ev.append(_Event(name, cuda, a, b, cid=i))
        if t is not None:
            ev.append(_Event("cudaLaunchKernel", cpu, t, t + 5, cid=i))
    ev.extend(extra)
    return attribution.device_intervals(ev)


def test_device_intervals_are_paired_with_their_launch_calls():
    """By correlation id, among CUDA calls only: an operator's id of the
    same number is another numbering; a device interval without a call
    has no launch. The busy time is ``bench.summarize``'s."""
    from torch.autograd import DeviceType
    ops = [_Event("aten::mul", DeviceType.CPU, 10, 20, cid=101)]
    kernels = [("k", 1_100, 1_500, 1_600), ("m", 1_200, 1_700, 1_800),
               ("lost", None, 1_900, 1_950)]
    tr = _profile((1_000, 3_000), kernels, ops)
    assert tr["stretch_ns"] == (1_000, 3_000)
    assert tr["launches"] == [(1_100, 1_500, 1_600, "k"),
                              (1_200, 1_700, 1_800, "m"),
                              (None, 1_900, 1_950, "lost")]
    assert tr["busy_intervals"] == [(1_500, 1_600), (1_700, 1_800),
                                    (1_900, 1_950)]
    from torch.autograd import DeviceType
    ev = [_Event("pb.window", DeviceType.CPU, 1_000, 3_000, annotation=True)]
    ev += [_Event(n, DeviceType.CUDA, a, b, cid=i)
           for i, (n, _, a, b) in enumerate(kernels)]
    assert bench.summarize(ev, 1.0)["busy_s"] * 1e9 == pytest.approx(
        sum(b - a for a, b in tr["busy_intervals"]))


def test_kernel_is_credited_to_the_span_that_launched_it():
    """A kernel that runs after its span closed belongs to that span,
    not to the one open while it runs."""
    spans = [_span("engine.decode", 1_100, 1_200),
             _span("engine.migration", 1_300, 1_900)]
    tr = _profile((1_000, 2_000), [("k", 1_150, 1_400, 1_500)])
    j = attribution.join(tr, spans, ANCHOR)
    assert j["launches"] == {"engine.decode": 1}
    assert j["busy_by_span"] == {"engine.decode": 100}
    assert j["busy_ns"] == j["busy_in_spans_ns"] == 100


def test_launches_count_under_every_open_span():
    """N kernels launched inside a span all count to it and to the spans
    around it; overlapping intervals are busy once; kernels launched
    outside every span, or with no launch, are kept by name."""
    spans = [_span("worker.step", 1_000, 1_900, tid=1),
             _span("engine.decode", 1_100, 1_600),
             _span("engine.decode.dispatch", 1_100, 1_400)]
    ks = [("k", 1_110 + 10 * i, 1_450 + 20 * i, 1_500 + 20 * i)
          for i in range(8)]
    ks += [("late", 1_950, 2_000, 2_010), ("lost", None, 2_020, 2_030)]
    tr = _profile((1_000, 2_100), ks)
    j = attribution.join(tr, spans, ANCHOR)
    assert j["n_ops"] == 10
    assert j["launches"] == {"worker.step": 8, "engine.decode": 8,
                             "engine.decode.dispatch": 8}
    assert j["busy_by_span"]["engine.decode"] == 1_640 - 1_450
    assert j["outside"] == {"late": 10} and j["unlaunched"] == {"lost": 10}
    assert j["busy_in_spans_ns"] == 190 and j["busy_ns"] == 210
    assert j["spans"] == {"worker.step": 1, "engine.decode": 1,
                          "engine.decode.dispatch": 1}


def test_idle_goes_to_the_innermost_span_piece_by_piece():
    """Across tracks the innermost span is the shortest that encloses
    the moment; an idle stretch that outlasts a span is split at its
    edges; idle outside every span is kept as such."""
    spans = [_span("worker.step", 1_100, 1_900, tid=1),
             _span("engine.decode", 1_200, 1_700),
             _span("engine.decode.dispatch", 1_200, 1_500),
             _span("engine.decode.wait", 1_500, 1_700)]
    tr = _profile((1_000, 2_000), [("k", 1_250, 1_550, 1_650)])
    j = attribution.join(tr, spans, ANCHOR)
    assert j["idle_by_span"] == {attribution.NO_SPAN: 200,
                                 "worker.step": 300,
                                 "engine.decode.dispatch": 300,
                                 "engine.decode.wait": 100}
    assert sum(j["idle_by_span"].values()) == j["stretch_ns"] - j["busy_ns"]


def test_join_of_decodes_and_migrations():
    """Two decodes, each split into dispatch and wait, and a migration:
    what each launched, its busy time, and the idle while the host was
    enqueueing a decode step; the parts add up to the stretch."""
    spans = [_span("engine.decode", 1_100, 1_500),
             _span("engine.decode.dispatch", 1_100, 1_300),
             _span("engine.decode.wait", 1_300, 1_500),
             _span("engine.decode", 1_600, 1_800),
             _span("engine.decode.dispatch", 1_600, 1_700),
             _span("engine.decode.wait", 1_700, 1_800),
             _span("engine.migration", 1_020, 1_050),
             _span("fleet.slice", 1_001, 1_999, tid=7)]
    ks = [("mig", 1_030, 1_060, 1_100)] + \
        [("k", t, a, a + 40) for t, a in ((1_150, 1_300), (1_200, 1_320),
                                          (1_650, 1_700))]
    j = attribution.join(_profile((1_000, 2_000), ks), spans, ANCHOR)
    assert j["spans"]["engine.decode"] == 2
    assert j["launches"]["engine.decode"] == 3
    assert j["busy_by_span"]["engine.decode"] == 100
    assert j["busy_by_span"]["engine.migration"] == 40
    assert j["busy_by_span"]["engine.decode"] + \
        j["busy_by_span"]["engine.migration"] == j["busy_ns"] == 140
    # idle while dispatch is innermost: 1,100-1,300 and 1,600-1,700
    assert j["idle_by_span"]["engine.decode.dispatch"] == 300
    assert sum(j["idle_by_span"].values()) == j["stretch_ns"] - j["busy_ns"]
    assert j["launches"]["fleet.slice"] == j["n_ops"] == 4


def test_join_without_spans_keeps_every_interval_by_name():
    j = attribution.join(_profile((1_000, 2_000),
                                  [("k", 1_150, 1_300, 1_340)]), [], ANCHOR)
    assert j["launches"] == {} and j["outside"] == {"k": 40}
    assert j["idle_by_span"] == {attribution.NO_SPAN: 960}


@pytest.mark.gpu
def test_on_the_card_spans_meet_ranges_and_own_their_kernels():
    """An obs span opened inside a ``record_function`` range converts to
    within 0.25 ms of the range's start, and the N kernels launched
    inside the span are all credited to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs
    n = 64
    x = torch.ones(1 << 20, device="cuda")
    x.mul_(1.0)
    torch.cuda.synchronize()
    obs.reset()
    obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            anchor = obs.clock_anchor()
            with record_function("pb.window"):
                for i in range(4):
                    with record_function(f"pb.probe{i}"):
                        t0 = obs.now_ns()
                        for _ in range(n):
                            x.mul_(1.0)
                        obs.complete(f"probe{i}", t0)
                torch.cuda.synchronize()
        spans = obs.tracer().events()
    finally:
        obs.reset()
    events = prof.profiler.kineto_results.events()
    ranges = {e.name(): e.start_ns() for e in events
              if e.name().startswith("pb.probe")
              and e.device_type() != DeviceType.CUDA}
    gaps = [obs.to_unix_ns(ev["ts"], anchor) - ranges["pb." + ev["name"]]
            for ev in spans]
    # the first range pays the profiler's first-call costs
    assert max(abs(g) for g in gaps[1:]) <= 250_000, gaps
    j = attribution.join(attribution.device_intervals(events), spans,
                         anchor)
    assert {f"probe{i}": n for i in range(4)} == j["launches"], j
    assert not j["outside"] and not j["unlaunched"], j
