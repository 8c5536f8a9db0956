"""The metric arithmetic: nearest-rank percentiles over every unit,
rates over the whole window, op and byte counts at small shapes."""

import pytest

from portbench.tests import smoke
from portbench import bench, counts


def _run(name="internlm2_1_8b.fleet_mmpp"):
    r = bench.Run(smoke.cell(name), 1, 1.0, False, device="cpu")
    return r


def test_nearest_rank():
    xs = list(range(1, 101))
    assert counts.nearest_rank(xs, 95) == 95
    assert counts.nearest_rank(xs[:20], 95) == 19
    assert counts.nearest_rank([3.0], 95) == 3.0
    assert counts.nearest_rank([5, 1, 4, 2, 3], 50) == 3


def test_slice_p95_is_over_all_slices():
    r = _run()
    r.trace = True
    r.units = [0.1] * 95 + [1.0] * 5
    assert bench.reader("fleet.slice_p95_ms")(r) == pytest.approx(100.0)
    r.units = [0.1] * 94 + [1.0] * 6
    assert bench.reader("fleet.slice_p95_ms")(r) == pytest.approx(1000.0)


def test_rates_over_the_window():
    r = _run()
    r.window_s, r.counts["completed"] = 30.5, 610
    assert bench.reader("fleet.req_per_s")(r) is None
    r.trace = True
    assert bench.reader("fleet.req_per_s")(r) == pytest.approx(20.0)
    r.counts["window_busy_s"] = 6.1
    assert bench.reader("device_ms_per_req")(r) == pytest.approx(10.0)
    r.setup_s = 12.5
    assert bench.reader("setup_s")(r) == 12.5


def test_readers_without_a_trace_return_nothing():
    r = _run()
    for m in r.cell.per_layer:
        assert bench.reader(m["name"])(r) is None


def test_device_share_readers():
    r = _run()
    r.device_trace = {"busy_s": 0.25, "window_s": 1.0}
    assert bench.reader("fleet.device_idle")(r) == pytest.approx(75.0)
    r.counts.update(traced_rows=10, matmul_params=1000)
    assert bench.reader("fleet.decode_mfu")(r) == pytest.approx(
        100 * 2 * 1000 * 10 / counts.BF16_FLOPS)


class _Event:
    def __init__(self, name, device, a, b, annotation=False):
        self._v = (name, device, a, b, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_busy_time_is_the_union_of_device_intervals():
    """Overlapping device intervals count once; host events and host
    ranges are no device time; a gap is named by the host range around
    its start."""
    from torch.autograd import DeviceType
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    ev = [_Event("pb.window", cpu, 0, 100, True),
          _Event("pb.decode", cpu, 40, 90, True),
          _Event("k1", cuda, 10, 30), _Event("k2", cuda, 20, 40),
          _Event("k1", cuda, 60, 70), _Event("cudaLaunchKernel", cpu, 5, 6)]
    tr = bench.summarize(ev, 1.0)
    assert tr["busy_s"] == pytest.approx(40e-9)
    assert tr["window_s"] == pytest.approx(100e-9)
    assert tr["device_events"] == 3
    assert tr["by_name"] == pytest.approx({"k1": 30e-9, "k2": 20e-9})
    assert sorted(tr["idle_gaps"]) == pytest.approx(
        sorted([("pb.window", 10e-9), ("pb.decode", 20e-9),
                ("pb.decode", 30e-9)]))


def test_window_freezes_set_up_until_it_closes():
    """What set-up made is frozen out of the collector while the window
    runs, and given back once it closes."""
    import gc

    from portbench.drivers import Window
    r = _run()
    r.device, r.seconds = "cpu", 0.0
    win = Window(r)
    gc.unfreeze()
    win.open()
    try:
        assert gc.get_freeze_count() > 0 and r.setup_s is not None
        assert win.unit_done()
        assert gc.get_freeze_count() == 0 and r.window_s >= 0
    finally:
        gc.unfreeze()
