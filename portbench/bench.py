"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json`` (the sizes as run),
``traffic/<traffic>.json`` (the mix's parameters and the driver that
runs it: ``drivers/<driver>.py``), ``limits/<cell>.json`` (the limit of
each number that decides ``correct``) and ``metrics/<metric>.py`` (a
reader of one metric). A driver runs the system under test and fills a
:class:`Run`; the readers take the metrics from it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# whole top-level module names that may not be loaded by a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


class Cell:
    """One entry of ``workloads`` with its files and its metrics."""

    def __init__(self, man: dict, name: str):
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json; "
                             f"one of {sorted(cells)}")
        w = cells[name]
        self.name = name
        self.chips = int(w["chips"])
        self.config = load_json(PKG / "configs" / f"{w['config']}.json")
        self.traffic = load_json(PKG / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(PKG / "limits" / f"{name}.json")
        self.end_to_end = [m for m in man["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in man["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


def reader(metric: str) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def process_start_s() -> float:
    """The process's start on the ``time.time`` clock (``/proc``)."""
    import os
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


class Run:
    """What one run measured: filled by a driver, read by the readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", control: bool = False):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.control = control
        self.t_start = time.time()
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.units: List[float] = []          # seconds of each unit
        self.spans: Dict[str, List[float]] = {}   # seconds, by name
        self.counts: Dict[str, float] = {}
        self.checks: List[Tuple[str, float, float]] = []
        self.readings: Dict[str, float] = {}  # control readings
        self.notes: Dict[str, object] = {}    # printed on standard error
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.device_trace: Optional[dict] = None

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


# -- the device trace ---------------------------------------------------------

class Profiled:
    """torch.profiler over a stretch that the driver starts and stops;
    host spans are ``torch.profiler.record_function`` ranges named
    ``pb.*``. With ``host=False`` only the card's activity is recorded
    (no host ranges, so the idle gaps go unnamed)."""

    def __init__(self, host: bool = True):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA]
        if host:
            acts.insert(0, ProfilerActivity.CPU)
        self._prof = profile(activities=acts)
        self._host = host
        self._t0 = self._rf = None

    def start(self) -> None:
        import torch
        from torch.profiler import record_function
        torch.cuda.synchronize()
        self._prof.start()
        if self._host:
            self._rf = record_function("pb.window")
            self._rf.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        import torch
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._prof.stop()
        return summarize(self._prof.profiler.kineto_results.events(), wall_s)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events, wall_s: float) -> dict:
    """Device time by kernel name, the union of device intervals (busy),
    and the idle gaps, each named by the innermost ``pb.*`` host range
    around its start."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        if e.name().startswith("pb.") or e.is_user_annotation():
            # host ranges; the profiler mirrors them on the device's track
            if e.device_type() != DeviceType.CUDA and \
                    e.name().startswith("pb."):
                host.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.end_ns()))
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
    busy = _union([(a, b) for _, a, b in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    window = [h for h in host if h[0] == "pb.window"]
    lo = window[0][1] if window else (busy[0][0] if busy else 0)
    hi = window[0][2] if window else (busy[-1][1] if busy else 0)
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            inner = [h for h in host if h[1] <= prev < h[2]
                     and h[0] != "pb.window"]
            name = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                    else "pb.window")
            gaps.append((name, (min(a, hi) - prev) / 1e9))
        prev = max(prev, b)
    window_s = (hi - lo) / 1e9 if window else wall_s
    return {"busy_s": busy_s, "window_s": window_s, "by_name": by_name,
            "device_events": len(dev),
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}


# -- result -------------------------------------------------------------------

def loaded_forbidden(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (by default every
    module this process has loaded), compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def result(run: Run) -> dict:
    import torch
    metrics = {}
    chosen = run.cell.per_layer if run.trace else run.cell.end_to_end
    for m in chosen:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": run.cell.chips, "memory_peak_bytes": run.memory_peak}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace and run.device_trace is not None:
        tr = run.device_trace
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                            "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    if run.readings:
        out["control"] = run.readings
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return out
