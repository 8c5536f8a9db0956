"""BENCHMARK.json against the rules of its format (keys, names, units,
bounds, the time of a full check), and every file that a cell is found
by."""
import json
import math
import re
import statistics

from portbench.tests import smoke  # noqa: F401  (puts src on the path)
from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _man():
    return bench.manifest()


def test_keys_and_sizes():
    man = _man()
    assert set(man) == KEYS
    assert (bench.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert man["command"][1].startswith("portbench/")
    assert all(not w.startswith("/") and ".." not in w for w in man["command"])


def test_names_units_and_keys():
    man = _man()
    names = []
    for group, extra in (("configs", {"name", "source", "file", "reduced",
                                      "why"}),
                         ("workloads", {"name", "config", "traffic", "chips",
                                        "why"})):
        for e in man[group]:
            assert set(e) == extra, e
            assert NAME.match(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
            names.append(e["name"])
    for group in ("end_to_end", "per_layer"):
        for m in man[group]:
            allowed = ({"name", "unit", "better", "bound", "source"}
                       if group == "end_to_end" else
                       {"name", "unit", "better", "source", "layer",
                        "moves"}) | {"workloads"}
            assert set(m) <= allowed and NAME.match(m["name"]), m
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            names.append(m["name"])
    assert len(set(names)) == len(names)


def test_bounds():
    e2e = {m["name"]: m for m in _man()["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_report_what_they_need():
    man = _man()
    configs = {c["name"] for c in man["configs"]}
    used = {w["config"] for w in man["workloads"]}
    assert used == configs
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == \
        len(man["workloads"])
    for w in man["workloads"]:
        assert w["chips"] == 1
        cell = bench.Cell(man, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_per_layer_metrics_move_one_end_to_end_metric():
    man = _man()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    layers = {}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_files_of_every_cell_and_metric():
    man = _man()
    for c in man["configs"]:
        path = bench.ROOT / c["file"]
        assert path.parent == bench.PKG / "configs"
        body = json.loads(path.read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
    for w in man["workloads"]:
        assert (bench.PKG / "traffic" / f"{w['traffic']}.json").exists()
        assert (bench.PKG / "limits" / f"{w['name']}.json").exists()
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_every_metric_reader_is_named():
    """No reader under ``metrics/`` outlives its metric."""
    man = _man()
    named = {m["name"] for m in man["end_to_end"] + man["per_layer"]}
    files = {p.name[:-3] for p in (bench.PKG / "metrics").glob("*.py")}
    assert files == named


def test_limits_are_numbers():
    for w in _man()["workloads"]:
        lim = bench.Cell(_man(), w["name"]).limits
        assert lim and all(math.isfinite(v) and v >= 0 for v in lim.values())
        statistics.fmean(lim.values())


def test_command_fails_without_a_card():
    """The measuring command exits 2 and prints no result on a machine
    without the cards the cell asks for (this CPU)."""
    import subprocess
    import sys

    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    man = _man()
    out = subprocess.run(
        [sys.executable, *man["command"][1:], "--workload",
         man["workloads"][0]["name"], "--seed", str(2 ** 31 + 1),
         "--seconds", "1", "--trace", "0"],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == "", out.stderr
