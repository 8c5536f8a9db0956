"""Cells at smoke sizes on the CPU, for the tests: the configuration's
sizes cut to a few thousand parameters, everything else as the cell's
files give it."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import bench  # noqa: E402

SMOKE = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 512, "n_layers": 2,
         "compute_dtype": "float32"}


def cell(name: str, **traffic) -> bench.Cell:
    """The cell ``name`` of BENCHMARK.json at smoke size; ``traffic``
    overrides entries of its mix."""
    c = bench.Cell(bench.manifest(), name)
    c.config = dict(copy.deepcopy(c.config), **SMOKE)
    c.traffic = dict(copy.deepcopy(c.traffic), **traffic)
    return c


def run(name: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
        control: bool = False, **traffic) -> bench.Run:
    r = bench.Run(cell(name, **traffic), seed, seconds, trace, device="cpu",
                  control=control)
    bench.driver(r.traffic["driver"]).run(r)
    return r
