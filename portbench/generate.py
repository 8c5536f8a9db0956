"""The one traffic generator: every mix is a JSON file of parameters
under ``portbench/traffic``, read here.

- ``mmpp_period``: per-slice arrival counts of a 2-state Markov-modulated
  Poisson process (the model of ``repro_torch.fleet.traces.mmpp_trace``,
  copied here). One period of ``period_slices`` is drawn once from
  ``base_seed`` and repeated, in its own order, for every seed: in a
  closed loop the window ends by time, so any order that a seed chose
  would change the arrivals and migrations inside it. A run's seed draws
  the weights and with them every token served.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _mmpp_period(p: dict) -> List[int]:
    """One period's per-slice counts."""
    rng = np.random.default_rng(p["base_seed"])
    out: List[int] = []
    high = False
    for _ in range(p["period_slices"]):
        if high:
            high = rng.random() >= p["p_down"]
        else:
            high = rng.random() < p["p_up"]
        out.append(int(max(rng.poisson(p["rate_high"] if high
                                       else p["rate_low"]), 0)))
    return out


def arrivals(p: dict, n_slices: int) -> List[int]:
    """``n_slices`` per-slice arrival counts of an ``mmpp_period`` mix."""
    if p["kind"] != "mmpp_period":
        raise ValueError(f"unknown arrival kind {p['kind']!r}")
    period = _mmpp_period(p)
    return [period[i % len(period)] for i in range(n_slices)]
