"""Workload scenarios of Fig. 4: tasks (inferences) arriving per time slice.

Six patterns over 50 slices, peak load 10 inferences/slice (the paper sets
the time slice to fit up to 10 inferences at maximum performance).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

N_SLICES = 50
PEAK_TASKS = 10
LOW_TASKS = 2


def case1_low_constant(n: int = N_SLICES) -> List[int]:
    return [LOW_TASKS] * n


def case2_high_constant(n: int = N_SLICES) -> List[int]:
    return [PEAK_TASKS] * n


def case3_periodic_spike(n: int = N_SLICES, period: int = 10,
                         width: int = 2) -> List[int]:
    return [PEAK_TASKS if (i % period) < width else LOW_TASKS
            for i in range(n)]


def case4_periodic_spike_frequent(n: int = N_SLICES, period: int = 4,
                                  width: int = 1) -> List[int]:
    return [PEAK_TASKS if (i % period) < width else LOW_TASKS
            for i in range(n)]


def case5_pulsing(n: int = N_SLICES, half_period: int = 5) -> List[int]:
    return [PEAK_TASKS if (i // half_period) % 2 == 0 else LOW_TASKS
            for i in range(n)]


def case6_random(n: int = N_SLICES, seed: int = 0) -> List[int]:
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, PEAK_TASKS + 1, size=n)]


SCENARIOS: Dict[str, List[int]] = {
    "case1_low_constant": case1_low_constant(),
    "case2_high_constant": case2_high_constant(),
    "case3_periodic_spike": case3_periodic_spike(),
    "case4_periodic_spike_frequent": case4_periodic_spike_frequent(),
    "case5_pulsing": case5_pulsing(),
    "case6_random": case6_random(),
}
