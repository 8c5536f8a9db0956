"""Request-arrival traces for the serving fleet.

Generalizes the paper's six fixed 50-slice workload cases (Fig. 4,
``repro_torch.core.workloads``) into parameterized stochastic traffic
models plus deterministic replay:

  * ``poisson``      - iid Poisson arrivals (open-loop steady traffic),
  * ``mmpp``         - 2-state Markov-modulated Poisson process (bursty
                       traffic with sojourns in a low- and a high-rate
                       state; the classic serving-burst model),
  * ``diurnal``      - sinusoidal day/night rate with Poisson noise,
  * ``flash_crowd``  - quiet baseline, then a sudden spike decaying
                       geometrically (thundering-herd / retweet storm),
  * ``ramp``         - linear rate ramp from low to high (load test),
  * ``replay``       - verbatim replay of a recorded per-slice count list,
  * the six paper cases, re-exported under their original names.

Every generator is seeded and returns a :class:`Trace`; equal seeds give
equal traces, so fleet experiments are reproducible end to end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.core import workloads

DEFAULT_SLICES = 50


@dataclasses.dataclass(frozen=True)
class Trace:
    name: str
    arrivals: List[int]           # requests arriving per time slice

    def __len__(self) -> int:
        return len(self.arrivals)

    @property
    def total(self) -> int:
        return int(sum(self.arrivals))

    @property
    def peak(self) -> int:
        return max(self.arrivals) if self.arrivals else 0

    def truncated(self, max_requests: int) -> "Trace":
        """Clip the trace once ``max_requests`` total arrivals are reached
        (CLI ``--requests`` budget)."""
        out: List[int] = []
        left = max_requests
        for a in self.arrivals:
            take = min(a, left)
            out.append(take)
            left -= take
            if left <= 0:
                break
        return Trace(self.name, out)


def _clip(xs: np.ndarray) -> List[int]:
    return [int(max(x, 0)) for x in xs]


def poisson_trace(n_slices: int = DEFAULT_SLICES, *, rate: float = 4.0,
                  seed: int = 0) -> Trace:
    rng = np.random.default_rng(seed)
    return Trace(f"poisson(rate={rate})",
                 _clip(rng.poisson(rate, size=n_slices)))


def mmpp_trace(n_slices: int = DEFAULT_SLICES, *, rate_low: float = 2.0,
               rate_high: float = 12.0, p_up: float = 0.15,
               p_down: float = 0.3, seed: int = 0) -> Trace:
    """2-state MMPP: in the low state switch up w.p. ``p_up`` per slice, in
    the high state switch down w.p. ``p_down``; arrivals are Poisson at the
    current state's rate. Mean high-state sojourn = 1/p_down slices, so
    bursts persist across slices - the regime where forecasting pays."""
    rng = np.random.default_rng(seed)
    arrivals = []
    high = False
    for _ in range(n_slices):
        if high:
            high = rng.random() >= p_down
        else:
            high = rng.random() < p_up
        arrivals.append(rng.poisson(rate_high if high else rate_low))
    return Trace(f"mmpp({rate_low}/{rate_high})", _clip(np.array(arrivals)))


def diurnal_trace(n_slices: int = DEFAULT_SLICES, *, base: float = 2.0,
                  peak: float = 10.0, period: int = 24,
                  seed: int = 0) -> Trace:
    rng = np.random.default_rng(seed)
    t = np.arange(n_slices)
    rate = base + (peak - base) * 0.5 * (1 - np.cos(2 * np.pi * t / period))
    return Trace(f"diurnal(period={period})", _clip(rng.poisson(rate)))


def flash_crowd_trace(n_slices: int = DEFAULT_SLICES, *, base: float = 2.0,
                      spike_slice: int = None, spike: float = 18.0,
                      decay: float = 0.6, seed: int = 0) -> Trace:
    """Quiet Poisson baseline; at ``spike_slice`` the rate jumps to
    ``spike`` and decays geometrically back to base."""
    rng = np.random.default_rng(seed)
    if spike_slice is None:
        spike_slice = n_slices // 3
    rate = np.full(n_slices, float(base))
    for i in range(spike_slice, n_slices):
        extra = (spike - base) * decay ** (i - spike_slice)
        if extra < 0.25:
            break
        rate[i] += extra
    return Trace(f"flash(spike={spike})", _clip(rng.poisson(rate)))


def ramp_trace(n_slices: int = DEFAULT_SLICES, *, start: float = 1.0,
               end: float = 12.0, seed: int = 0) -> Trace:
    rng = np.random.default_rng(seed)
    rate = np.linspace(start, end, n_slices)
    return Trace(f"ramp({start}->{end})", _clip(rng.poisson(rate)))


def replay_trace(arrivals: Sequence[int], name: str = "replay") -> Trace:
    return Trace(name, [int(a) for a in arrivals])


def workload_trace(case: str) -> Trace:
    """Adapter: one of the paper's six fixed cases as a Trace."""
    return Trace(case, list(workloads.SCENARIOS[case]))


TRACES: Dict[str, Callable[..., Trace]] = {
    "poisson": poisson_trace,
    "mmpp": mmpp_trace,
    "diurnal": diurnal_trace,
    "flash": flash_crowd_trace,
    "ramp": ramp_trace,
}
# traffic classes where load changes faster than a reactive scheduler can
# migrate - the benchmark's forecasting-vs-reactive comparison set
BURSTY = ("mmpp", "flash", "ramp")


def make_trace(name: str, n_slices: int = DEFAULT_SLICES, seed: int = 0,
               **kw) -> Trace:
    """Trace factory: stochastic generators by short name, or any of the
    paper's ``case*`` scenario names (deterministic, fixed length)."""
    if name in TRACES:
        return TRACES[name](n_slices, seed=seed, **kw)
    if name in workloads.SCENARIOS:
        return workload_trace(name)
    raise ValueError(
        f"unknown trace {name!r}; choose from {sorted(TRACES)} or "
        f"{sorted(workloads.SCENARIOS)}")
