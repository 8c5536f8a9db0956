"""Per-slice load forecasters.

The paper's scheduler is *reactive*: slice ``s`` executes the backlog that
arrived during ``s-1``, and the LUT is consulted on that realized count. A
forecaster predicts the NEXT slice's arrivals from the arrival history, and
the fleet worker looks the LUT up on ``max(backlog, prediction)`` - so a
predicted burst triggers the weight migration one slice early, while the
engine is still quiet enough to absorb the movement overhead
(``TimeSliceScheduler.step(lookup_tasks=...)``).

All forecasters are O(1) memory/time per observation (online updates).
"""
from __future__ import annotations

import collections
from typing import Callable, Deque, Dict, Optional


class Forecaster:
    """Online one-step-ahead predictor of per-slice arrival counts."""

    name = "base"

    def observe(self, n_arrivals: int) -> None:
        raise NotImplementedError

    def predict(self) -> float:
        """Predicted arrivals in the next slice (>= 0)."""
        raise NotImplementedError


class NoForecast(Forecaster):
    """Reactive baseline: predicts nothing; the LUT sees the raw backlog."""

    name = "none"

    def observe(self, n_arrivals: int) -> None:
        pass

    def predict(self) -> float:
        return 0.0


class LastValue(Forecaster):
    """Naive persistence: next slice repeats the last observation."""

    name = "last"

    def __init__(self) -> None:
        self._last = 0.0

    def observe(self, n_arrivals: int) -> None:
        self._last = float(n_arrivals)

    def predict(self) -> float:
        return self._last


class EWMA(Forecaster):
    """Exponentially weighted moving average of arrivals.

    Smooths transient dips, so an engine serving a sustained burst does not
    migrate down during a one-slice lull only to migrate back up (migration
    thrash is the dominant reactive failure mode on MMPP traffic)."""

    name = "ewma"

    def __init__(self, alpha: float = 0.5) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self._level: Optional[float] = None

    def observe(self, n_arrivals: int) -> None:
        x = float(n_arrivals)
        self._level = x if self._level is None else \
            self.alpha * x + (1 - self.alpha) * self._level

    def predict(self) -> float:
        return self._level or 0.0


class AR1(Forecaster):
    """Online AR(1): ``x_{t+1} ~ mu + phi (x_t - mu)``.

    ``mu`` and ``phi`` are estimated from running first/second moments of
    consecutive pairs; ``phi`` is clipped to [0, 1] (arrival counts are
    non-negatively autocorrelated in every traffic model we generate)."""

    name = "ar1"

    def __init__(self, min_obs: int = 3) -> None:
        self.min_obs = min_obs
        self._prev: Optional[float] = None
        self._n = 0
        self._sx = self._sxx = self._sxy = 0.0
        self._last = 0.0

    def observe(self, n_arrivals: int) -> None:
        x = float(n_arrivals)
        if self._prev is not None:
            self._n += 1
            self._sx += self._prev
            self._sxx += self._prev * self._prev
            self._sxy += self._prev * x
        self._prev = x
        self._last = x

    def predict(self) -> float:
        if self._n < self.min_obs:
            return self._last
        mu = (self._sx + self._last) / (self._n + 1)
        var = self._sxx / self._n - (self._sx / self._n) ** 2
        if var <= 1e-9:
            return self._last
        cov = self._sxy / self._n - (self._sx / self._n) * mu
        phi = min(max(cov / var, 0.0), 1.0)
        return max(mu + phi * (self._last - mu), 0.0)


class Holt(Forecaster):
    """Double-exponential (level + trend) smoothing: extrapolates ramps, so
    rising load is pre-provisioned a slice early."""

    name = "holt"

    def __init__(self, alpha: float = 0.5, beta: float = 0.3) -> None:
        self.alpha, self.beta = alpha, beta
        self._level: Optional[float] = None
        self._trend = 0.0

    def observe(self, n_arrivals: int) -> None:
        x = float(n_arrivals)
        if self._level is None:
            self._level = x
            return
        prev = self._level
        self._level = self.alpha * x + (1 - self.alpha) * (prev + self._trend)
        self._trend = (self.beta * (self._level - prev)
                       + (1 - self.beta) * self._trend)

    def predict(self) -> float:
        if self._level is None:
            return 0.0
        return max(self._level + self._trend, 0.0)


class SeasonalNaive(Forecaster):
    """Period-aware persistence: predicts the observation from one period
    ago (nails the paper's periodic-spike cases, where every history-free
    smoother lags the spike by construction)."""

    name = "seasonal"

    def __init__(self, period: int = 10) -> None:
        if period < 1:
            raise ValueError("period must be >= 1")
        self.period = period
        self._hist: Deque[float] = collections.deque(maxlen=period)

    def observe(self, n_arrivals: int) -> None:
        self._hist.append(float(n_arrivals))

    def predict(self) -> float:
        if len(self._hist) < self.period:
            return self._hist[-1] if self._hist else 0.0
        return self._hist[0]


FORECASTERS: Dict[str, Callable[..., Forecaster]] = {
    "none": NoForecast,
    "last": LastValue,
    "ewma": EWMA,
    "ar1": AR1,
    "holt": Holt,
    "seasonal": SeasonalNaive,
}


def make_forecaster(name: str, **kw) -> Forecaster:
    if name not in FORECASTERS:
        raise ValueError(f"unknown forecaster {name!r}; "
                         f"choose from {sorted(FORECASTERS)}")
    return FORECASTERS[name](**kw)
