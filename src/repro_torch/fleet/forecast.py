"""Short-horizon demand forecasting for the elastic autoscaler.

The reactive controller scales on an EWMA of *observed* arrivals — by
construction it lags every diurnal ramp (queueing + cold starts on the way
up) and over-holds after every peak (the scale-down stabilization window on
the way down).  On a workload with daily structure that lag is pure money:
SageServe (PAPERS.md) shows forecast-aware scaling beats reactive EWMA on
exactly these traces.

``SeasonalForecaster`` is the smallest predictor that captures the
structure: a per-phase-bucket EWMA of observed demand over one cycle
(the seasonal profile) times a slowly-adapting level ratio (the trend —
today running hotter or colder than the profile).  It is deliberately
conservative: ``predict`` returns ``None`` until a full cycle has been
observed, so a forecast-enabled fleet behaves byte-identically to the
reactive one for its entire first day.
"""
from __future__ import annotations

from typing import List, Optional


class SeasonalForecaster:
    """Per-phase-bucket seasonal EWMA + level ratio over one cycle.

    ``observe(t, demand)`` each control tick; ``predict(t_future)`` reads
    the profile at the future phase.  Deterministic: state is a pure
    function of the observation sequence.
    """

    def __init__(self, period_s: float, buckets: int = 48,
                 alpha: float = 0.4, level_alpha: float = 0.05):
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        if buckets < 2:
            raise ValueError(f"buckets must be >= 2, got {buckets}")
        self.period_s = float(period_s)
        self.buckets = int(buckets)
        self.alpha = float(alpha)
        self.level_alpha = float(level_alpha)
        self._seasonal: List[Optional[float]] = [None] * self.buckets
        self._level = 1.0
        self._t0: Optional[float] = None
        self._span = 0.0

    def _bucket(self, t: float) -> int:
        return int((t % self.period_s) / self.period_s * self.buckets) \
            % self.buckets

    @property
    def ready(self) -> bool:
        """True once a full cycle has been observed (predictions before
        that would be extrapolating from nothing)."""
        return self._span >= self.period_s

    def observe(self, t: float, demand: float) -> None:
        """Fold one observed demand sample into the seasonal profile."""
        demand = max(0.0, float(demand))
        if self._t0 is None:
            self._t0 = t
        self._span = max(self._span, t - self._t0)
        b = self._bucket(t)
        prev = self._seasonal[b]
        if prev is None:
            self._seasonal[b] = demand
            return
        if self.ready and prev > 0.1:
            # trend: is today running hot or cold vs the profile?  Clamped
            # so one burst can't double every prediction.
            ratio = min(2.0, max(0.5, demand / prev))
            self._level = ((1.0 - self.level_alpha) * self._level
                           + self.level_alpha * ratio)
        self._seasonal[b] = self.alpha * demand + (1.0 - self.alpha) * prev

    def predict(self, t: float) -> Optional[float]:
        """Forecast demand at (future) time ``t``; None until ``ready``."""
        if not self.ready:
            return None
        v = self._seasonal[self._bucket(t)]
        if v is None:
            return None
        return max(0.0, v * self._level)

    def predict_max(self, t0: float, t1: float,
                    samples: int = 4) -> Optional[float]:
        """Max forecast over the horizon [t0, t1] (``samples`` evenly
        spaced reads).  This is the right signal for a PROVISIONING
        decision with lag: capacity bought now must cover the worst of the
        whole window it takes effect over — a point read at t1 alone would
        scale down into every local dip and pay a cold start climbing back
        out.  None until ``ready``."""
        if t1 <= t0:
            return self.predict(t0)
        best: Optional[float] = None
        for k in range(max(2, samples)):
            p = self.predict(t0 + (t1 - t0) * k / (max(2, samples) - 1))
            if p is None:
                return None
            best = p if best is None else max(best, p)
        return best

    def peek(self, t: float) -> float:
        """``predict`` with a 0.0 fallback (for logging only — callers that
        ACT on the forecast must handle the not-ready None)."""
        p = self.predict(t)
        return 0.0 if p is None else p
