"""KEDA-style per-DU autoscaler (§4.6.1, §5.3).

The paper scales each DU's replica count against a ``targetMetricValue``
derived from the breaking-point load tests: the per-replica RPS at which
latency exceeds 900 ms or utilization crosses 80%.  Desired replicas are

    DU_i^r(t) = ceil( assigned_rps_i(t) / targetMetricValue_i )

with a stabilization window on scale-down (Kubernetes HPA behavior) so the
fleet doesn't thrash at demand troughs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from math import ceil


@dataclass
class AutoscalerConfig:
    target_utilization: float = 0.8   # scale before the breaking point
    min_replicas: int = 0
    max_replicas: int = 10_000
    scale_down_stabilization_s: float = 120.0
    scale_up_step: int = 64           # max replicas added per decision
    scale_to_zero_eps: float = 0.0    # demand at/below this is ZERO demand:
                                      # ceil() would otherwise pin one
                                      # replica forever on the decaying tail
                                      # of an EWMA that never quite reaches
                                      # 0 (0.0 keeps that legacy behavior)


@dataclass
class Autoscaler:
    """One autoscaler per DU pool."""

    target_metric_value: float        # healthy per-replica RPS (0.8 × T_max)
    config: AutoscalerConfig = field(default_factory=AutoscalerConfig)
    _last_high_water: float = 0.0
    _high_water_time: float = -1e18
    current: int = 0

    def desired(self, t: float, assigned_rps: float) -> int:
        """Replica target for the RPS share routed to this DU."""
        if assigned_rps <= self.config.scale_to_zero_eps:
            raw = 0
        else:
            raw = ceil(assigned_rps / max(self.target_metric_value, 1e-9))
        raw = max(self.config.min_replicas, min(self.config.max_replicas, raw))
        if raw >= self.current:
            step = min(raw, self.current + self.config.scale_up_step)
            self.current = step
            self._last_high_water = step
            self._high_water_time = t
        else:
            # hold at the stabilization-window high-water mark before shrinking
            if t - self._high_water_time >= self.config.scale_down_stabilization_s:
                self.current = raw
                self._last_high_water = raw
                self._high_water_time = t
            # else keep self.current
        return self.current

    def track(self, t: float, assigned_rps: float) -> int:
        """Follow the signal directly, WITHOUT the scale-down stabilization
        hold — for callers whose signal is already smooth (a seasonal
        forecaster): the hold exists to damp reactive noise, and applying
        it on top of a forecast just re-adds the lag the forecast removed.
        Scale-up stepping and min/max clamps still apply."""
        if assigned_rps <= self.config.scale_to_zero_eps:
            raw = 0
        else:
            raw = ceil(assigned_rps / max(self.target_metric_value, 1e-9))
        raw = max(self.config.min_replicas, min(self.config.max_replicas, raw))
        self.current = min(raw, self.current + self.config.scale_up_step)
        self._last_high_water = self.current
        self._high_water_time = t
        return self.current


def target_metric_from_profile(t_max: float, target_utilization: float = 0.8) -> float:
    """The paper's targetMetricValue: breaking-point RPS × utilization margin."""
    return t_max * target_utilization
