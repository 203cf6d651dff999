"""Discrete-event cluster simulator: the paper's EKS testbed in-silico.

Each tick (default 1 s):
  1. demand trace sampled;
  2. capacity pools mature pending replicas / apply shortfall events;
  3. the controller evaluates Eqs. (2)-(3) and picks the weight regime
     (binary step, §3.3);
  4. the router splits traffic, spills overflow, computes queue latencies;
  5. per-DU autoscalers (KEDA-style) request replicas from their pools;
  6. metrics are recorded ($, RPS 200/500, latency, utilization, mode).

This reproduces the dynamics of the paper's Figs. 5-7 with the Table 1/2
DU profiles.  The port's copy of the JAX package's ``core/simulator.py``:
the controller's policy calls run on ``device`` (the card by default).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig, target_metric_from_profile
from repro_torch.core.capacity import CapacityPool
from repro_torch.core.controller import ControllerConfig, ModeController
from repro_torch.core.deployment import DUProfile
from repro_torch.core.metrics import MetricsLog, TickRecord
from repro_torch.core.router import route


@dataclass
class SimConfig:
    tick_s: float = 1.0
    duration_s: float = 3600.0
    hedge_fraction: float = 0.0
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    autoscaler: AutoscalerConfig = field(default_factory=AutoscalerConfig)
    seed: int = 0


class ClusterSimulator:
    def __init__(
        self,
        profiles: Sequence[DUProfile],
        pools: Sequence[CapacityPool],
        demand_fn: Callable[[float], float],
        config: Optional[SimConfig] = None,
        *,
        device=None,
    ):
        assert len(profiles) == len(pools)
        self.profiles = tuple(profiles)
        self.pools = list(pools)
        self.demand_fn = demand_fn
        self.config = config or SimConfig()
        self.controller = ModeController(profiles, self.config.controller, device=device)
        self.autoscalers = [
            Autoscaler(
                target_metric_from_profile(
                    p.t_max, self.config.autoscaler.target_utilization
                ),
                self.config.autoscaler,
            )
            for p in profiles
        ]
        self.t_max = np.array([p.t_max for p in profiles])
        self.latency = np.array([p.latency_s for p in profiles])
        self.cost_per_hour = np.array([p.cost_per_hour for p in profiles])

    def run(self) -> MetricsLog:
        cfg = self.config
        log = MetricsLog(du_names=[p.name for p in self.profiles])
        n = len(self.profiles)
        requested = np.zeros(n, dtype=np.int64)

        t = 0.0
        while t < cfg.duration_s:
            demand = float(self.demand_fn(t))

            # 2. capacity dynamics
            pool_cap = np.array([p.capacity_at(t) for p in self.pools])
            ready = np.array([p.tick(t) for p in self.pools])

            # 3. mode switch + weights (faithful binary step by default)
            decision = self.controller.step(t, demand, requested, pool_cap)

            # 4. routing over *ready* replicas
            rr = route(
                demand,
                decision.weights,
                ready,
                self.t_max,
                self.latency,
                hedge_fraction=cfg.hedge_fraction,
            )

            # 5. autoscaling toward each pool's LB-assigned share (KEDA metric)
            new_requested = np.zeros(n, dtype=np.int64)
            for i, (a, p) in enumerate(zip(self.autoscalers, self.pools)):
                want = a.desired(t, float(rr.assigned[i]))
                p.request(t, want)
                new_requested[i] = want
            requested = new_requested

            # 6. metrics
            cost_rate = float(np.sum(ready * self.cost_per_hour) / 3600.0)
            log.append(
                TickRecord(
                    t=t,
                    demand_rps=demand,
                    mode=int(decision.mode),
                    weights=decision.weights.copy(),
                    ready=ready.copy(),
                    served_rps=rr.served.copy(),
                    dropped_rps=rr.dropped,
                    latency_s=rr.latency.copy(),
                    utilization=rr.utilization.copy(),
                    cost_rate=cost_rate,
                )
            )
            t += cfg.tick_s
        return log


# ---------------------------------------------------------------------------
# Demand traces (§5.1 "stable, steady loads to highly variable, bursty")
# ---------------------------------------------------------------------------


def steady(rps: float) -> Callable[[float], float]:
    return lambda t: rps


def ramp(start_rps: float, end_rps: float, duration_s: float) -> Callable[[float], float]:
    def f(t: float) -> float:
        a = min(max(t / duration_s, 0.0), 1.0)
        return start_rps + a * (end_rps - start_rps)

    return f


def diurnal_cycle(
    base_rps: float, peak_rps: float, period_s: float = 86_400.0
) -> Callable[[float], float]:
    """The paper's cyclic workload assumption (load resets each cycle)."""

    def f(t: float) -> float:
        phase = (t % period_s) / period_s
        return base_rps + (peak_rps - base_rps) * max(0.0, np.sin(np.pi * phase)) ** 2

    return f


def bursty(
    base_rps: float,
    burst_rps: float,
    burst_every_s: float,
    burst_len_s: float,
    seed: int = 0,
) -> Callable[[float], float]:
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0.9, 1.1, size=4096)

    def f(t: float) -> float:
        k = int(t // burst_every_s)
        in_burst = (t % burst_every_s) < burst_len_s
        j = jitter[k % len(jitter)]
        return (base_rps + (burst_rps if in_burst else 0.0)) * j

    return f
