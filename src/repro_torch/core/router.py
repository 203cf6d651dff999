"""Weighted request routing (the ALB-weighted-target-group stand-in).

Splits offered demand across DU pools by the controller's weights, spills
excess from saturated pools onto pools with headroom (the paper's
"reduce the weight of DU_i units lacking capacity and normalize"), and
models per-pool latency with an M/D/c-style queueing approximation.

Straggler mitigation (beyond paper): optional request hedging — a fraction
of requests is duplicated to the next-fastest pool with headroom; the
effective latency of hedged requests is the min of the two pools.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RouteResult:
    assigned: np.ndarray      # weights·demand — what the LB sends (KEDA metric)
    served: np.ndarray        # successful RPS per DU (HTTP 200)
    dropped: float            # RPS with no capacity anywhere (HTTP 500)
    latency: np.ndarray       # mean end-to-end latency per DU (s)
    utilization: np.ndarray   # ρ_i per DU


def queue_latency(
    base_latency: float, rho: float, servers: int = 1, *, max_factor: float = 8.0
) -> float:
    """M/D/c-flavored latency inflation (Sakasegawa approximation):

        W ≈ L0 · ρ^{√(2(c+1))} / (c · (1 − ρ)) / 2     (D service ⇒ ÷2)

    Reproduces the paper's Fig. 4 breaking-point shape: flat latency at low
    load, sharp knee as utilization → 1 (the >900 ms threshold region),
    while staying near L0 at the paper's healthy 70-90% utilizations when a
    pool has several replicas.
    """
    if servers <= 0 or rho >= 1.0:
        return base_latency * max_factor
    wait = rho ** np.sqrt(2.0 * (servers + 1)) / (servers * (1.0 - rho)) / 2.0
    return base_latency * min(1.0 + wait, max_factor)


def route(
    demand: float,
    weights: np.ndarray,
    ready: np.ndarray,
    t_max: np.ndarray,
    base_latency: np.ndarray,
    *,
    hedge_fraction: float = 0.0,
) -> RouteResult:
    """Split `demand` RPS over pools; spill overflow; compute queue latency.

    ``assigned`` is the pre-capacity LB split (what KEDA scales against —
    the load balancer keeps sending per weights even when a pool is cold);
    ``served`` is capped by ready-replica capacity, with retried overflow
    absorbed by pools that still have headroom.
    """
    weights = np.asarray(weights, dtype=np.float64)
    mu = ready.astype(np.float64) * t_max          # pool service capacity (RPS)

    assigned = weights * demand
    served = np.minimum(assigned, mu)
    excess = float(np.sum(assigned - served))
    # --- retry/spillover: excess goes to pools with headroom ----------------
    for _ in range(2):
        if excess <= 1e-9:
            break
        headroom = np.maximum(mu - served, 0.0)
        total_head = float(np.sum(headroom))
        if total_head <= 1e-9:
            break
        absorb = min(excess, total_head)
        served = served + headroom / total_head * absorb
        excess -= absorb
    dropped = max(excess, 0.0)

    rho = np.divide(served, np.maximum(mu, 1e-9))
    rho = np.where(mu > 0, rho, 0.0)
    latency = np.array(
        [
            queue_latency(bl, r, int(c))
            for bl, r, c in zip(base_latency, rho, ready)
        ]
    )

    # --- hedging (beyond paper): duplicate tail requests to 2nd pool --------
    if hedge_fraction > 0.0 and np.sum(ready > 0) >= 2:
        # hedged requests see min(latency of own pool, fastest other pool)
        active = ready > 0
        fastest = np.min(np.where(active, latency, np.inf))
        latency = np.where(
            active,
            (1 - hedge_fraction) * latency
            + hedge_fraction * np.minimum(latency, fastest),
            latency,
        )
        # hedges add load; reflect in utilization (small effect)
        rho = np.minimum(rho * (1.0 + hedge_fraction * 0.5), 1.0)

    return RouteResult(
        assigned=assigned,
        served=served,
        dropped=dropped,
        latency=latency,
        utilization=np.clip(rho, 0.0, 1.0),
    )
