"""Exact solvers for the paper's optimization problem, Eqs. (1)-(3).

The paper solves

    min Σ_i r_i · c_i    s.t.   Σ_i r_i · T_i ≥ T^d,   0 ≤ r_i ≤ p_i

with a two-mode heuristic (§3.3).  The LP relaxation is a fractional
knapsack: filling by ascending cost-per-throughput c_i/T_i is *optimal*.
We provide both the fractional optimum (a lower bound on achievable cost)
and the integral (ceil) allocation actually deployable as replica counts.

The port's copy of the JAX package's ``core/allocation.py`` (numpy only,
line for line).  A beyond-paper component: it measures the cost gap
between the paper's heuristic and this optimum; no fleet path calls it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class Allocation:
    replicas: np.ndarray        # r_i (float for fractional, int for integral)
    cost_rate: float            # Σ r_i · c_i  ($/hour)
    supply: float               # Σ r_i · T_i  (RPS)
    feasible: bool              # supply >= demand within pool limits


def _order_by_efficiency(cost_per_hour: np.ndarray, t_max: np.ndarray) -> np.ndarray:
    # $/hr per RPS == 3600 × cost-per-inference: same ordering as Table 1.
    eff = cost_per_hour / np.maximum(t_max, 1e-12)
    return np.argsort(eff, kind="stable")


def optimal_fractional(
    cost_per_hour: Sequence[float],
    t_max: Sequence[float],
    pool: Sequence[float],
    demand: float,
) -> Allocation:
    """Greedy fill by cost-per-RPS — exact optimum of the LP relaxation."""
    c = np.asarray(cost_per_hour, dtype=np.float64)
    t = np.asarray(t_max, dtype=np.float64)
    p = np.asarray(pool, dtype=np.float64)
    r = np.zeros_like(c)
    remaining = float(demand)
    for i in _order_by_efficiency(c, t):
        if remaining <= 1e-12:
            break
        if t[i] <= 0 or p[i] <= 0:
            continue
        take = min(p[i], remaining / t[i])
        r[i] = take
        remaining -= take * t[i]
    supply = float(np.sum(r * t))
    return Allocation(r, float(np.sum(r * c)), supply, supply + 1e-9 >= demand)


def optimal_integral(
    cost_per_hour: Sequence[float],
    t_max: Sequence[float],
    pool: Sequence[int],
    demand: float,
) -> Allocation:
    """Integral replica counts: greedy fill + ceil on the marginal unit.

    Greedy-by-efficiency with a final ceil is optimal for this structure up
    to one replica of slack per DU type; for the ≤5-unit instances in the
    paper we then do an exhaustive trim pass to remove any replica whose
    removal keeps feasibility (making the result a local optimum that in
    practice matches brute force — asserted in tests for small instances).
    """
    c = np.asarray(cost_per_hour, dtype=np.float64)
    t = np.asarray(t_max, dtype=np.float64)
    p = np.asarray(pool, dtype=np.int64)
    r = np.zeros(len(c), dtype=np.int64)
    remaining = float(demand)
    for i in _order_by_efficiency(c, t):
        if remaining <= 1e-9:
            break
        if t[i] <= 0 or p[i] <= 0:
            continue
        need = int(np.ceil(remaining / t[i]))
        take = min(int(p[i]), need)
        r[i] = take
        remaining -= take * t[i]
    # Trim pass: drop replicas that are not needed for feasibility,
    # most-expensive-per-RPS first.
    order = _order_by_efficiency(c, t)[::-1]
    supply = float(np.sum(r * t))
    for i in order:
        while r[i] > 0 and supply - t[i] + 1e-9 >= demand:
            r[i] -= 1
            supply -= t[i]
    supply = float(np.sum(r * t))
    return Allocation(r, float(np.sum(r * c)), supply, supply + 1e-9 >= demand)


def heuristic_allocation(
    weights: np.ndarray,
    t_max: np.ndarray,
    pool: np.ndarray,
    demand: float,
) -> Allocation:
    """The paper's §3.3 allocation: split demand by routing weights, then
    provision ceil(share/T_i) replicas per DU, clipped to pool capacity.
    Used as the faithful baseline against the optimum above.
    """
    w = np.asarray(weights, dtype=np.float64)
    t = np.asarray(t_max, dtype=np.float64)
    p = np.asarray(pool, dtype=np.int64)
    share = w * demand
    r = np.ceil(np.divide(share, np.maximum(t, 1e-12))).astype(np.int64)
    r = np.minimum(r, p)
    supply = float(np.sum(r * t))
    return Allocation(r, float("nan"), supply, supply + 1e-9 >= demand)


def brute_force_integral(
    cost_per_hour: Sequence[float],
    t_max: Sequence[float],
    pool: Sequence[int],
    demand: float,
    cap: int = 8,
) -> Allocation:
    """Exhaustive search for tiny instances (test oracle only)."""
    import itertools

    c = np.asarray(cost_per_hour, dtype=np.float64)
    t = np.asarray(t_max, dtype=np.float64)
    p = [min(int(x), cap) for x in pool]
    best = None
    for combo in itertools.product(*[range(x + 1) for x in p]):
        r = np.asarray(combo, dtype=np.int64)
        if float(np.sum(r * t)) + 1e-9 < demand:
            continue
        cost = float(np.sum(r * c))
        if best is None or cost < best[0]:
            best = (cost, r)
    if best is None:
        return Allocation(np.zeros(len(c), dtype=np.int64), 0.0, 0.0, False)
    cost, r = best
    return Allocation(r, cost, float(np.sum(r * t)), True)
