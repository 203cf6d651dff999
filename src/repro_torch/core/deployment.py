"""Deployment units: the (model, hardware, framework) triplet of §3.1.

The port's copy of the JAX package's ``core/deployment.py``.
``DUProfile`` carries the per-unit signals the control loop consumes:
max single-replica throughput ``T_i^max``, latency ``L_i``, and hourly cost,
from which the paper's *cost of inference per second* is derived:

    DU_i^c = cost_per_hour / 3600 / T_i^max        (Table 1)

``profile_from_roofline`` (service rates from a roofline of an arch on a
hardware tier) is not here: the port has no hardware tier for the H100 yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DUProfile:
    """Static profile of one deployment-unit type (one replica)."""

    name: str
    model: str
    hardware: str
    framework: str
    cost_per_hour: float     # $/replica-hour
    t_max: float             # breaking-point throughput, requests/s/replica
    latency_s: float         # single-request latency at healthy utilization
    chips_per_replica: int = 1

    @property
    def cost_per_inference(self) -> float:
        """Table 1 'Cost of Inference/Second': cost/hour ÷ breaking-point RPS.

        (The paper's column divides hourly cost by T_i^max directly; its first
        two rows differ from this formula by <1.5% — measurement rounding —
        which tests assert within tolerance.)
        """
        return self.cost_per_hour / self.t_max

    @property
    def dollars_per_request(self) -> float:
        """True $/request at the breaking point (cost_per_inference / 3600)."""
        return self.cost_per_hour / 3600.0 / self.t_max

    def with_cost(self, cost_per_hour: float) -> "DUProfile":
        return replace(self, cost_per_hour=cost_per_hour)


@dataclass
class DeploymentUnit:
    """Mutable runtime state of a DU pool: requested/provisioned replicas.

    Mirrors the paper's DU_i^r (requested) and DU_i^p (pool capacity).
    """

    profile: DUProfile
    requested: int = 0        # DU_i^r(t)
    pool_capacity: int = 0    # DU_i^p(t) — max replicas currently obtainable
    ready: int = 0            # replicas actually serving (<= requested)

    @property
    def supply_rps(self) -> float:
        return self.ready * self.profile.t_max

    @property
    def cost_rate(self) -> float:
        """$/s currently accrued by ready replicas."""
        return self.ready * self.profile.cost_per_hour / 3600.0
