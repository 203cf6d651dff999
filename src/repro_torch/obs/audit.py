"""Controller decision audit: every mode switch with the signal vector
that caused it.

The ModeController's binary step is the paper's core claim; this records
each evaluation that CHANGED the mode (plus the initial mode) as a frozen
``DecisionRecord`` — demand, per-tier pool capacity, autoscaler requests,
the measured t_max vector, and the derived booleans the step actually
branched on.  ``explains()`` recomputes the step from nothing but the
recorded inputs, so a drill can assert that the audit log is sufficient to
reproduce the controller's behavior — an unexplainable record means the
trace dropped a signal the controller used.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["DecisionRecord", "COST_OPTIMIZED", "CAPACITY_OPTIMIZED"]

# mirrors repro_torch.core.policy (obs stays import-free of the core so every
# layer can depend on it); test_obs pins the equivalence
COST_OPTIMIZED = 0
CAPACITY_OPTIMIZED = 1


@dataclass(frozen=True)
class DecisionRecord:
    """One controller decision with its full input snapshot."""

    t: float                          # control-loop time of the evaluation
    prev_mode: int
    mode: int
    switched: bool                    # False only for the initial record
    demand: float                     # conditioned demand the step consumed
    tiers: Tuple[str, ...]
    pool: Tuple[int, ...]             # per-tier pool capacity at t
    requested: Tuple[int, ...]        # autoscaler replica requests
    measured_t_max: Tuple[float, ...]  # live per-replica throughput signal
    tentative: Tuple[int, ...]        # replicas the cost allocation wants
    cap_violated: bool                # any(tentative > pool)  (Eq. 3 break)
    supply_possible: float            # sum(pool * t_max)
    hold_supply: float                # sum(min(requested, pool) * t_max)
    hysteresis_margin: float
    weights: Tuple[float, ...] = ()
    cost_rate: float = 0.0            # $/s accruing at the evaluation —
                                      # audit context (the step never
                                      # branches on it, so ``explains()``
                                      # ignores it by construction)

    def signals(self) -> Dict[str, object]:
        """The signal vector as a flat dict (what the tracer logs)."""
        return {
            "demand": self.demand,
            "pool": self.pool,
            "requested": self.requested,
            "measured_t_max": self.measured_t_max,
            "tentative": self.tentative,
            "cap_violated": self.cap_violated,
            "supply_possible": self.supply_possible,
            "hold_supply": self.hold_supply,
            "cost_rate": self.cost_rate,
        }

    def explains(self) -> bool:
        """Recompute the binary step from the recorded inputs alone and
        check it lands on the recorded mode — the audit-log sufficiency
        property the drills assert."""
        if self.cap_violated or self.supply_possible < self.demand:
            want = CAPACITY_OPTIMIZED
        elif (self.prev_mode == CAPACITY_OPTIMIZED
              and self.hold_supply
              < self.demand * (1.0 + self.hysteresis_margin)):
            want = CAPACITY_OPTIMIZED   # hysteresis hold: margin not met yet
        else:
            want = COST_OPTIMIZED
        return want == self.mode

    def reason(self) -> str:
        """Human-readable one-liner for logs / fleet_top."""
        if self.mode == CAPACITY_OPTIMIZED:
            if self.cap_violated:
                return (f"capacity: cost allocation wants {self.tentative} "
                        f"> pool {self.pool}")
            if self.supply_possible < self.demand:
                return (f"capacity: supply {self.supply_possible:.2f} < "
                        f"demand {self.demand:.2f}")
            return "capacity: hysteresis hold (recovery margin not met)"
        return (f"cost: supply {self.supply_possible:.2f} covers demand "
                f"{self.demand:.2f} with margin")
