"""The mode-switching controller (§3.3 + §5.4.3).

The port's copy of the JAX package's ``core/controller.py``.  Its policy
calls (``core/policy.py``) run on the controller's device, as the JAX
controller's jitted calls run on JAX's default backend.  A step computes
the three weight vectors it may need there (cost weights over every unit,
which size the tentative allocation, and the cost and capacity weights
over the available units) and reads them back to the host at once.

Faithful behavior: a *binary step function* between cost-optimized and
capacity-optimized weight regimes, switching the instant the capacity
constraint Eq. (3) breaks, and falling back when capacity recovers (Fig. 7).

Beyond-paper extensions (both default OFF so the faithful path is the
baseline):
  * ``hysteresis_margin`` — require supply to exceed demand by a margin
    before falling back to cost-optimized, eliminating mode flapping when
    demand sits exactly at the cost-pool capacity edge;
  * ``demand_ewma_alpha`` — EWMA smoothing of the demand signal, modeling
    the paper's cyclic-load assumption without requiring cycle resets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import policy
from repro_torch.core.deployment import DUProfile
from repro_torch.device import resolve_device


@dataclass
class ControllerConfig:
    latency_aware: bool = False          # beyond-paper Eq.(5) variant
    hysteresis_margin: float = 0.0       # fraction of demand (e.g. 0.1)
    demand_ewma_alpha: float = 1.0       # 1.0 == no smoothing (faithful)
    min_dwell_s: float = 0.0             # min time between mode switches


@dataclass
class SwitchDecision:
    mode: int                            # policy.COST_OPTIMIZED / CAPACITY_OPTIMIZED
    weights: np.ndarray
    demand_seen: float                   # (possibly smoothed) demand used
    switched: bool
    # -- the signal vector the step branched on (the decision audit log
    #    records these verbatim so every switch is explainable after the
    #    fact; None-free even when measured_t_max was omitted) -------------
    t_max_used: np.ndarray = None        # profile or measured service rates
    tentative: np.ndarray = None         # replicas the cost allocation wants
    cap_violated: bool = False           # any(tentative > pool): Eq.(3) break
    supply_possible: float = 0.0         # sum(pool * t_max)
    hold_supply: float = 0.0             # sum(min(requested, pool) * t_max)
    prev_mode: int = 0                   # mode before this evaluation
    cost_rate: float = 0.0               # $/s the fleet was accruing at the
                                         # evaluation (audit context only —
                                         # the step does not branch on it)


def speculation_k(mode: int, spec_k: int, accept_rate: Optional[float],
                  accept_floor: float = 0.3) -> int:
    """The speculative-decode depth the mode controller grants a tier.

    Speculation trades compute for latency: drafted-but-rejected tokens
    burn step capacity that capacity-optimized mode needs for admission,
    and a tier whose measured acceptance EWMA sits under ``accept_floor``
    is paying the wide verify dispatch for nothing.  Either condition
    drives k to 0 — goodput is never spent on a losing bet.  ``None``
    acceptance (no drafted round measured yet) grants the configured k:
    the signal has to come from somewhere."""
    if spec_k <= 0 or mode == policy.CAPACITY_OPTIMIZED:
        return 0
    if accept_rate is not None and accept_rate < accept_floor:
        return 0
    return int(spec_k)


class ModeController:
    """Stateful wrapper around the policy math.  ``device`` (the card by
    default) is where the policy calls run."""

    def __init__(self, profiles: Sequence[DUProfile], config: Optional[ControllerConfig] = None,
                 *, device=None):
        self.device = resolve_device(device)
        self.profiles = tuple(profiles)
        self.config = config or ControllerConfig()
        self.cost_per_inference = np.array([p.cost_per_inference for p in profiles])
        self.cost_per_hour = np.array([p.cost_per_hour for p in profiles])
        self.t_max = np.array([p.t_max for p in profiles])
        self.latency = np.array([p.latency_s for p in profiles])
        self.mode = policy.COST_OPTIMIZED
        self._ewma: Optional[float] = None
        self._last_switch_t: float = -1e18

    def _weights(self, cost_per_inference: np.ndarray,
                 available: np.ndarray) -> np.ndarray:
        """(3, n) float32 on the host: cost weights over every unit, then
        the cost-mode and the capacity-mode weights over ``available``,
        computed on this controller's device."""
        dev = self.device
        cost = policy.as_f32(cost_per_inference, dev)
        av = policy.as_bool(available, dev)
        if self.config.latency_aware:
            w_cost = policy.latency_aware_cost_weights(
                cost, policy.as_f32(self.latency, dev), av)
        else:
            w_cost = policy.cost_weights(cost, av)
        return torch.stack([policy.cost_weights(cost, torch.ones_like(av)), w_cost,
                            policy.capacity_weights(av)]).cpu().numpy()

    # -- demand conditioning -------------------------------------------------
    def _condition_demand(self, demand: float) -> float:
        a = self.config.demand_ewma_alpha
        if a >= 1.0:
            return demand
        self._ewma = demand if self._ewma is None else a * demand + (1 - a) * self._ewma
        return self._ewma

    # -- main entry ------------------------------------------------------------
    def step(
        self,
        t: float,
        demand: float,
        requested: np.ndarray,
        pool: np.ndarray,
        measured_t_max: Optional[np.ndarray] = None,
        cost_rate: float = 0.0,
    ) -> SwitchDecision:
        """Evaluate the binary step for one tick.

        ``measured_t_max`` closes the loop over the live data plane: when
        given (the fleet runtime's per-tier EWMA of measured per-replica
        throughput), the capacity constraint and supply estimates use the
        *observed* service rates instead of the static Table-1 profile
        constants.  Omitted, behavior is byte-identical to the analytic
        simulator path.
        """
        t_max = (
            np.asarray(measured_t_max, dtype=np.float64)
            if measured_t_max is not None
            else self.t_max
        )
        # Table 1's DU_i^c = cost/hr ÷ T_i^max, with the measured denominator
        # when the data plane reports one: a tier serving slower than its
        # nominal profile becomes proportionally more expensive per inference
        # and loses cost-optimized weight.
        cost_per_inference = (
            self.cost_per_hour / np.maximum(t_max, 1e-9)
            if measured_t_max is not None
            else self.cost_per_inference
        )
        demand_s = self._condition_demand(demand)
        available = pool > 0

        # §3.3: capacity constraint is evaluated against what the
        # COST-OPTIMIZED allocation *would* request right now (the paper's
        # DU^r under Eq. 5 weights over all units), not the autoscaler's
        # current replica counts — otherwise a scaled-to-zero dead pool
        # looks "satisfied" and the controller would flap back to cost mode
        # mid-outage.
        w_full, w_cost, w_cap = self._weights(cost_per_inference, available)
        tentative = np.ceil(
            w_full * demand_s / np.maximum(0.8 * t_max, 1e-9)
        ).astype(np.int64)
        cap_violated = bool(np.any(tentative > pool))
        supply_possible = float(np.sum(pool * t_max))
        hold_supply = float(np.sum(np.minimum(requested, pool) * t_max))

        prev = self.mode
        if cap_violated or supply_possible < demand_s:
            want = policy.CAPACITY_OPTIMIZED
        else:
            margin = 1.0 + self.config.hysteresis_margin
            if (prev == policy.CAPACITY_OPTIMIZED
                    and hold_supply < demand_s * margin):
                want = policy.CAPACITY_OPTIMIZED  # hold until margin met
            else:
                want = policy.COST_OPTIMIZED

        switched = want != prev
        if switched and (t - self._last_switch_t) < self.config.min_dwell_s:
            want = prev
            switched = False
        if switched:
            self._last_switch_t = t
        self.mode = want

        w = w_cost if want == policy.COST_OPTIMIZED else w_cap
        return SwitchDecision(
            mode=want,
            weights=np.asarray(w),
            demand_seen=demand_s,
            switched=switched,
            t_max_used=np.asarray(t_max, dtype=np.float64),
            tentative=tentative,
            cap_violated=cap_violated,
            supply_possible=supply_possible,
            hold_supply=hold_supply,
            prev_mode=prev,
            cost_rate=float(cost_rate),
        )
