"""The paper's §3 policy math, on torch tensors.

Counterpart of the JAX package's ``core/policy.py``:

  * Eq. (5)  cost-optimized weights        w_i^cost ∝ 1/DU_i^c
  * Eq. (6)  capacity-optimized weights    w_i^cap = 1/n over available units
  * Eq. (7)  T^target = Σ T_i^max / n
  * Eq. (8)  T_i^adjusted = min(T_i, T^target)  (capacity normalization)
  * the binary switching rule between the two weight regimes
  * Eq. (1)-(3) objective/constraint evaluation helpers

plus the latency-aware variant of Eq. (5).  Every function takes 1-D
tensors indexed by deployment unit and computes on their device.

Everything is float32, as the JAX functions compute without x64: a float64
input is rounded to float32 first (``as_f32``), and booleans stay boolean.
The controller's weights feed the dispatcher's largest-deficit rounding, so
a last-bit difference from the reference would move a request.  So every
sum over the units runs left to right, one add at a time (``_sum``): a CUDA
reduction pairs three or more terms in another order than the CPU's and
rounds differently, and the card must take the CPU's decisions.  For
the same reason no function divides a device tensor by a host scalar.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

# Mode codes for the binary step function.
COST_OPTIMIZED = 0
CAPACITY_OPTIMIZED = 1

ArrayLike = Union[torch.Tensor, np.ndarray, float, int, bool]


def as_f32(x: ArrayLike, device: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (a tensor's own by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def as_bool(x: ArrayLike, device: Optional[torch.device] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(x, bool), device=device)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _sum(x: torch.Tensor) -> torch.Tensor:
    """((x0 + x1) + x2) + ... over a 1-D tensor, the same bits on every device."""
    out = _zero(x)
    for v in x.unbind():
        out = out + v
    return out


def cost_weights(cost_per_inference: torch.Tensor, available: torch.Tensor) -> torch.Tensor:
    """Eq. (5): weights proportional to inverse cost over available units.

    ``available`` is a boolean mask (DU_i^p(t) > 0).  Unavailable units get
    weight 0; weights renormalize over the rest."""
    cost = as_f32(cost_per_inference)
    inv = torch.where(as_bool(available, cost.device), 1.0 / torch.clamp(cost, min=1e-30),
                      _zero(cost))
    total = _sum(inv)
    return torch.where(total > 0, inv / torch.clamp(total, min=1e-30), _zero(cost))


def latency_aware_cost_weights(cost_per_inference: torch.Tensor, latency_s: torch.Tensor,
                               available: torch.Tensor) -> torch.Tensor:
    """The 'cost-to-latency ratio' the paper describes in prose for Eq. (5):
    weight ∝ 1/(c_i·L_i)."""
    cost = as_f32(cost_per_inference)
    score = torch.where(as_bool(available, cost.device),
                        1.0 / torch.clamp(cost * as_f32(latency_s, cost.device), min=1e-30),
                        _zero(cost))
    total = _sum(score)
    return torch.where(total > 0, score / torch.clamp(total, min=1e-30), _zero(cost))


def capacity_weights(available: torch.Tensor) -> torch.Tensor:
    """Eq. (6): uniform over units with available capacity."""
    av = as_bool(available)
    n = av.to(torch.float32).sum()
    w = 1.0 / torch.clamp(n, min=1.0)
    return torch.where(av, w, torch.zeros((), dtype=torch.float32, device=av.device))


def t_target(t_max: torch.Tensor, available: torch.Tensor) -> torch.Tensor:
    """Eq. (7): average max throughput across available units."""
    t = as_f32(t_max)
    av = as_bool(available, t.device)
    n = av.to(torch.float32).sum()
    return _sum(torch.where(av, t, _zero(t))) / torch.clamp(n, min=1.0)


def t_adjusted(t_max: torch.Tensor, available: torch.Tensor) -> torch.Tensor:
    """Eq. (8): per-unit throughput clipped to the uniform target; units
    slower than the target keep their own T_i^max (Table 2's (89.2, 89.2,
    89.2, 61.0, 60.0))."""
    t = as_f32(t_max)
    av = as_bool(available, t.device)
    return torch.where(av, torch.minimum(t, t_target(t, av)), _zero(t))


def supply(requested: torch.Tensor, t_max: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Eq. (6-supply): T^s(t) = Σ w_i · T_i · DU_i^r(t)."""
    w = as_f32(weights)
    return _sum(w * as_f32(t_max, w.device) * as_f32(requested, w.device))


def throughput_constraint_ok(requested: torch.Tensor, t_max: torch.Tensor,
                             demand: torch.Tensor) -> torch.Tensor:
    """Eq. (2): Σ DU_i^r · T_i ≥ T^d."""
    t = as_f32(t_max)
    return _sum(as_f32(requested, t.device) * t) >= as_f32(demand, t.device)


def capacity_constraint_ok(requested: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Eq. (3): DU_i^r ≤ DU_i^p for all i."""
    r = as_f32(requested)
    return torch.all(r <= as_f32(pool, r.device))


def total_cost_rate(requested: torch.Tensor, cost_per_hour: torch.Tensor) -> torch.Tensor:
    """Eq. (1) objective: Σ DU_i^r · DU_i^c  (as $/s of provisioned fleet)."""
    c = as_f32(cost_per_hour)
    # a tensor divisor: CUDA divides by a host scalar as a product with its
    # reciprocal, which rounds otherwise than the CPU's division
    return _sum(as_f32(requested, c.device) * c) / torch.tensor(3600.0, device=c.device)


def switch_mode(requested: torch.Tensor, pool: torch.Tensor, t_max: torch.Tensor,
                demand: torch.Tensor) -> torch.Tensor:
    """The paper's binary step: COST_OPTIMIZED while Eq.(2)+(3) hold with the
    cost-optimized allocation; CAPACITY_OPTIMIZED if ∃i: DU_i^r > DU_i^p."""
    ok = torch.logical_and(throughput_constraint_ok(requested, t_max, demand),
                           capacity_constraint_ok(requested, pool))
    return torch.where(ok, COST_OPTIMIZED, CAPACITY_OPTIMIZED).to(torch.int32)


def select_weights(mode: torch.Tensor, cost_per_inference: torch.Tensor,
                   available: torch.Tensor) -> torch.Tensor:
    """w_i(t) per the switching rule (paper Eq. '5-switch')."""
    w_cost = cost_weights(cost_per_inference, available)
    w_cap = capacity_weights(as_bool(available, w_cost.device))
    m = torch.as_tensor(mode, device=w_cost.device)
    return torch.where(m == COST_OPTIMIZED, w_cost, w_cap)


def policy_step(cost_per_inference: torch.Tensor, cost_per_hour: torch.Tensor,
                t_max: torch.Tensor, requested: torch.Tensor, pool: torch.Tensor,
                demand: torch.Tensor):
    """One full control-loop policy evaluation.

    Returns (mode, weights, supply_rps, cost_rate) — the quantities the
    simulator/serving router consume each tick."""
    p = as_f32(pool)
    available = p > 0
    mode = switch_mode(requested, p, t_max, demand)
    w = select_weights(mode, cost_per_inference, available)
    sup = supply(requested, t_max, w)
    cost = total_cost_rate(torch.minimum(as_f32(requested, p.device), p), cost_per_hour)
    return mode, w, sup, cost


def desired_replicas_for_demand(weights: torch.Tensor, t_max: torch.Tensor,
                                demand: torch.Tensor) -> torch.Tensor:
    """Replicas per DU needed to serve ``demand`` split by ``weights``
    (the KEDA targetMetricValue computation: ceil(share / T_i^max))."""
    w = as_f32(weights)
    share = w * as_f32(demand, w.device)
    return torch.ceil(share / torch.clamp(as_f32(t_max, w.device), min=1e-9)).to(torch.int32)
