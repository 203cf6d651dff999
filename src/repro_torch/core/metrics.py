"""Time-series metric accounting (the CloudWatch stand-in, §4.7).

Per-tick records of the quantities the paper plots: per-DU throughput
(HTTP 200 vs 500), latency, utilization, mode, and accrued cost — plus
per-REQUEST records (``RequestRecord``/``RequestLog``) for the fleet
runtime, where the unit of accounting is an individual generation request:
TTFT, TPOT, retries after replica failures, and goodput tokens.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class TickRecord:
    t: float
    demand_rps: float
    mode: int
    weights: np.ndarray
    ready: np.ndarray            # replicas serving, per DU
    served_rps: np.ndarray       # successful RPS per DU (HTTP 200)
    dropped_rps: float           # failed RPS (HTTP 500 equivalent)
    latency_s: np.ndarray        # mean end-to-end latency per DU
    utilization: np.ndarray      # per-DU core utilization
    cost_rate: float             # $/s accrued


@dataclass
class MetricsLog:
    du_names: Sequence[str]
    records: List[TickRecord] = field(default_factory=list)

    def append(self, rec: TickRecord) -> None:
        self.records.append(rec)

    # -- aggregates -----------------------------------------------------------
    def _stack(self, attr: str) -> np.ndarray:
        return np.stack([getattr(r, attr) for r in self.records])

    @property
    def times(self) -> np.ndarray:
        return np.array([r.t for r in self.records])

    def total_cost(self) -> float:
        if len(self.records) < 2:
            return 0.0
        ts = self.times
        rates = np.array([r.cost_rate for r in self.records])
        return float(np.sum(rates[:-1] * np.diff(ts)))

    def total_served(self) -> float:
        ts = self.times
        served = self._stack("served_rps").sum(axis=1)
        if len(ts) < 2:
            return 0.0
        return float(np.sum(served[:-1] * np.diff(ts)))

    def total_dropped(self) -> float:
        ts = self.times
        dropped = np.array([r.dropped_rps for r in self.records])
        if len(ts) < 2:
            return 0.0
        return float(np.sum(dropped[:-1] * np.diff(ts)))

    def availability(self) -> float:
        served, dropped = self.total_served(), self.total_dropped()
        total = served + dropped
        return served / total if total > 0 else 1.0

    def cost_per_1k_inferences(self) -> float:
        served = self.total_served()
        return 1000.0 * self.total_cost() / served if served > 0 else float("inf")

    def latency_percentile(self, q: float = 95.0) -> float:
        """Served-weighted latency percentile (a pool serving 5% of traffic
        contributes 5% of the latency mass, as a client would observe)."""
        lat = self._stack("latency_s").ravel()
        served = self._stack("served_rps").ravel()
        mask = served > 0
        if not np.any(mask):
            return 0.0
        lat, w = lat[mask], served[mask]
        order = np.argsort(lat)
        lat, w = lat[order], w[order]
        cdf = np.cumsum(w) / np.sum(w)
        idx = int(np.searchsorted(cdf, q / 100.0))
        return float(lat[min(idx, len(lat) - 1)])

    def mode_fraction(self, mode: int) -> float:
        modes = np.array([r.mode for r in self.records])
        return float(np.mean(modes == mode)) if len(modes) else 0.0

    def switches(self) -> int:
        modes = np.array([r.mode for r in self.records])
        return int(np.sum(modes[1:] != modes[:-1])) if len(modes) > 1 else 0

    def summary(self) -> Dict[str, float]:
        return {
            "total_cost_usd": self.total_cost(),
            "total_served": self.total_served(),
            "total_dropped": self.total_dropped(),
            "availability": self.availability(),
            "cost_per_1k": self.cost_per_1k_inferences(),
            "p95_latency_s": self.latency_percentile(95.0),
            "mode_switches": float(self.switches()),
            "cost_mode_fraction": self.mode_fraction(0),
        }


# ---------------------------------------------------------------------------
# Per-request accounting (fleet runtime)
# ---------------------------------------------------------------------------


@dataclass
class RequestRecord:
    """One completed generation request, timestamped in control-loop time."""

    rid: int
    arrival_t: float
    first_token_t: float          # when the first output token crossed a
                                  # chunk boundary (TTFT reference point)
    complete_t: float
    prompt_len: int
    tokens: int                   # goodput tokens actually delivered
    retries: int = 0              # replica deaths survived
    tier: str = ""
    replica: str = ""
    slo_class: str = "interactive"

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.arrival_t

    @property
    def latency_s(self) -> float:
        return self.complete_t - self.arrival_t

    @property
    def tpot_s(self) -> float:
        """Time per output token after the first (0 for 1-token outputs)."""
        if self.tokens <= 1:
            return 0.0
        return (self.complete_t - self.first_token_t) / (self.tokens - 1)


@dataclass
class RequestLog:
    """Request-granularity ledger: the measured half of the control loop."""

    records: List[RequestRecord] = field(default_factory=list)
    dropped: List[int] = field(default_factory=list)   # rids lost for good

    def append(self, rec: RequestRecord) -> None:
        self.records.append(rec)

    def goodput_tokens(self) -> int:
        return int(sum(r.tokens for r in self.records))

    def goodput_tokens_per_s(self) -> float:
        """Delivered tokens per second of control-loop time."""
        if not self.records:
            return 0.0
        t0 = min(r.arrival_t for r in self.records)
        t1 = max(r.complete_t for r in self.records)
        span = t1 - t0
        return self.goodput_tokens() / span if span > 0 else 0.0

    def total_retries(self) -> int:
        return int(sum(r.retries for r in self.records))

    def _percentile(self, values: List[float], q: float) -> float:
        return float(np.percentile(np.asarray(values), q)) if values else 0.0

    def ttft_percentile(self, q: float = 95.0, slo_class: Optional[str] = None) -> float:
        vals = [r.ttft_s for r in self.records
                if slo_class is None or r.slo_class == slo_class]
        return self._percentile(vals, q)

    def latency_percentile(self, q: float = 95.0, slo_class: Optional[str] = None) -> float:
        vals = [r.latency_s for r in self.records
                if slo_class is None or r.slo_class == slo_class]
        return self._percentile(vals, q)

    def tpot_mean(self) -> float:
        vals = [r.tpot_s for r in self.records if r.tokens > 1]
        return float(np.mean(vals)) if vals else 0.0

    def slo_attainment(self, targets: Dict[str, object]) -> float:
        """Fraction of requests meeting BOTH their class's TTFT and
        end-to-end latency targets (``targets`` maps class name to an
        ``SLOClass``-shaped object; ``fleet.workload.SLO_TARGETS`` is the
        canonical one).  Dropped requests count as misses; classes absent
        from ``targets`` count as met (no target means no promise)."""
        total = len(self.records) + len(self.dropped)
        if total == 0:
            return 1.0
        met = 0
        for r in self.records:
            c = targets.get(r.slo_class)
            if c is None or (r.ttft_s <= c.ttft_target_s
                             and r.latency_s <= c.latency_target_s):
                met += 1
        return met / total

    def per_tier_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for r in self.records:
            counts[r.tier] = counts.get(r.tier, 0) + 1
        return counts

    def summary(self) -> Dict[str, float]:
        return {
            "requests_completed": float(len(self.records)),
            "requests_dropped": float(len(self.dropped)),
            "goodput_tokens": float(self.goodput_tokens()),
            "goodput_tokens_per_s": self.goodput_tokens_per_s(),
            "total_retries": float(self.total_retries()),
            "p50_ttft_s": self.ttft_percentile(50.0),
            "p95_ttft_s": self.ttft_percentile(95.0),
            "p95_latency_s": self.latency_percentile(95.0),
            "mean_tpot_s": self.tpot_mean(),
        }
