"""EWMA telemetry bus: the measured signals the control loop consumes.

The analytic simulator feeds the controller Table-1 constants; the fleet
runtime feeds it THIS — per-replica exponentially-weighted measurements of
what the data plane actually did (tokens/s, queue depth, slot occupancy,
per-request completion rate), rolled up per tier.  ``measured_t_max`` is
the live stand-in for the paper's breaking-point throughput column: the
observed per-replica request completion rate, de-rated by observed
occupancy so an under-utilized tier is not mistaken for a slow one.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.obs import MetricsRegistry

# per-tier rolling TTFT window: enough samples for a stable p99 without
# letting ancient completions mask a fresh latency regression
TTFT_WINDOW = 512
# TPOT shares the window length: both tails feed the chunk-budget retune
TPOT_WINDOW = 512


class Ewma:
    """Exponentially weighted moving average; ``value`` is None until the
    first update (callers fall back to a nominal bootstrap estimate)."""

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        x = float(x)
        self.value = x if self.value is None else (
            self.alpha * x + (1.0 - self.alpha) * self.value
        )
        return self.value

    def get(self, default: float = 0.0) -> float:
        return self.value if self.value is not None else default


@dataclass
class ReplicaSignals:
    """Per-replica EWMA channels (one bundle per live replica)."""

    tokens_per_s: Ewma          # measured decode tokens/s (wall clock)
    occupancy: Ewma             # decode-slot occupancy [0, 1]
    queue_depth: Ewma           # requests waiting behind the slots
    ttft_s: Ewma                # time-to-first-token (control-loop time)
    tpot_s: Ewma                # time-per-output-token

    @classmethod
    def make(cls, alpha: float) -> "ReplicaSignals":
        return cls(*(Ewma(alpha) for _ in range(5)))


@dataclass
class _TierWindow:
    """Per-tick accumulation window for one tier (reset every roll)."""

    completions: int = 0
    busy_replicas: int = 0      # replicas with at least one active slot
    ready_replicas: int = 0
    useful_tokens: int = 0
    wall_s: float = 0.0
    prefix_hits: int = 0        # paged-KV admissions served from cache
    prefix_misses: int = 0
    reused_tokens: int = 0
    prefilled_tokens: int = 0
    drafted_tokens: int = 0     # speculative-decode proposals this tick
    accepted_tokens: int = 0    # ... of which the verify step kept
    spec_rounds: int = 0


class TelemetryBus:
    """Collects ``PumpReport``s + completions; serves tier-level EWMAs.

    ``roll(tick_s)`` closes the current per-tick window and folds it into
    the tier EWMAs — call once per control-loop tick, after pumping.
    """

    def __init__(self, tiers: List[str], alpha: float = 0.3):
        self.tiers = list(tiers)
        self.alpha = alpha
        self.replica: Dict[str, ReplicaSignals] = {}
        self._window: Dict[str, _TierWindow] = {t: _TierWindow() for t in tiers}
        # per-tier EWMAs over tick windows
        self.tier_rate: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}       # req/s/replica
        self.tier_occupancy: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}
        self.tier_tokens_per_s: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}
        self.tier_ttft: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}
        self.tier_tpot: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}
        # rolling raw TTFT samples: EWMAs hide the tail, and the tail is
        # what the chunk-budget knob trades against TPOT — the controller
        # reads p99 from here (head-of-line prefill blocking lives there)
        self._ttft_window: Dict[str, Deque[float]] = {
            t: deque(maxlen=TTFT_WINDOW) for t in tiers
        }
        self._tpot_window: Dict[str, Deque[float]] = {
            t: deque(maxlen=TPOT_WINDOW) for t in tiers
        }
        # paged-KV prefix cache effectiveness (stays at 0 for contiguous tiers)
        self.tier_cache_hit_rate: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}
        self.tier_token_reuse: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}
        self.tier_page_occupancy: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}
        # speculative decoding: acceptance EWMA (the controller's k->0
        # signal; None until the tier's first drafted round) + cumulative
        # draft/accept totals (the counter-audit tests pin exact counts)
        self.tier_spec_accept: Dict[str, Ewma] = {t: Ewma(alpha) for t in tiers}
        self.tier_drafted: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_accepted: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_spec_rounds: Dict[str, int] = {t: 0 for t in tiers}
        # durable-KV recovery: cumulative totals (not EWMAs — the drills
        # assert exact counts, "zero recomputed prefill tokens" especially)
        self.tier_recovered: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_recomputed: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_flush_s: Dict[str, float] = {t: 0.0 for t in tiers}
        self.tier_flush_tokens: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_backoffs: Dict[str, int] = {t: 0 for t in tiers}  # crash-loop holds
        # capacity economics: cumulative cost/elasticity totals per tier
        # (exact counts the economics bench and the scale-to-zero regression
        # assert on — not EWMAs)
        self.tier_cost_usd: Dict[str, float] = {t: 0.0 for t in tiers}
        self.tier_billable_s: Dict[str, float] = {t: 0.0 for t in tiers}
        self.tier_cold_starts: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_cold_start_s: Dict[str, float] = {t: 0.0 for t in tiers}
        self.tier_warm_promotions: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_preemptions: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_idle_released: Dict[str, int] = {t: 0 for t in tiers}
        # cross-model capacity trading: per-MODEL demand EWMAs (keyed by the
        # arch a request targets, "" = model-agnostic traffic) and per-tier
        # lease totals — ceiling units this tier borrowed (+) / lent (-)
        self._model_demand: Dict[str, Ewma] = {}
        self.tier_borrowed: Dict[str, int] = {t: 0 for t in tiers}
        self.tier_lent: Dict[str, int] = {t: 0 for t in tiers}
        # structured metrics: fixed-bucket histograms give the snapshot's
        # EWMA levels a distribution (real p50/p90/p99, mergeable across
        # runs) and the cumulative dicts above a Prometheus exposition
        self.metrics = MetricsRegistry()
        self._h_ttft = self.metrics.histogram(
            "fleet_ttft_seconds", "time to first token", labels=("tier",))
        self._h_tpot = self.metrics.histogram(
            "fleet_tpot_seconds", "time per output token", labels=("tier",))
        self._h_pump = self.metrics.histogram(
            "fleet_pump_wall_seconds", "engine pump wall time", labels=("tier",))
        self._c_completions = self.metrics.counter(
            "fleet_completions_total", "completed requests", labels=("tier",))
        self._c_tokens = self.metrics.counter(
            "fleet_useful_tokens_total", "useful decoded tokens", labels=("tier",))
        self._c_flush_tokens = self.metrics.counter(
            "fleet_kv_flush_tokens_total", "tokens accepted by KV flushes",
            labels=("tier",))
        self._c_backoffs = self.metrics.counter(
            "fleet_crash_backoffs_total", "crash-loop provisioning holds",
            labels=("tier",))
        self._c_cost = self.metrics.counter(
            "fleet_cost_usd_total", "accrued replica cost (USD)",
            labels=("tier",))
        self._c_billable = self.metrics.counter(
            "fleet_billable_replica_seconds_total",
            "replica-seconds holding a node", labels=("tier",))
        self._c_cold_starts = self.metrics.counter(
            "fleet_cold_starts_total", "replica cold starts begun",
            labels=("tier",))
        self._c_warm_promotions = self.metrics.counter(
            "fleet_warm_promotions_total",
            "warm standbys promoted to serving", labels=("tier",))
        self._c_preemptions = self.metrics.counter(
            "fleet_preemptions_total", "spot preemption notices delivered",
            labels=("tier",))
        self._c_drafted = self.metrics.counter(
            "fleet_drafted_tokens_total", "speculative draft tokens proposed",
            labels=("tier",))
        self._c_accepted = self.metrics.counter(
            "fleet_accepted_tokens_total",
            "speculative draft tokens accepted by verification",
            labels=("tier",))

    # -- ingestion ----------------------------------------------------------
    def signals_for(self, replica_name: str) -> ReplicaSignals:
        if replica_name not in self.replica:
            self.replica[replica_name] = ReplicaSignals.make(self.alpha)
        return self.replica[replica_name]

    def record_pump(self, tier: str, replica_name: str, report, queue_depth: int) -> None:
        sig = self.signals_for(replica_name)
        sig.occupancy.update(report.occupancy)
        sig.queue_depth.update(queue_depth)
        if report.wall_s > 0 and report.useful_tokens > 0:
            sig.tokens_per_s.update(report.useful_tokens / report.wall_s)
        win = self._window[tier]
        win.completions += len(report.completed)
        win.useful_tokens += report.useful_tokens
        win.wall_s += report.wall_s
        if report.wall_s > 0:
            self._h_pump.labels(tier).observe(report.wall_s)
        if len(report.completed):
            self._c_completions.labels(tier).inc(len(report.completed))
        if report.useful_tokens:
            self._c_tokens.labels(tier).inc(report.useful_tokens)
        if report.occupancy > 0:
            win.busy_replicas += 1
        # paged-KV channels (getattr: contiguous reports may predate them)
        win.prefix_hits += getattr(report, "prefix_hits", 0)
        win.prefix_misses += getattr(report, "prefix_misses", 0)
        win.reused_tokens += getattr(report, "reused_tokens", 0)
        win.prefilled_tokens += getattr(report, "prefilled_tokens", 0)
        self.tier_recovered[tier] += getattr(report, "recovered_tokens", 0)
        self.tier_recomputed[tier] += getattr(
            report, "recomputed_prefill_tokens", 0)
        # speculative-decode channels (getattr: non-spec reports count 0)
        drafted = getattr(report, "drafted_tokens", 0)
        accepted = getattr(report, "accepted_tokens", 0)
        win.drafted_tokens += drafted
        win.accepted_tokens += accepted
        win.spec_rounds += getattr(report, "spec_rounds", 0)
        self.tier_drafted[tier] += drafted
        self.tier_accepted[tier] += accepted
        self.tier_spec_rounds[tier] += getattr(report, "spec_rounds", 0)
        if drafted:
            self._c_drafted.labels(tier).inc(drafted)
        if accepted:
            self._c_accepted.labels(tier).inc(accepted)
        # unconditional: a drained pool must decay the EWMA back toward 0
        # (contiguous tiers just keep it pinned at 0)
        self.tier_page_occupancy[tier].update(getattr(report, "page_occupancy", 0.0))

    def record_ready(self, tier: str, n_ready: int) -> None:
        self._window[tier].ready_replicas = n_ready

    def record_completion(self, tier: str, replica_name: str,
                          ttft_s: float, tpot_s: float, tokens: int) -> None:
        sig = self.signals_for(replica_name)
        sig.ttft_s.update(ttft_s)
        self.tier_ttft[tier].update(ttft_s)
        self._ttft_window[tier].append(float(ttft_s))
        self._h_ttft.labels(tier).observe(ttft_s)
        if tokens > 1:
            sig.tpot_s.update(tpot_s)
            self.tier_tpot[tier].update(tpot_s)
            self._tpot_window[tier].append(float(tpot_s))
            self._h_tpot.labels(tier).observe(tpot_s)

    def ttft_p99(self, tier: str) -> float:
        """p99 TTFT over the tier's rolling completion window (0 until the
        first completion)."""
        win = self._ttft_window[tier]
        if not win:
            return 0.0
        return float(np.percentile(np.asarray(win), 99.0))

    def tpot_p99(self, tier: str) -> float:
        """p99 TPOT over the tier's rolling completion window (0 until the
        first multi-token completion) — the decode-smoothness tail that the
        chunk budget trades TTFT against."""
        win = self._tpot_window[tier]
        if not win:
            return 0.0
        return float(np.percentile(np.asarray(win), 99.0))

    def record_flush(self, tier: str, wall_s: float, tokens: int) -> None:
        """One KV-store flush (periodic checkpoint or preemption drain):
        host wall time spent extracting + storing, and tokens ACCEPTED by
        the store (stale checkpoints count 0)."""
        self.tier_flush_s[tier] += float(wall_s)
        self.tier_flush_tokens[tier] += int(tokens)
        self._c_flush_tokens.labels(tier).inc(int(tokens))

    def record_backoff(self, tier: str) -> None:
        """The crash-loop guard held this tier's re-provisioning back."""
        self.tier_backoffs[tier] += 1
        self._c_backoffs.labels(tier).inc()

    # -- capacity economics -------------------------------------------------
    def record_cost(self, tier: str, billable: int, cost_rate: float,
                    tick_s: float) -> None:
        """One tick of accrual: ``billable`` replicas holding nodes at
        ``cost_rate`` $/s for ``tick_s`` seconds of control-loop time."""
        self.tier_billable_s[tier] += billable * tick_s
        self.tier_cost_usd[tier] += cost_rate * tick_s
        if billable:
            self._c_billable.labels(tier).inc(billable * tick_s)
        if cost_rate > 0:
            self._c_cost.labels(tier).inc(cost_rate * tick_s)

    def record_cold_start(self, tier: str, delay_s: float) -> None:
        """A replica cold start began, paying ``delay_s`` before ready."""
        self.tier_cold_starts[tier] += 1
        self.tier_cold_start_s[tier] += float(delay_s)
        self._c_cold_starts.labels(tier).inc()

    def record_warm_promotion(self, tier: str, n: int = 1) -> None:
        """``n`` warm standbys promoted to serving (cold start skipped)."""
        self.tier_warm_promotions[tier] += int(n)
        self._c_warm_promotions.labels(tier).inc(int(n))

    def record_preemption(self, tier: str, *, idle: bool) -> None:
        """A spot reclaim hit this tier; ``idle`` victims (standby or
        no live work) released without the drain machinery."""
        self.tier_preemptions[tier] += 1
        self._c_preemptions.labels(tier).inc()
        if idle:
            self.tier_idle_released[tier] += 1

    # -- cross-model capacity trading ---------------------------------------
    def record_model_demand(self, model: str, rate: float) -> None:
        """One tick of per-model demand (arrivals/s + backlog pressure for
        requests targeting ``model``); updated every tick — including with
        zero — so an idle family's signal decays instead of pinning."""
        if model not in self._model_demand:
            self._model_demand[model] = Ewma(self.alpha)
        self._model_demand[model].update(rate)

    def model_demand(self, model: str) -> float:
        """The demand EWMA for one model family (0 until first recorded)."""
        ew = self._model_demand.get(model)
        return ew.get() if ew is not None else 0.0

    def model_demand_snapshot(self) -> Dict[str, float]:
        return {m: ew.get() for m, ew in self._model_demand.items()}

    def record_trade(self, donor_tier: str, receiver_tier: str, n: int) -> None:
        """``n`` ceiling units moved donor -> receiver (negative = a lease
        being returned); both sides' cumulative totals move together so
        conservation is auditable from the snapshot alone."""
        self.tier_borrowed[receiver_tier] = (
            self.tier_borrowed.get(receiver_tier, 0) + int(n))
        self.tier_lent[donor_tier] = self.tier_lent.get(donor_tier, 0) + int(n)

    def forget_replica(self, replica_name: str) -> None:
        self.replica.pop(replica_name, None)

    # -- per-tick roll-up ---------------------------------------------------
    def roll(self, tick_s: float) -> None:
        for tier in self.tiers:
            win = self._window[tier]
            if win.busy_replicas > 0:
                # completion rate per busy replica over control-loop time;
                # only ticks where the tier actually worked update the EWMA
                # (an idle tier's capacity estimate must not decay to zero)
                rate = win.completions / tick_s / win.busy_replicas
                self.tier_rate[tier].update(rate)
                occ = win.busy_replicas / max(win.ready_replicas, 1)
                self.tier_occupancy[tier].update(occ)
            if win.wall_s > 0 and win.useful_tokens > 0:
                self.tier_tokens_per_s[tier].update(win.useful_tokens / win.wall_s)
            admissions = win.prefix_hits + win.prefix_misses
            if admissions > 0:
                self.tier_cache_hit_rate[tier].update(win.prefix_hits / admissions)
            prompt_tokens = win.reused_tokens + win.prefilled_tokens
            if prompt_tokens > 0:
                self.tier_token_reuse[tier].update(win.reused_tokens / prompt_tokens)
            if win.drafted_tokens > 0:
                # acceptance only moves on ticks that actually drafted: an
                # idle (or k=0) tier must not decay the controller's signal
                self.tier_spec_accept[tier].update(
                    win.accepted_tokens / win.drafted_tokens)
            self._window[tier] = _TierWindow()

    # -- the live t_max -----------------------------------------------------
    def measured_t_max(self, nominal: np.ndarray) -> np.ndarray:
        """Per-tier measured per-replica throughput (requests/s).

        The observed completion rate is divided by observed occupancy
        (floored at 0.25) to extrapolate the *capacity* of a partially
        loaded tier; tiers with no measurements yet fall back to their
        nominal profile value.
        """
        out = np.asarray(nominal, dtype=np.float64).copy()
        for i, tier in enumerate(self.tiers):
            rate = self.tier_rate[tier].value
            if rate is None:
                continue
            occ = np.clip(self.tier_occupancy[tier].get(1.0), 0.25, 1.0)
            out[i] = max(rate / occ, 1e-6)
        return out

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {
            tier: {
                "rate_per_replica": self.tier_rate[tier].get(),
                "occupancy": self.tier_occupancy[tier].get(),
                "tokens_per_s": self.tier_tokens_per_s[tier].get(),
                "ttft_s": self.tier_ttft[tier].get(),
                "ttft_p99_s": self.ttft_p99(tier),
                "tpot_s": self.tier_tpot[tier].get(),
                "tpot_p99_s": self.tpot_p99(tier),
                "cache_hit_rate": self.tier_cache_hit_rate[tier].get(),
                "token_reuse_rate": self.tier_token_reuse[tier].get(),
                "page_occupancy": self.tier_page_occupancy[tier].get(),
                "spec_accept_rate": self.tier_spec_accept[tier].get(),
                "drafted_tokens": float(self.tier_drafted[tier]),
                "accepted_tokens": float(self.tier_accepted[tier]),
                "spec_rounds": float(self.tier_spec_rounds[tier]),
                "recovered_tokens": float(self.tier_recovered[tier]),
                "recomputed_prefill_tokens": float(self.tier_recomputed[tier]),
                "kv_flush_s": self.tier_flush_s[tier],
                "kv_flush_tokens": float(self.tier_flush_tokens[tier]),
                "crash_backoffs": float(self.tier_backoffs[tier]),
                "cost_usd": self.tier_cost_usd[tier],
                "billable_replica_s": self.tier_billable_s[tier],
                "cold_starts": float(self.tier_cold_starts[tier]),
                "cold_start_s": self.tier_cold_start_s[tier],
                "warm_promotions": float(self.tier_warm_promotions[tier]),
                "preemptions": float(self.tier_preemptions[tier]),
                "idle_released": float(self.tier_idle_released[tier]),
                "capacity_borrowed": float(self.tier_borrowed[tier]),
                "capacity_lent": float(self.tier_lent[tier]),
            }
            for tier in self.tiers
        }

    def exposition(self) -> str:
        """Prometheus text exposition of the structured metric families."""
        return self.metrics.exposition()
