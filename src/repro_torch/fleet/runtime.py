"""The fleet tick loop: ModeController + Autoscaler + CapacityPool closed
over LIVE ServingEngine replicas.

This is the paper's control loop with the analytic middle removed.  Each
tick (one unit of control-loop time):

  1. workload arrivals enter the dispatcher backlog;
  2. failure injections + capacity events kill replicas (in-flight
     requests are requeued at the front of the backlog);
  3. capacity pools mature/reclaim; replica objects are reconciled against
     the pool (provision → warm → ready; graceful drain on scale-down,
     fail+requeue on forced reclaim);
  4. the controller evaluates the binary step against MEASURED signals —
     the telemetry bus's EWMA of per-replica completion rate stands in for
     Table 1's ``t_max`` column;
  5. the dispatcher places the backlog on concrete replicas per the
     controller weights (spill, hedging, bounded queues);
  6. every live replica pumps one admission+chunk cycle of real decode
     (CUDA-graph steps on the card); completions are recorded per request
     (TTFT/TPOT/retries);
  7. per-tier autoscalers request replicas from their pools against the
     measured per-replica throughput.

Replicas of one tier share ONE ``ServingEngine`` (same weights,
per-replica ``QueueSession`` state), so greedy decoding is token-exact
across replicas and across retries — the failover drill asserts
byte-identical outputs through a mid-decode replica kill.

The port's counterpart of the JAX package's ``fleet/runtime.py``.  It runs
on the same control-loop clock, so one trace through both gives the same
decisions, placements and outputs; only the wall-time fields differ
(``pump_wall_s`` and what derives from it, the telemetry's tokens-per-second
EWMAs and KV flush seconds).  Where it differs, and why:

* ``FleetRuntime(device=)`` (the card by default) builds every tier's
  engine there, and the controller's policy calls run there too.
* Weights are drawn on the host from the tier's ``param_seed``
  (``Model.init_``) and copied to the device, so a fleet on the card and
  one on the CPU serve the same weights.  Tiers with the same (arch, seed,
  overrides) share one model.
* ``warmup`` prepares what the port captures: the decode chunk (with
  speculation off), the mixed-step grid of both chunk budgets and the
  verify grid.  The port has no per-prompt-length trace to warm.  Graphs
  belong to a session, so only the first replica of a tier finds them
  warm; every later replica captures on its first pump, which the tracer
  records as ``engine.capture`` (graphs and host seconds).
* Job tiers (diffusion) are not ported: their arches raise at construction.

    PYTHONPATH=src python -m repro_torch.fleet.runtime --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import policy
from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.core.capacity import CapacityEvent, CapacityPool, synthetic_outage
from repro_torch.core.controller import (ControllerConfig, ModeController,
                                   speculation_k)
from repro_torch.core.deployment import DUProfile
from repro_torch.core.metrics import MetricsLog, RequestLog, RequestRecord, TickRecord
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.fleet.dispatcher import Dispatcher
from repro_torch.fleet.kv_store import KVStore
from repro_torch.fleet.replica import Replica, ReplicaState
from repro_torch.fleet.telemetry import Ewma, TelemetryBus
from repro_torch.fleet.workload import Request
from repro_torch.device import resolve_device
from repro_torch.obs import DecisionRecord, Tracer
from repro_torch.serving.engine import EngineConfig, ServingEngine

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class TierClassSpec:
    """Capacity economics of one procurement class: how a node of this
    class is priced, how long it takes to appear, and whether the provider
    can take it back.

    ``cold_start_median_s = 0`` means "inherit the tier's flat
    ``provision_delay_s``" (the legacy deterministic path); a positive
    ``cold_start_sigma`` makes the delay lognormal around the median
    (sampled per replica from a seeded RNG).  ``preemption_rate`` is the
    expected reclaims per billable replica per MINUTE; reclaims arrive as
    notices with ``preempt_notice_s`` of drain warning, feeding the durable
    KV drain path (``docs/resilience.md``)."""

    name: str
    cost_multiplier: float = 1.0
    cold_start_median_s: float = 0.0
    cold_start_sigma: float = 0.0
    preemption_rate: float = 0.0
    preempt_notice_s: float = 2.0


# the three procurement classes of the elastic-capacity model
# (docs/economics.md): on-demand is the legacy behavior bit-for-bit —
# flat price, flat provision delay, never reclaimed
TIER_CLASSES: Dict[str, TierClassSpec] = {
    "on_demand": TierClassSpec("on_demand"),
    # serverless-like: fast, narrow cold starts; you pay for the privilege
    "serverless": TierClassSpec("serverless", cost_multiplier=2.5,
                                cold_start_median_s=1.0,
                                cold_start_sigma=0.25),
    # spot-like: deep discount, slow heavy-tailed starts, reclaims with
    # notice (the PreemptionEvent drain path fires stochastically)
    "spot": TierClassSpec("spot", cost_multiplier=0.35,
                          cold_start_median_s=4.0, cold_start_sigma=0.5,
                          preemption_rate=0.05, preempt_notice_s=2.0),
}


@dataclass
class TierSpec:
    """One heterogeneous tier: the (arch, hardware-ish, engine-config)
    triplet a DU instantiates, plus its pool dynamics."""

    name: str
    arch: str = "qwen3-0.6b"
    cost_per_hour: float = 1.0
    nominal_t_max: float = 1.0        # req/s bootstrap until telemetry warms
    latency_s: float = 1.0
    max_len: int = 64
    decode_batch: int = 2
    decode_chunk: int = 4
    queue_limit: int = 8
    base_capacity: int = 4
    provision_delay_s: float = 3.0
    initial_replicas: int = 1
    param_seed: int = 0               # SAME seed across tiers => token-exact
                                      # cross-tier retries/spills
    paged_kv: bool = False            # block-based KV + prefix reuse
    page_size: int = 16
    num_pages: int = 0                # 0 => engine auto-sizing
    prefix_reuse: bool = True
    mixed_step: bool = True           # fused prefill+decode engine steps
    prefill_chunk: int = 64           # mixed-step token budget, cost mode
    capacity_prefill_chunk: int = 0   # budget in capacity mode (0 => 4x the
                                      # cost-mode budget): admission-heavy
                                      # load trades TPOT for TTFT when the
                                      # controller is buying throughput
    spec_k: int = 0                   # speculative draft depth (0 = off);
                                      # the CONFIGURED ceiling — the mode
                                      # controller retunes the live value
                                      # between 0 and this every tick
    spec_accept_floor: float = 0.3    # tier acceptance EWMA below which
                                      # the controller drives k -> 0
    model_overrides: Optional[Dict[str, object]] = None
                                      # ModelConfig field overrides applied
                                      # on top of get_config(arch).reduce()
                                      # (dataclasses.replace) — the decode-
                                      # bound benches size the model so the
                                      # wide verify step has real compute
                                      # to amortize
    # -- capacity economics (docs/economics.md) -----------------------------
    tier_class: str = "on_demand"     # TIER_CLASSES key: on_demand /
                                      # serverless / spot
    cold_start_s: Optional[float] = None      # median override (None =>
                                              # class default, which itself
                                              # falls back to
                                              # provision_delay_s)
    cold_start_sigma: Optional[float] = None  # lognormal spread override
    preemption_rate: Optional[float] = None   # reclaims/replica/minute
    preempt_notice_s: Optional[float] = None  # drain warning on reclaim
    warm_pool: int = 0                # standby replicas kept pre-warmed
                                      # (billable, instant promotion)
    min_replicas: int = 0             # floor under the autoscaler (0 keeps
                                      # scale-to-zero, the default)

    def economics(self) -> TierClassSpec:
        """The resolved procurement class: ``tier_class`` defaults with
        this spec's per-field overrides applied, and a zero cold-start
        median resolved to the flat ``provision_delay_s``."""
        try:
            base = TIER_CLASSES[self.tier_class]
        except KeyError:
            raise ValueError(
                f"unknown tier_class {self.tier_class!r} for tier "
                f"{self.name!r}; known: {sorted(TIER_CLASSES)}") from None
        med = self.cold_start_s if self.cold_start_s is not None \
            else (base.cold_start_median_s or self.provision_delay_s)
        return TierClassSpec(
            name=base.name,
            cost_multiplier=base.cost_multiplier,
            cold_start_median_s=med,
            cold_start_sigma=(self.cold_start_sigma
                              if self.cold_start_sigma is not None
                              else base.cold_start_sigma),
            preemption_rate=(self.preemption_rate
                             if self.preemption_rate is not None
                             else base.preemption_rate),
            preempt_notice_s=(self.preempt_notice_s
                              if self.preempt_notice_s is not None
                              else base.preempt_notice_s),
        )

    @property
    def effective_cost_per_hour(self) -> float:
        """$/hr a billable replica actually accrues: the tier's base price
        times its procurement class's multiplier."""
        return self.cost_per_hour * TIER_CLASSES[self.tier_class].cost_multiplier \
            if self.tier_class in TIER_CLASSES else self.cost_per_hour

    def profile(self) -> DUProfile:
        return DUProfile(
            name=self.name,
            model=self.arch,
            hardware=self.name,
            framework="torch-fleet",
            cost_per_hour=self.effective_cost_per_hour,
            t_max=self.nominal_t_max,
            latency_s=self.latency_s,
        )


@dataclass
class FailureEvent:
    """Kill ``count`` ready replicas of ``tier`` at time ``t`` (a crash —
    the pool keeps its ceiling; the autoscaler re-provisions)."""

    t: float
    tier: str
    count: int = 1


@dataclass
class PreemptionEvent:
    """Spot-reclaim NOTICE: at time ``t``, ``count`` ready replicas of
    ``tier`` get ``deadline_s`` of warning before their node disappears.
    Unlike a ``FailureEvent`` crash, the victim drains with the deadline and
    the runtime flushes its in-flight KV frontiers to the fleet store every
    pump — whatever has not finished by the deadline is crash-killed, but
    its decode state survives in the store."""

    t: float
    tier: str
    deadline_s: float = 2.0
    count: int = 1


@dataclass
class FleetConfig:
    tick_s: float = 1.0
    max_ticks: int = 5000
    telemetry_alpha: float = 0.3
    demand_alpha: float = 0.3
    backlog_drain_ticks: float = 10.0  # backlog pressure horizon for demand
    hedge_fraction: float = 0.0
    max_retries: int = 16
    warmup: bool = True               # capture the steps before the tick loop
    seed: int = 0
    # -- durable KV (fleet-global frontier store) ---------------------------
    kv_store: bool = False            # checkpoint decode frontiers fleet-wide
    kv_store_tokens: int = 1 << 16    # store capacity (tokens of frontier KV)
    kv_checkpoint_interval: int = 1   # periodic flush every N ticks (>=1);
                                      # preempting replicas flush EVERY pump
    # -- liveness / crash-loop guard ----------------------------------------
    heartbeat_deadline_s: float = 5.0 # missed-pump death (0 disables)
    crash_backoff_base_s: float = 0.0 # >0 enables exponential re-provision
                                      # backoff after repeated same-tier
                                      # crashes (crash-loop guard)
    crash_backoff_max_s: float = 30.0
    crash_window_s: float = 20.0      # crashes older than this don't count
    # -- forecast-aware autoscaling (docs/economics.md) ---------------------
    forecast: bool = False            # A/B switch: provision ahead of the
                                      # diurnal ramp instead of reacting
    forecast_period_s: float = 0.0    # seasonal cycle length (required > 0
                                      # when forecast=True)
    forecast_buckets: int = 48        # phase resolution of the profile
    forecast_margin: float = 1.15     # provision headroom over prediction
    forecast_lead_s: float = 0.0      # how far ahead to read the profile
                                      # (0 => per tier: cold-start median
                                      # + one tick — exactly the lag a
                                      # provision decision pays)
    # -- cross-model capacity trading (docs/multimodel.md) ------------------
    capacity_trading: bool = False    # let a hot model family borrow pool
                                      # ceiling from an idle one (traced as
                                      # ctl.capacity_trade decisions)
    # -- flight recorder ----------------------------------------------------
    trace: bool = True                # structured event tracing (obs.Tracer)
    trace_capacity: int = 1 << 16     # event ring size (oldest fall off)
    trace_sample: float = 1.0         # decimation for high-frequency events
                                      # (engine.pump, kv.*); lifecycle and
                                      # control-plane events never sample
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    autoscaler: AutoscalerConfig = field(
        default_factory=lambda: AutoscalerConfig(scale_down_stabilization_s=10.0)
    )


@dataclass
class FleetReport:
    outputs: Dict[int, np.ndarray]
    requests: RequestLog
    metrics: MetricsLog
    mode_trace: List[Tuple[float, int]]   # (t, mode) at every change
    telemetry: Dict[str, Dict[str, float]]
    ticks: int
    pump_wall_s: float                    # wall time inside replica pumps
    useful_tokens: int
    wasted_tokens: int
    kv_store: Optional[Dict[str, float]] = None   # durable-KV store snapshot
    # controller decision audit: every mode evaluation that set or changed
    # the mode, with the full signal vector it branched on (each record's
    # ``explains()`` re-derives the decision from its inputs alone)
    decisions: List[DecisionRecord] = field(default_factory=list)

    @property
    def goodput_tokens_per_s(self) -> float:
        """Measured delivered tokens per wall-second of decode work."""
        return self.useful_tokens / self.pump_wall_s if self.pump_wall_s > 0 else 0.0

    def mode_sequence(self) -> List[int]:
        return [m for _, m in self.mode_trace]

    # -- capacity economics (docs/economics.md) -----------------------------
    @property
    def total_cost_usd(self) -> float:
        """Class-priced cost integrated over billable replica-seconds."""
        return self.metrics.total_cost()

    @property
    def usd_per_1k_tokens(self) -> float:
        """The economics bench's headline: dollars per 1000 DELIVERED
        tokens (inf when nothing was delivered)."""
        toks = self.requests.goodput_tokens()
        return 1000.0 * self.total_cost_usd / toks if toks else float("inf")

    def slo_attainment(self, targets: Optional[Dict[str, object]] = None) -> float:
        """Fraction of requests meeting their class's TTFT + latency
        targets (``fleet.workload.SLO_TARGETS`` by default); dropped
        requests count as misses."""
        if targets is None:
            from repro_torch.fleet.workload import SLO_TARGETS
            targets = SLO_TARGETS
        return self.requests.slo_attainment(targets)

    def economics(self) -> Dict[str, Dict[str, float]]:
        """Per-tier cost/elasticity totals (the telemetry snapshot's
        economics slice): cost_usd, billable_replica_s, cold_starts,
        cold_start_s, warm_promotions, preemptions, idle_released."""
        keys = ("cost_usd", "billable_replica_s", "cold_starts",
                "cold_start_s", "warm_promotions", "preemptions",
                "idle_released")
        return {tier: {k: v.get(k, 0.0) for k in keys}
                for tier, v in self.telemetry.items()}

    def summary(self) -> Dict[str, float]:
        s = self.requests.summary()
        s.update(
            ticks=float(self.ticks),
            goodput_tokens_per_s_wall=self.goodput_tokens_per_s,
            wasted_tokens=float(self.wasted_tokens),
            mode_changes=float(max(0, len(self.mode_trace) - 1)),
            total_cost_usd=self.metrics.total_cost(),
            usd_per_1k_tokens=self.usd_per_1k_tokens,
            slo_attainment=self.slo_attainment(),
            recovered_tokens=float(sum(
                v.get("recovered_tokens", 0.0) for v in self.telemetry.values())),
            recomputed_prefill_tokens=float(sum(
                v.get("recomputed_prefill_tokens", 0.0)
                for v in self.telemetry.values())),
        )
        return s


class FleetRuntime:
    """Hosts the replicas and runs the closed control loop."""

    def __init__(self, tiers: Sequence[TierSpec], workload: Sequence[Request],
                 config: Optional[FleetConfig] = None,
                 failures: Sequence[FailureEvent] = (),
                 pool_events: Optional[Dict[str, List[CapacityEvent]]] = None,
                 preemptions: Sequence[PreemptionEvent] = (), *, device=None):
        self.device = resolve_device(device)
        self.tiers = list(tiers)
        self.cfg = config or FleetConfig()
        self.workload = sorted(workload, key=lambda r: r.arrival_t)
        self.failures = sorted(failures, key=lambda f: f.t)
        self.preemptions = sorted(preemptions, key=lambda p: p.t)
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")

        # fail fast on unknown arches (registry lookup raises with the known
        # list) instead of deep inside the first lazy _engine_for call
        from repro_torch.configs import resolve_serving_arch
        for spec in self.tiers:
            resolve_serving_arch(spec.arch)

        if self.cfg.forecast and self.cfg.forecast_period_s <= 0:
            raise ValueError(
                "FleetConfig.forecast=True requires forecast_period_s > 0")

        # capacity economics: resolved procurement class per tier, plus the
        # seeded RNGs behind sampled cold starts and stochastic reclaims
        self._econ: Dict[str, TierClassSpec] = {
            t.name: t.economics() for t in self.tiers}
        self._preempt_rng: Dict[str, np.random.Generator] = {}
        self._cost_rate = 0.0         # $/s accruing (updated every tick)

        self.pools: Dict[str, CapacityPool] = {}
        for i, spec in enumerate(self.tiers):
            pool = CapacityPool(base_capacity=spec.base_capacity,
                                provision_delay_s=spec.provision_delay_s)
            econ = self._econ[spec.name]
            if (econ.cold_start_sigma > 0
                    or econ.cold_start_median_s != spec.provision_delay_s):
                # cold-start model: one sampled delay per replica, drawn
                # from a per-tier seeded RNG and metered into telemetry at
                # sample time; the flat-delay tiers keep the legacy
                # grouped-pending path bit-for-bit
                pool.delay_sampler = self._make_cold_start_sampler(spec, i)
            if econ.preemption_rate > 0:
                self._preempt_rng[spec.name] = np.random.default_rng(
                    [self.cfg.seed, 13, i])
            pool.ready = min(spec.initial_replicas, spec.base_capacity)
            if pool_events and spec.name in pool_events:
                pool.events.extend(pool_events[spec.name])
            self.pools[spec.name] = pool

        # forecast-aware arm: one seasonal forecaster over the arrival EWMA,
        # read ``lead_s`` ahead per tier (cold-start median + one tick, the
        # exact lag a provisioning decision pays)
        self.forecaster = None
        self._lead_s: Dict[str, float] = {}
        if self.cfg.forecast:
            from repro_torch.fleet.forecast import SeasonalForecaster

            self.forecaster = SeasonalForecaster(
                self.cfg.forecast_period_s, buckets=self.cfg.forecast_buckets)
            for spec in self.tiers:
                self._lead_s[spec.name] = (
                    self.cfg.forecast_lead_s
                    or self._econ[spec.name].cold_start_median_s
                    + self.cfg.tick_s)

        self.controller = ModeController([t.profile() for t in self.tiers],
                                         self.cfg.controller, device=self.device)
        self.autoscalers: Dict[str, Autoscaler] = {
            t.name: Autoscaler(0.8 * t.nominal_t_max, self.cfg.autoscaler)
            for t in self.tiers
        }
        for spec in self.tiers:
            self.autoscalers[spec.name].current = self.pools[spec.name].ready
        self.telemetry = TelemetryBus(names, alpha=self.cfg.telemetry_alpha)
        # flight recorder: one tracer on the control-loop clock, shared by
        # every layer (dispatcher, replicas, KV store) — disabled it still
        # exists, so emit sites stay unconditional and the overhead bench
        # measures the same code path in both arms
        self.tracer = (
            Tracer(capacity=self.cfg.trace_capacity,
                   sample=self.cfg.trace_sample, clock=lambda: self.t)
            if self.cfg.trace else Tracer.disabled())
        self.decisions: List[DecisionRecord] = []
        self.dispatcher = Dispatcher(names, max_retries=self.cfg.max_retries,
                                     hedge_fraction=self.cfg.hedge_fraction,
                                     arch_of={t.name: t.arch
                                              for t in self.tiers})
        self.dispatcher.tracer = self.tracer
        # durable KV: the fleet-global frontier store (None = feature off)
        self.kv_store: Optional[KVStore] = (
            KVStore(capacity_tokens=self.cfg.kv_store_tokens,
                    tracer=self.tracer)
            if self.cfg.kv_store else None)
        # missed-pump liveness: replicas beat on every live pump; a wedged
        # process (READY on paper, no beats) is the failure mode only this
        # detector catches — scripted FailureEvents stay as the test hook
        self.heartbeats: Optional[HeartbeatMonitor] = (
            HeartbeatMonitor(deadline_s=self.cfg.heartbeat_deadline_s)
            if self.cfg.heartbeat_deadline_s > 0 else None)

        self._engines: Dict[str, ServingEngine] = {}
        self._model_cache: Dict[Tuple[str, int, tuple], object] = {}
        self.replicas: Dict[str, List[Replica]] = {t.name: [] for t in self.tiers}
        self._replica_counter = 0

        self.t = 0.0
        self.ticks = 0
        self.outputs: Dict[int, np.ndarray] = {}
        self.request_log = RequestLog()
        self.metrics = MetricsLog(du_names=names)
        self.mode_trace: List[Tuple[float, int]] = []
        self._first_token_t: Dict[int, float] = {}
        self._demand = Ewma(self.cfg.demand_alpha)
        # recovery pressure: requeued work the controller should see as
        # demand (a store hit resumes cheaply => weighs 1/4 of a re-prefill)
        self._recovery_rate = Ewma(self.cfg.demand_alpha)
        self._requeue_pressure = 0.0
        # crash-loop guard state
        self._crash_t: Dict[str, List[float]] = {}
        self._hold_until: Dict[str, float] = {}
        self._last_want: Dict[str, int] = {}   # autoscale-change edge detect
        # cross-model capacity trading: the model families present (tier
        # arches + "" for model-agnostic traffic) and the live leases —
        # (receiver_tier, donor_tier) -> replica-ceiling units on loan
        self._models: List[str] = sorted({t.arch for t in self.tiers} | {""})
        self._leases: Dict[Tuple[str, str], int] = {}
        self._spec_k_live: Dict[str, int] = {}  # speculation-change edge detect
        self._backoff_rng = np.random.default_rng(self.cfg.seed + 7)
        # (replica, rid) -> frontier length at last checkpoint (the
        # incremental-flush cursor)
        self._flushed_len: Dict[Tuple[str, int], int] = {}
        self._dispatcher_drops_seen = 0
        self._wl_idx = 0
        self._pump_wall_s = 0.0
        self._useful_tokens = 0
        self._wasted_tokens = 0
        self._warmed = False
        self._nominal = np.array([t.nominal_t_max for t in self.tiers])
        # -- open-loop client surface (repro_torch.fleet.client.FleetClient) -
        self._sinks: List[object] = []        # streaming-event subscribers
        self._injected: List[Request] = []    # submit()-ed, not yet arrived
        self._next_rid = 1 + max((r.rid for r in self.workload), default=-1)

    # -- open-loop client surface --------------------------------------------
    def attach_sink(self, sink) -> None:
        """Subscribe a streaming-event sink (duck-typed: ``on_tokens(rid,
        toks, replica, t)``, ``on_complete(rid, toks, record)``,
        ``on_drop(rid, t, reason)``).  ``FleetClient`` is the canonical
        sink; the closed-trace ``run()`` path works identically with none
        attached."""
        if sink not in self._sinks:
            self._sinks.append(sink)

    def new_rid(self) -> int:
        """A request id no trace or prior submission has used."""
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def submit(self, req: Request) -> None:
        """Open-loop intake: the request enters the dispatcher backlog at
        the next tick (its ``arrival_t`` is stamped to current control-loop
        time) — the facade ``FleetClient.submit`` wraps with a handle."""
        if req.rid >= self._next_rid:
            self._next_rid = req.rid + 1
        req.arrival_t = self.t
        self._injected.append(req)

    def cancel(self, rid: int) -> bool:
        """Withdraw a request wherever it is: not-yet-arrived (trace or
        injected), backlogged, or in flight on replicas (primary + hedge;
        slots and KV pages release immediately).  Returns False when the
        rid is unknown or already completed."""
        hit = False
        pending = self.workload[self._wl_idx:]
        if any(r.rid == rid for r in pending):
            self.workload = (self.workload[:self._wl_idx]
                             + [r for r in pending if r.rid != rid])
            hit = True
        before = len(self._injected)
        self._injected = [r for r in self._injected if r.rid != rid]
        hit = hit or len(self._injected) < before
        d_hit = self.dispatcher.cancel(rid)     # emits req.cancelled itself
        if hit and not d_hit:                   # withdrawn before arrival
            self.tracer.event("req.cancelled", cat="req", rid=rid)
        hit = d_hit or hit
        self._first_token_t.pop(rid, None)
        return hit

    @property
    def busy(self) -> bool:
        return self._busy()

    # -- engines / replicas --------------------------------------------------
    def _engine_for(self, spec: TierSpec) -> ServingEngine:
        if spec.name not in self._engines:
            import dataclasses

            import torch

            from repro_torch.configs import get_config
            from repro_torch.models import Model

            overrides = dict(spec.model_overrides or {})
            mkey = (spec.arch, spec.param_seed,
                    tuple(sorted(overrides.items())))
            if mkey not in self._model_cache:
                cfg = get_config(spec.arch).reduce()
                if overrides:
                    cfg = dataclasses.replace(cfg, **overrides)
                # drawn on the host from the tier's seed, then copied over:
                # the same weights on every device
                model = Model(cfg, device="cpu").init_(
                    torch.Generator().manual_seed(spec.param_seed))
                if self.device.type != "cpu":
                    host, model = model, Model(cfg, device=self.device)
                    model.load_state_dict(host.state_dict())
                self._model_cache[mkey] = model
            model = self._model_cache[mkey]
            self._engines[spec.name] = ServingEngine(
                model,
                EngineConfig(max_len=spec.max_len,
                             decode_batch=spec.decode_batch,
                             temperature=0.0,
                             decode_chunk=spec.decode_chunk,
                             mixed_step=spec.mixed_step,
                             prefill_chunk=spec.prefill_chunk,
                             paged_kv=spec.paged_kv,
                             page_size=spec.page_size,
                             num_pages=spec.num_pages,
                             prefix_reuse=spec.prefix_reuse,
                             spec_k=spec.spec_k),
                device=self.device,
            )
        return self._engines[spec.name]

    def _make_cold_start_sampler(self, spec: TierSpec, idx: int):
        """Per-tier cold-start delay sampler (deterministic: seeded from
        ``(cfg.seed, tier index)``).  Each draw is one replica's
        provisioning delay — lognormal around the class median, degenerate
        when sigma is 0 — metered into telemetry and the flight recorder
        at sample time (when the provision DECISION is made)."""
        econ = self._econ[spec.name]
        rng = np.random.default_rng([self.cfg.seed, 11, idx])
        log_med = float(np.log(max(econ.cold_start_median_s, 1e-9)))

        def sample() -> float:
            if econ.cold_start_sigma > 0:
                d = float(rng.lognormal(log_med, econ.cold_start_sigma))
            else:
                d = float(econ.cold_start_median_s)
            self.telemetry.record_cold_start(spec.name, d)
            self.tracer.event("replica.cold_start", cat="ctl",
                              tier=spec.name, delay_s=d, klass=econ.name)
            return d

        return sample

    def _new_replica(self, spec: TierSpec) -> Replica:
        self._replica_counter += 1
        rep = Replica(f"{spec.name}/r{self._replica_counter}", spec.name,
                      self._engine_for(spec), queue_limit=spec.queue_limit)
        rep.tracer = self.tracer
        if self.heartbeats is not None:
            rep.attach_heartbeat(self.heartbeats, self._replica_counter)
        return rep

    def _fail_replica(self, rep: Replica, *, crash: bool = False) -> None:
        rids = rep.fail()
        if self.heartbeats is not None and rep._hb_id is not None:
            self.heartbeats.forget(rep._hb_id)
        requeued, dropped = self.dispatcher.on_failure(rep, rids)
        for req in requeued:
            # tokens the dead replica emitted never reached the client:
            # the retry's first token defines TTFT, not the lost one.
            # A request that already emitted one has a COMPLETED prefill
            # behind it — its retry's prefill (absent a store hit) is
            # recomputation of paid-for work, and is billed as such.
            if req.rid in self._first_token_t:
                req.prefilled_once = True
            self._first_token_t.pop(req.rid, None)
            if self.kv_store is not None:
                fr = self.kv_store.get(req.token_key())
                if fr is not None:
                    req.frontier = fr
                    self.tracer.event("ctl.kv_restore", rid=req.rid,
                                      tokens=fr.tokens, at="requeue")
            self._requeue_pressure += 0.25 if req.frontier is not None else 1.0
        for req in dropped:
            self.request_log.dropped.append(req.rid)
            self._first_token_t.pop(req.rid, None)
            reason = self.dispatcher.drop_reasons.get(req.rid, "")
            for sink in self._sinks:
                sink.on_drop(req.rid, self.t, reason)
        self.telemetry.forget_replica(rep.name)
        for key in [k for k in self._flushed_len if k[0] == rep.name]:
            del self._flushed_len[key]
        if crash and self.cfg.crash_backoff_base_s > 0:
            self._note_crash(rep.tier)

    def _note_crash(self, tier: str) -> None:
        """Crash-loop guard: repeated crashes of one tier inside the window
        exponentially back off NEW provisions (with jitter, so tiers don't
        re-provision in lockstep).  First crash in a window is free — one
        spot reclaim is normal life, a streak is a sick tier/image."""
        t = self.t
        hist = self._crash_t.setdefault(tier, [])
        hist.append(t)
        hist[:] = [x for x in hist if t - x <= self.cfg.crash_window_s]
        if len(hist) < 2:
            return
        backoff = min(self.cfg.crash_backoff_base_s * 2.0 ** (len(hist) - 2),
                      self.cfg.crash_backoff_max_s)
        backoff *= 1.0 + 0.5 * float(self._backoff_rng.random())
        self._hold_until[tier] = max(self._hold_until.get(tier, 0.0),
                                     t + backoff)
        self.telemetry.record_backoff(tier)
        self.tracer.event("ctl.crash_backoff", tier=tier,
                          crashes=len(hist), hold_until=self._hold_until[tier])

    def _flush_replica(self, tier: str, rep: Replica) -> None:
        """Checkpoint decoding frontiers on ``rep`` into the fleet KV store
        (the periodic durability flush, and the preemption drain).

        Incremental: a frontier is re-extracted only when it crossed a page
        boundary since its last checkpoint — extraction is a device->host
        copy of the WHOLE frontier, so flushing every token would cost more
        than the re-prefill it saves.  A preempting replica flushes
        unconditionally (last chance), and every request's FIRST decode
        checkpoint always lands, so a victim never re-prefills; at most a
        partial page of cheap decode is replayed."""
        if self.kv_store is None or rep.session is None or rep.wedged:
            return
        t0 = time.perf_counter()
        accepted = 0
        al = rep.session.allocator
        ps = al.page_size if al is not None else 1
        for rid, n in rep.session.decoding_lens().items():
            key = (rep.name, rid)
            last = self._flushed_len.get(key, -1)
            if not rep.preempting and last >= 0 and n // ps <= last // ps:
                continue
            fr = rep.session.extract_frontier(rid)
            if fr is None:
                continue
            self._flushed_len[key] = fr.tokens
            if self.kv_store.put(fr):
                accepted += fr.tokens
        self.telemetry.record_flush(tier, time.perf_counter() - t0, accepted)
        if accepted:
            self.tracer.event("ctl.kv_flush", replica=rep.name, tier=tier,
                              tokens=accepted,
                              preempting=bool(rep.preempting))

    def _preempt(self, spec: TierSpec, rep: Replica, deadline_t: float) -> None:
        """One spot reclaim against ``rep`` (scripted ``PreemptionEvent``s
        and the stochastic per-tick hazard share this path).

        A victim carrying live requests gets the full notice machinery:
        drain to the deadline, KV flush every pump, proactive pool
        re-provision.  An IDLE victim — a warm-pool standby (WARMING) or a
        ready replica with zero live requests — has nothing to drain: it
        releases its node immediately, with no ``ctl.preempt_notice``, no
        KV flush, and no ``req.requeued`` traces (there are no requests to
        requeue, so emitting any would corrupt the request chains)."""
        pool = self.pools[spec.name]
        idle = rep.state == ReplicaState.WARMING or rep.load == 0
        self.telemetry.record_preemption(spec.name, idle=idle)
        if idle:
            if rep.state == ReplicaState.READY:
                pool.ready = max(0, pool.ready - 1)
            elif pool.release_standby(1) == 0:
                # a warming replica that is NOT standby stock mirrors an
                # in-flight provision — cancel the newest cold start so the
                # pipeline stays consistent with the replica set
                pool.cancel_pending(1)
            self.tracer.event("ctl.preempt_idle", tier=spec.name,
                              replica=rep.name, state=rep.state.value)
            rep.release()
            self.telemetry.forget_replica(rep.name)
            return
        self.tracer.event("ctl.preempt_notice", tier=spec.name,
                          replica=rep.name, deadline=deadline_t)
        rep.preempt(deadline_t)
        self._flush_replica(spec.name, rep)
        pool.ready = max(0, pool.ready - 1)

    # -- pool<->replica reconciliation ---------------------------------------
    def _reconcile(self, spec: TierSpec) -> None:
        pool = self.pools[spec.name]
        reps = self.replicas[spec.name]
        reps[:] = [r for r in reps if r.state not in
                   (ReplicaState.FAILED, ReplicaState.TERMINATED)]

        # warming set mirrors the pool's provisioning pipeline PLUS the
        # warm standby stock (a standby holds a node — billable — without
        # taking traffic, which is exactly the WARMING state)
        warming = [r for r in reps if r.state in
                   (ReplicaState.PROVISIONING, ReplicaState.WARMING)]
        warm_target = pool.inflight + pool.warm + pool.warm_inflight
        while len(warming) < warm_target:
            rep = self._new_replica(spec)
            rep.warm()
            warming.append(rep)
            reps.append(rep)
        while len(warming) > warm_target:
            victim = warming.pop()        # newest request cancelled first
            victim.drain()                # warming drain == terminate

        # ready set mirrors pool.ready
        ready = [r for r in reps if r.state == ReplicaState.READY]
        while len(ready) < pool.ready:
            if warming:
                rep = warming.pop(0)      # oldest provision matures first
            else:                         # bootstrap replicas (pool seeded)
                rep = self._new_replica(spec)
                reps.append(rep)
            rep.activate(self.t)
            ready.append(rep)
        if len(ready) > pool.ready:
            excess = len(ready) - pool.ready
            forced = pool.capacity_at(self.t) < len(ready)
            if forced:                    # reclaim: kill mid-decode, requeue
                for rep in ready[-excess:]:
                    self._fail_replica(rep)
            else:                         # scale-down: graceful drain
                for rep in sorted(ready, key=lambda r: r.load)[:excess]:
                    rep.drain()
        reps[:] = [r for r in reps if r.state not in
                   (ReplicaState.FAILED, ReplicaState.TERMINATED)]

    # -- one tick ------------------------------------------------------------
    def tick(self) -> None:
        t, cfg = self.t, self.cfg

        # 1. arrivals (trace requests due now + open-loop submissions)
        arrived: List[Request] = []
        while (self._wl_idx < len(self.workload)
               and self.workload[self._wl_idx].arrival_t <= t):
            arrived.append(self.workload[self._wl_idx])
            self._wl_idx += 1
        arrived.extend(self._injected)
        self._injected = []
        if self.kv_store is not None:
            # fleet-global second tier behind the per-replica prefix caches:
            # a fresh arrival whose exact prompt was checkpointed (an earlier
            # victim, or a twin request) resumes from the stored frontier
            for req in arrived:
                if req.frontier is None:
                    req.frontier = self.kv_store.get(req.token_key())
                    if req.frontier is not None:
                        self.tracer.event("ctl.kv_restore", rid=req.rid,
                                          tokens=req.frontier.tokens,
                                          at="arrival")
        for req in arrived:
            self.tracer.event("req.queued", t=req.arrival_t, cat="req",
                              rid=req.rid, prompt_len=req.prompt_len,
                              max_new=req.max_new, slo=req.slo_class,
                              model=req.model)
        self.dispatcher.submit(arrived)
        arrival_rate = len(arrived) / cfg.tick_s
        backlog_pressure = len(self.dispatcher.backlog) / (
            cfg.backlog_drain_ticks * cfg.tick_s
        )
        demand = self._demand.update(arrival_rate) + backlog_pressure
        # per-model demand signals (arrivals + backlog attributed to the
        # arch a request targets; "" = model-agnostic) — what the capacity
        # trader reads to decide which family is idle and which is hot
        arrived_by_model: Dict[str, int] = {}
        for req in arrived:
            arrived_by_model[req.model] = arrived_by_model.get(req.model, 0) + 1
        backlog_by_model: Dict[str, int] = {}
        for req in self.dispatcher.backlog:
            backlog_by_model[req.model] = backlog_by_model.get(req.model, 0) + 1
        for m in self._models:
            self.telemetry.record_model_demand(
                m,
                arrived_by_model.get(m, 0) / cfg.tick_s
                + backlog_by_model.get(m, 0)
                / (cfg.backlog_drain_ticks * cfg.tick_s))
        # recovery pressure: requeued work is demand the arrival EWMA never
        # saw — fold it in so the controller buys capacity for retries too
        recovery = self._recovery_rate.update(self._requeue_pressure / cfg.tick_s)
        self._requeue_pressure = 0.0
        if self.kv_store is not None:
            demand += recovery

        # 2. failure injections (crashes: pool ceiling unchanged)
        while self.failures and self.failures[0].t <= t:
            ev = self.failures.pop(0)
            victims = [r for r in self.replicas[ev.tier]
                       if r.state == ReplicaState.READY][-ev.count:]
            for rep in victims:
                self.tracer.event("ctl.replica_fail", tier=ev.tier,
                                  replica=rep.name, cause="injected_crash")
                self._fail_replica(rep, crash=True)
                pool = self.pools[ev.tier]
                pool.ready = max(0, pool.ready - 1)

        # 2b. preemption notices: victim drains with a deadline; its KV
        # flushes to the store at notice and on every pump until the kill.
        # pool.ready drops NOW so the autoscaler re-provisions proactively —
        # the whole point of a notice.  (Idle victims skip the machinery
        # and just release — see _preempt.)
        specs = {s.name: s for s in self.tiers}
        while self.preemptions and self.preemptions[0].t <= t:
            ev = self.preemptions.pop(0)
            victims = [r for r in self.replicas[ev.tier]
                       if r.state == ReplicaState.READY][-ev.count:]
            for rep in victims:
                self._preempt(specs[ev.tier], rep, t + ev.deadline_s)

        # 2b'. stochastic spot reclaims: every up node of a spot-class tier
        # (ready replicas + warm standbys) faces an independent per-tick
        # hazard of preemption_rate/min, drawn from a per-tier seeded RNG —
        # the deterministic-under-seed model of a provider taking its
        # discount hardware back
        for spec in self.tiers:
            rng = self._preempt_rng.get(spec.name)
            if rng is None:
                continue
            econ = self._econ[spec.name]
            p = min(1.0, econ.preemption_rate / 60.0 * cfg.tick_s)
            reps = self.replicas[spec.name]
            candidates = [r for r in reps
                          if r.state == ReplicaState.READY and not r.preempting]
            candidates += [r for r in reps
                           if r.state == ReplicaState.WARMING
                           ][:self.pools[spec.name].warm]
            for rep in candidates:
                if float(rng.random()) < p:
                    self._preempt(spec, rep, t + econ.preempt_notice_s)

        # 2c. expired preemption deadlines: final flush, then the node is
        # gone — whatever didn't finish draining dies like a crash (but its
        # frontiers are in the store, so the retry resumes, not re-prefills)
        for spec in self.tiers:
            for rep in list(self.replicas[spec.name]):
                if rep.preempting and t >= rep.preempt_deadline:
                    self.tracer.event("ctl.preempt_deadline", tier=spec.name,
                                      replica=rep.name)
                    self._flush_replica(spec.name, rep)
                    self._fail_replica(rep)

        # 2d. missed-pump deaths: a replica that stopped beating past the
        # deadline is a hung process — kill and requeue like a crash
        if self.heartbeats is not None:
            dead = set(self.heartbeats.dead(t))
            if dead:
                for spec in self.tiers:
                    for rep in list(self.replicas[spec.name]):
                        if rep._hb_id in dead and rep.live:
                            dead.discard(rep._hb_id)
                            self.tracer.event(
                                "ctl.wedge_death", tier=spec.name,
                                replica=rep.name, wedged=bool(rep.wedged))
                            if rep.state == ReplicaState.READY:
                                pool = self.pools[spec.name]
                                pool.ready = max(0, pool.ready - 1)
                            self._fail_replica(rep, crash=True)
                for hb_id in dead:    # stale ids of already-gone replicas
                    self.heartbeats.forget(hb_id)

        # 3. capacity dynamics + reconcile
        for spec in self.tiers:
            self.pools[spec.name].tick(t)
            self._reconcile(spec)
            n_ready = sum(1 for r in self.replicas[spec.name]
                          if r.state == ReplicaState.READY)
            self.telemetry.record_ready(spec.name, n_ready)

        # 4. controller against MEASURED signals
        pool_cap = np.array([self.pools[s.name].capacity_at(t) for s in self.tiers])
        requested = np.array([self.autoscalers[s.name].current for s in self.tiers],
                             dtype=np.int64)
        measured = self.telemetry.measured_t_max(self._nominal)
        decision = self.controller.step(t, demand, requested, pool_cap,
                                        measured_t_max=measured,
                                        cost_rate=self._cost_rate)
        if not self.mode_trace or self.mode_trace[-1][1] != decision.mode:
            self.mode_trace.append((t, decision.mode))
            # audit: the mode changed (or was first set) — record the full
            # signal vector the step branched on, so the decision stays
            # explainable from the log alone (FleetReport.decisions)
            rec = DecisionRecord(
                t=t, prev_mode=int(decision.prev_mode),
                mode=int(decision.mode), switched=bool(decision.switched),
                demand=float(decision.demand_seen),
                tiers=tuple(s.name for s in self.tiers),
                pool=tuple(int(x) for x in pool_cap),
                requested=tuple(int(x) for x in requested),
                measured_t_max=tuple(float(x) for x in decision.t_max_used),
                tentative=tuple(int(x) for x in decision.tentative),
                cap_violated=bool(decision.cap_violated),
                supply_possible=float(decision.supply_possible),
                hold_supply=float(decision.hold_supply),
                hysteresis_margin=float(self.cfg.controller.hysteresis_margin),
                weights=tuple(float(x) for x in decision.weights),
                cost_rate=float(decision.cost_rate),
            )
            self.decisions.append(rec)
            self.tracer.event("ctl.mode_switch", mode=rec.mode,
                              prev_mode=rec.prev_mode, reason=rec.reason(),
                              **rec.signals())

        # 4b. mode drives the mixed-step chunk budget: capacity mode buys
        # admission throughput (whole prompts per step => TTFT down, TPOT
        # up); cost mode keeps prefill trickling around steady decode.
        # Live retune — the budget only picks the pow-2 trace bucket.
        for spec in self.tiers:
            if not spec.mixed_step:
                continue
            budget = (spec.capacity_prefill_chunk or 4 * spec.prefill_chunk
                      if decision.mode == policy.CAPACITY_OPTIMIZED
                      else spec.prefill_chunk)
            for rep in self.replicas[spec.name]:
                rep.set_chunk_budget(budget)

        # 4c. mode + measured acceptance drive the speculation depth:
        # capacity mode (or an acceptance EWMA under the tier floor) means
        # rejected drafts would burn step capacity admission needs, so the
        # controller shrinks k to 0 — speculation never costs goodput under
        # pressure.  Live retune like the chunk budget (pow-2 spec-quantum
        # buckets, prepared by warmup).
        for spec in self.tiers:
            if not spec.mixed_step:
                continue
            accept = self.telemetry.tier_spec_accept[spec.name].value
            k = speculation_k(decision.mode, spec.spec_k, accept,
                              spec.spec_accept_floor)
            # a spec-disabled tier is still COMMANDED k=0 every tick: its
            # sessions may ride an engine whose config carries a nonzero
            # default (benches share one engine across A/B arms),
            # and the controller owns the knob either way
            if spec.spec_k > 0 and self._spec_k_live.get(spec.name) != k:
                self._spec_k_live[spec.name] = k
                self.tracer.event(
                    "ctl.speculation", cat="ctl", tier=spec.name, k=k,
                    mode=int(decision.mode),
                    accept_rate=(round(accept, 4)
                                 if accept is not None else None))
            for rep in self.replicas[spec.name]:
                rep.set_speculation(k)

        # 5. request-granularity dispatch
        self.dispatcher.dispatch(decision.weights, self.replicas, now=t)
        # requests the dispatcher dropped as unfittable (they fit no live
        # replica's engine/page budget) must reach the request log too —
        # replica-failure drops are already logged via _fail_replica
        new_drops = self.dispatcher.dropped[self._dispatcher_drops_seen:]
        self._dispatcher_drops_seen = len(self.dispatcher.dropped)
        for req in new_drops:
            if req.rid not in self.request_log.dropped:
                self.request_log.dropped.append(req.rid)
                self._first_token_t.pop(req.rid, None)
                reason = self.dispatcher.drop_reasons.get(req.rid, "")
                for sink in self._sinks:
                    sink.on_drop(req.rid, t, reason)

        # 6. pump every live replica one admission+chunk cycle
        completions_per_tier = {s.name: 0 for s in self.tiers}
        latency_sum = {s.name: 0.0 for s in self.tiers}
        occ_sum = {s.name: 0.0 for s in self.tiers}
        occ_n = {s.name: 0 for s in self.tiers}
        for spec in self.tiers:
            for rep in list(self.replicas[spec.name]):
                traces_before = rep.engine.mixed_traces
                caps_before = rep.engine.captures
                report = rep.pump(now=t)
                traces_after = rep.engine.mixed_traces
                if traces_after > traces_before:
                    # a measured pump met a step bucket warmup did not
                    # prepare (warmup should prevent it)
                    self.tracer.event("engine.compile", cat="engine",
                                      replica=rep.name, tier=spec.name,
                                      new_traces=traces_after - traces_before)
                caps_after = rep.engine.captures
                if caps_after[0] > caps_before[0]:
                    # graphs belong to a session: a replica captures its
                    # steps on its first pumps (wall time, not loop time)
                    self.tracer.event("engine.capture", cat="engine",
                                      replica=rep.name, tier=spec.name,
                                      graphs=caps_after[0] - caps_before[0],
                                      capture_s=caps_after[1] - caps_before[1])
                # periodic durability checkpoint (every pump while a
                # preemption notice is live — the drain must win the race
                # against the deadline)
                if self.kv_store is not None and rep.session is not None and (
                    rep.preempting
                    or self.ticks % max(1, cfg.kv_checkpoint_interval) == 0
                ):
                    self._flush_replica(spec.name, rep)
                if report is None:
                    continue
                self._pump_wall_s += report.wall_s
                self._useful_tokens += report.useful_tokens
                self._wasted_tokens += report.wasted_tokens
                self.tracer.event("engine.pump", cat="engine", sampled=True,
                                  replica=rep.name, tier=spec.name,
                                  wall_s=report.wall_s,
                                  admit_s=report.admit_s,
                                  dispatch_s=report.dispatch_s,
                                  sync_s=report.sync_s,
                                  occupancy=report.occupancy,
                                  completed=len(report.completed))
                if getattr(report, "spec_rounds", 0):
                    # speculation audit rides next to the pump it happened
                    # in: drafted/accepted per replica-tick is the raw
                    # series behind the tier acceptance EWMA
                    self.tracer.event("engine.speculate", cat="engine",
                                      sampled=True, replica=rep.name,
                                      tier=spec.name,
                                      drafted=report.drafted_tokens,
                                      accepted=report.accepted_tokens,
                                      rounds=report.spec_rounds)
                qd = rep.load
                self.telemetry.record_pump(spec.name, rep.name, report, qd)
                if rep.state == ReplicaState.READY:
                    occ_sum[spec.name] += report.occupancy
                    occ_n[spec.name] += 1
                for rid, toks in report.tokens.items():
                    # the TRUE first-token stamp: the tick the token was
                    # actually emitted, not inferred from the completion
                    if rid not in self._first_token_t:
                        self._first_token_t[rid] = t + cfg.tick_s
                        self.tracer.event("req.first_token",
                                          t=t + cfg.tick_s, cat="req",
                                          rid=rid, replica=rep.name,
                                          tier=spec.name)
                    for sink in self._sinks:
                        sink.on_tokens(rid, toks, rep.name, t + cfg.tick_s)
                for rid, toks in report.completed.items():
                    self._complete(rid, toks, rep, spec,
                                   completions_per_tier, latency_sum)
        self.telemetry.roll(cfg.tick_s)

        # 7. autoscaling toward the weighted share of measured demand — or,
        # in the forecast arm, of the seasonal prediction read one
        # provisioning-lag ahead (so replicas are READY when the ramp
        # arrives, not requested when it is already here)
        if self.forecaster is not None:
            self.forecaster.observe(t, self._demand.get())
            self.tracer.event("ctl.forecast",
                              observed=round(self._demand.get(), 4),
                              predicted=round(self.forecaster.peek(t), 4),
                              ready=self.forecaster.ready)
        wants: Dict[str, int] = {}
        for i, spec in enumerate(self.tiers):
            a = self.autoscalers[spec.name]
            a.target_metric_value = max(0.8 * float(measured[i]), 1e-6)
            share = float(decision.weights[i])
            # provision for the WORST of the lead window, not a point read:
            # capacity bought now covers [now, now+lead], and a point read
            # would scale down into every local dip of the profile
            pred = (self.forecaster.predict_max(t, t + self._lead_s[spec.name])
                    if self.forecaster is not None else None)
            if pred is not None:
                # provision for predicted arrivals (with headroom) or the
                # LIVE demand signal, whichever is larger: the forecast
                # only ever adds capacity ahead of the ramp, never starves
                # real queued work below what reactive scaling would buy.
                # The floor signal is already smooth where it matters, so
                # the reactive stabilization hold would only re-add the
                # scale-down lag the forecast exists to remove.  Backlog and
                # recovery pressure (demand minus the bare arrival EWMA) ride
                # ON TOP of the prediction: queued work is real even when the
                # profile says the hour should be quiet
                pressure = demand - self._demand.get()
                eff = max(cfg.forecast_margin * pred + pressure, demand)
                want = a.track(t, share * eff)
            else:
                # reactive arm (and the forecast arm's whole first cycle,
                # before the profile exists)
                want = a.desired(t, share * demand)
            want = max(want, spec.min_replicas)
            pool = self.pools[spec.name]
            if t < self._hold_until.get(spec.name, 0.0):
                # crash-loop hold: keep what exists, provision nothing new
                want = min(want, pool.ready + pool.inflight)
            wants[spec.name] = int(want)
        if cfg.capacity_trading:
            # cross-model capacity trading: move pool ceiling from an idle
            # model family to one scaling into its cap (docs/multimodel.md)
            self._trade_capacity(t, wants)
        for i, spec in enumerate(self.tiers):
            want = wants[spec.name]
            pool = self.pools[spec.name]
            if want != self._last_want.get(spec.name):
                self.tracer.event("ctl.scale", tier=spec.name, want=int(want),
                                  prev=self._last_want.get(spec.name),
                                  ready=int(pool.ready),
                                  inflight=int(pool.inflight))
                self._last_want[spec.name] = int(want)
            promoted = pool.request(t, want)
            if promoted:
                # warm standbys answered the scale-up instantly (no cold
                # start) — the TTFT the warm pool's standby cost bought
                self.telemetry.record_warm_promotion(spec.name, promoted)
                self.tracer.event("ctl.warm_pool", tier=spec.name,
                                  action="promote", n=int(promoted),
                                  warm=int(pool.warm))
            started = pool.stock_warm(t, spec.warm_pool)
            if started:
                self.tracer.event("ctl.warm_pool", tier=spec.name,
                                  action="stock", n=int(started),
                                  warm=int(pool.warm),
                                  warm_inflight=int(pool.warm_inflight))

        # 8. metrics
        names = [s.name for s in self.tiers]
        ready = np.array([sum(1 for r in self.replicas[n]
                              if r.state == ReplicaState.READY) for n in names])
        served = np.array([completions_per_tier[n] / cfg.tick_s for n in names])
        lat = np.array([
            latency_sum[n] / completions_per_tier[n]
            if completions_per_tier[n] else 0.0 for n in names
        ])
        util = np.array([occ_sum[n] / occ_n[n] if occ_n[n] else 0.0
                         for n in names])
        billable = np.array([sum(1 for r in self.replicas[n] if r.billable)
                             for n in names])
        rates = np.array([s.effective_cost_per_hour for s in self.tiers])
        cost_rate = float(np.sum(billable * rates) / 3600.0)
        self._cost_rate = cost_rate
        for i, n in enumerate(names):
            self.telemetry.record_cost(
                n, int(billable[i]),
                float(billable[i] * rates[i]) / 3600.0, cfg.tick_s)
        self.metrics.append(TickRecord(
            t=t, demand_rps=demand, mode=int(decision.mode),
            weights=decision.weights.copy(), ready=ready, served_rps=served,
            dropped_rps=0.0, latency_s=lat, utilization=util,
            cost_rate=cost_rate,
        ))
        self.t += cfg.tick_s
        self.ticks += 1

    def _trade_capacity(self, t: float, wants: Dict[str, int]) -> None:
        """Cross-model capacity trading: lease pool-ceiling units from a
        tier whose model family is idle to a tier of ANOTHER family that is
        scaling into its cap (a diffusion burst borrowing nodes from the
        overnight-idle LLM pool, and vice versa).

        A lease moves ``base_capacity`` between pools — the fleet's total
        obtainable-replica budget is conserved — and is RETURNED as soon as
        the receiver no longer needs the headroom, so each family's
        nominal ceiling is a steady-state invariant, not a ratchet.  Trades
        branch on the per-model demand EWMAs the telemetry bus aggregates
        (a donor must be measurably colder than the receiver), and every
        lease/return is traced as a ``ctl.capacity_trade`` decision."""
        arch = {s.name: s.arch for s in self.tiers}

        def spare(name: str) -> int:
            # ceiling units a tier provably is not using and will not use
            # this tick: cap minus the larger of its want and its up/in-
            # flight node count (so shrinking by `spare` never clips a
            # live replica into a forced reclaim)
            p = self.pools[name]
            used = max(wants.get(name, 0),
                       p.ready + p.inflight + p.warm + p.warm_inflight)
            return p.capacity_at(t) - used

        # 1. return leases the receiver no longer needs (LIFO per lease)
        for (recv, donor), n in list(self._leases.items()):
            back = min(n, spare(recv))
            if back <= 0:
                continue
            self.pools[recv].base_capacity -= back
            self.pools[donor].base_capacity += back
            left = n - back
            if left:
                self._leases[(recv, donor)] = left
            else:
                del self._leases[(recv, donor)]
            self.telemetry.record_trade(donor, recv, -back)
            self.tracer.event("ctl.capacity_trade", action="return",
                              tier=recv, donor=donor, n=int(back),
                              model=arch[recv], donor_model=arch[donor])

        # 2. new borrows: deficit tiers take from the coldest other-model
        # donor first
        for spec in self.tiers:
            pr = self.pools[spec.name]
            if pr.capacity_at(t) < pr.base_capacity:
                continue      # externally capped (outage/limit event) —
                              # extra base ceiling could not be used anyway
            deficit = wants[spec.name] - pr.capacity_at(t)
            if deficit <= 0:
                continue
            my_demand = self.telemetry.model_demand(arch[spec.name])
            donors = sorted(
                (d for d in self.tiers
                 if d.arch != arch[spec.name] and spare(d.name) > 0
                 and self.telemetry.model_demand(d.arch) < my_demand),
                key=lambda d: self.telemetry.model_demand(d.arch))
            for dspec in donors:
                n = min(deficit, spare(dspec.name))
                if n <= 0:
                    continue
                self.pools[dspec.name].base_capacity -= n
                pr.base_capacity += n
                key = (spec.name, dspec.name)
                self._leases[key] = self._leases.get(key, 0) + n
                deficit -= n
                self.telemetry.record_trade(dspec.name, spec.name, n)
                self.tracer.event(
                    "ctl.capacity_trade", action="borrow", tier=spec.name,
                    donor=dspec.name, n=int(n), model=arch[spec.name],
                    donor_model=arch[dspec.name],
                    demand=round(my_demand, 4),
                    donor_demand=round(
                        self.telemetry.model_demand(arch[dspec.name]), 4))
                if deficit <= 0:
                    break

    def _complete(self, rid: int, toks: np.ndarray, rep: Replica,
                  spec: TierSpec, completions_per_tier: Dict[str, int],
                  latency_sum: Dict[str, float]) -> None:
        entry = self.dispatcher.on_complete(rid, rep)
        if entry is None:
            return                        # hedge twin after the winner
        req, source = entry
        complete_t = self.t + self.cfg.tick_s
        first_t = self._first_token_t.pop(rid, complete_t)
        rec = RequestRecord(
            rid=rid, arrival_t=req.arrival_t, first_token_t=first_t,
            complete_t=complete_t, prompt_len=req.prompt_len,
            tokens=int(toks.size), retries=req.retries,
            tier=source.tier, replica=source.name, slo_class=req.slo_class,
        )
        self.request_log.append(rec)
        self.outputs.setdefault(rid, toks)
        self.tracer.event("req.completed", t=complete_t, cat="req", rid=rid,
                          replica=source.name, tier=source.tier,
                          tokens=rec.tokens, ttft_s=rec.ttft_s,
                          tpot_s=rec.tpot_s, retries=req.retries,
                          model=req.model)
        self.telemetry.record_completion(source.tier, source.name,
                                         rec.ttft_s, rec.tpot_s, rec.tokens)
        completions_per_tier[spec.name] += 1
        latency_sum[spec.name] += rec.latency_s
        for sink in self._sinks:
            sink.on_complete(rid, toks, rec)

    # -- drive to completion -------------------------------------------------
    def warmup(self) -> None:
        """Prepare every tier's steps outside the measured run: the decode
        chunk with speculation off (the controller drives the live depth
        between 0 and the tier's ceiling), the mixed-step grid of both
        chunk budgets (one Q quantum per budget x every pow-2 attention
        window), and the verify grid of a speculating tier.  On the card
        they are captured into the state the tier's next session takes, so
        no measured pump of that replica captures; on the CPU they run once
        and register their buckets, as the JAX warmup compiles its traces."""
        if self._warmed:
            return
        for spec in self.tiers:
            eng = self._engine_for(spec)
            eng.warm_decode()
            if eng.mixed:
                budgets = [spec.prefill_chunk,
                           spec.capacity_prefill_chunk or 4 * spec.prefill_chunk]
                eng.warm_mixed_traces(budgets)
                if spec.spec_k > 0:
                    eng.warm_spec_traces([spec.spec_k])
        self._warmed = True

    def _busy(self) -> bool:
        if (self._wl_idx < len(self.workload) or self._injected
                or not self.dispatcher.quiet):
            return True
        return any(r.load > 0 for reps in self.replicas.values() for r in reps)

    def report(self) -> FleetReport:
        """Snapshot the run so far as a ``FleetReport`` (what ``run()``
        returns; open-loop clients can take one at any point)."""
        return FleetReport(
            outputs=self.outputs,
            requests=self.request_log,
            metrics=self.metrics,
            mode_trace=self.mode_trace,
            telemetry=self.telemetry.snapshot(),
            ticks=self.ticks,
            pump_wall_s=self._pump_wall_s,
            useful_tokens=self._useful_tokens,
            wasted_tokens=self._wasted_tokens,
            kv_store=(self.kv_store.snapshot()
                      if self.kv_store is not None else None),
            decisions=list(self.decisions),
        )

    def run(self) -> FleetReport:
        """Closed-trace shim: drain the pre-built workload trace and return
        the report — the legacy entry point, now equivalent to attaching a
        ``FleetClient``, adopting the trace, and ticking to idle (the
        streaming examples/benchmarks do exactly that)."""
        if self.cfg.warmup:
            self.warmup()
        while self._busy() and self.ticks < self.cfg.max_ticks:
            self.tick()
        return self.report()


# ---------------------------------------------------------------------------
# Demo fleet (example / smoke / benchmark share one construction)
# ---------------------------------------------------------------------------


def build_demo_fleet(
    *,
    arch: str = "qwen3-0.6b",
    n_requests: int = 100,
    rate: float = 3.0,
    outage: Optional[Tuple[float, float]] = None,
    hedge_fraction: float = 0.0,
    paged: bool = False,
    seed: int = 0,
    device=None,
) -> FleetRuntime:
    """A heterogeneous 2-tier fleet over reduced-config engines.

    ``cheap`` has low $/hr but small decode batches (low per-replica
    throughput); ``premium`` costs more per hour but decodes twice the
    slots.  ``outage=(start, end)`` pins the cheap pool to zero capacity —
    the Fig.-7 drill over live replicas.
    """
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import steady
    from repro_torch.fleet.workload import poisson_trace

    vocab = get_config(arch).reduce().vocab_size
    duration = n_requests / rate
    workload = poisson_trace(
        steady(rate), duration * 1.5, vocab_size=vocab,
        prompt_len=(8, 8), max_new=(4, 12), seed=seed, n_max=n_requests,
    )
    tiers = [
        TierSpec(name="cheap", arch=arch, cost_per_hour=1.0,
                 nominal_t_max=1.0, latency_s=2.0, decode_batch=2,
                 decode_chunk=4, queue_limit=6, base_capacity=6,
                 provision_delay_s=3.0, initial_replicas=2,
                 paged_kv=paged, page_size=8),
        TierSpec(name="premium", arch=arch, cost_per_hour=4.0,
                 nominal_t_max=2.0, latency_s=1.0, decode_batch=4,
                 decode_chunk=4, queue_limit=8, base_capacity=4,
                 provision_delay_s=3.0, initial_replicas=1,
                 paged_kv=paged, page_size=8),
    ]
    pool_events = None
    if outage is not None:
        pool_events = {"cheap": [synthetic_outage(outage[0], outage[1])]}
    return FleetRuntime(
        tiers, workload,
        FleetConfig(
            hedge_fraction=hedge_fraction, seed=seed,
            # measured signals are noisier than analytic ones: damp the
            # binary step so the edge-of-capacity regime doesn't flap
            controller=ControllerConfig(hysteresis_margin=0.25, min_dwell_s=4.0),
        ),
        pool_events=pool_events, device=device,
    )


def build_saturated_fleet(
    *,
    arch: str = "qwen3-0.6b",
    n_requests: int = 40,
    n_replicas: int = 1,
    decode_batch: int = 4,
    prompt_len: int = 8,
    max_new: Tuple[int, int] = (4, 12),
    max_len: int = 64,
    mixed_step: bool = True,
    prefill_chunk: int = 64,
    spec_k: int = 0,
    model_overrides: Optional[Dict[str, object]] = None,
    param_seed: int = 0,
    trace: bool = True,
    seed: int = 0,
    device=None,
) -> FleetRuntime:
    """A single-tier fleet fed its whole workload as one burst at t=0 —
    the saturating configuration for apples-to-apples goodput against a
    bare ``ServingEngine.serve_queue`` at equal replica count, and (with
    long prompts + ``mixed_step`` toggled) the A/B for the mixed-batch
    engine's TTFT/goodput acceptance row.  ``spec_k`` turns on speculative
    decoding; ``model_overrides`` resizes the reduced model (the decode-
    bound spec bench needs enough compute per dispatch for the fused
    verify step to amortize)."""
    from repro_torch.configs import get_config
    from repro_torch.fleet.workload import burst_of

    vocab = get_config(arch).reduce().vocab_size
    if model_overrides and "vocab_size" in model_overrides:
        vocab = int(model_overrides["vocab_size"])
    workload = burst_of(n_requests, vocab_size=vocab, prompt_len=prompt_len,
                        max_new=max_new, seed=seed)
    tier = TierSpec(name="flat", arch=arch, cost_per_hour=1.0,
                    nominal_t_max=2.0, max_len=max_len,
                    decode_batch=decode_batch,
                    decode_chunk=4, queue_limit=2 * decode_batch,
                    base_capacity=n_replicas, initial_replicas=n_replicas,
                    provision_delay_s=1.0, mixed_step=mixed_step,
                    prefill_chunk=prefill_chunk, spec_k=spec_k,
                    model_overrides=model_overrides, param_seed=param_seed)
    return FleetRuntime([tier], workload, FleetConfig(seed=seed, trace=trace),
                        device=device)


def build_prefix_fleet(
    *,
    arch: str = "qwen3-0.6b",
    n_personas: int = 3,
    requests_per_persona: int = 8,
    prefix_len: int = 768,
    suffix_len: int = 6,
    max_new: Tuple[int, int] = (4, 8),
    n_replicas: int = 1,
    decode_batch: int = 4,
    page_size: int = 64,
    prefix_reuse: bool = True,
    seed: int = 0,
    device=None,
) -> FleetRuntime:
    """A paged single-tier fleet fed the shared-prefix persona workload —
    the configuration where prefix reuse is measurable end-to-end: long
    persona prompts dominate admission cost, so skipping their prefill on
    a cache hit shows up directly in goodput.  ``prefix_reuse=False`` runs
    the identical paged fleet with the cache disabled (the control)."""
    from repro_torch.configs import get_config
    from repro_torch.fleet.workload import shared_prefix_trace

    vocab = get_config(arch).reduce().vocab_size
    workload = shared_prefix_trace(
        n_personas, requests_per_persona, vocab_size=vocab,
        prefix_len=prefix_len, suffix_len=suffix_len, max_new=max_new,
        seed=seed,
    )
    need = prefix_len + suffix_len + max_new[1]
    max_len = -(-need // page_size) * page_size        # whole pages
    # explicit 2x pool: the benchmark measures reuse, so persona prompts
    # must survive in cache alongside a fully-occupied live set
    num_pages = 1 + 2 * decode_batch * (max_len // page_size)
    tier = TierSpec(name="paged", arch=arch, cost_per_hour=1.0,
                    nominal_t_max=2.0, max_len=max_len,
                    decode_batch=decode_batch, decode_chunk=4,
                    queue_limit=2 * decode_batch,
                    base_capacity=n_replicas, initial_replicas=n_replicas,
                    provision_delay_s=1.0, paged_kv=True,
                    page_size=page_size, num_pages=num_pages,
                    prefix_reuse=prefix_reuse)
    return FleetRuntime([tier], workload, FleetConfig(seed=seed), device=device)


def build_recovery_fleet(
    *,
    arch: str = "qwen3-0.6b",
    n_requests: int = 8,
    prompt_len: int = 512,
    max_new: Tuple[int, int] = (12, 24),
    n_replicas: int = 2,
    decode_batch: int = 3,
    page_size: int = 16,
    kv_store: bool = True,
    kill_ts: Sequence[float] = (2.0, 4.0),
    preempt_t: Optional[float] = 3.0,
    preempt_deadline_s: float = 2.0,
    seed: int = 0,
    device=None,
) -> FleetRuntime:
    """A single paged tier under a mid-decode crash AND a preemption notice
    — the durable-KV drill.  Long prompts make re-prefill expensive, so the
    store's zero-recompute recovery is measurable: ``kv_store=False`` runs
    the identical fleet where every requeued request pays full re-prefill
    (the control).  Greedy + shared params keep both arms token-exact."""
    from repro_torch.configs import get_config
    from repro_torch.fleet.workload import burst_of

    vocab = get_config(arch).reduce().vocab_size
    workload = burst_of(n_requests, vocab_size=vocab, prompt_len=prompt_len,
                        max_new=max_new, seed=seed)
    max_len = -(-(prompt_len + max_new[1]) // page_size) * page_size
    # generous pool: restored frontiers land on fresh pages while the
    # victim's prompt pages may still sit in the survivor's prefix cache
    num_pages = 1 + 2 * decode_batch * (max_len // page_size)
    tier = TierSpec(name="spot", arch=arch, cost_per_hour=1.0,
                    nominal_t_max=2.0, max_len=max_len,
                    decode_batch=decode_batch, decode_chunk=4,
                    queue_limit=2 * decode_batch,
                    # ceiling == replica count: no idle spares, so the
                    # scripted events always hit a replica carrying work
                    base_capacity=n_replicas,
                    initial_replicas=n_replicas,
                    provision_delay_s=2.0, paged_kv=True,
                    page_size=page_size, num_pages=num_pages,
                    prefill_chunk=64,
                    # spot-CLASS pricing and notice semantics, but with the
                    # stochastic hazard off and the cold start pinned flat:
                    # the drill's kills/preemptions stay fully scripted and
                    # its timing byte-identical to the pre-economics runs
                    tier_class="spot", cold_start_s=2.0, cold_start_sigma=0.0,
                    preemption_rate=0.0)
    failures = [FailureEvent(t=kt, tier="spot") for kt in kill_ts]
    preemptions = ([PreemptionEvent(t=preempt_t, tier="spot",
                                    deadline_s=preempt_deadline_s)]
                   if preempt_t is not None else [])
    return FleetRuntime(
        [tier], workload,
        FleetConfig(seed=seed, kv_store=kv_store, kv_checkpoint_interval=1,
                    max_retries=8),
        failures=failures,
        preemptions=preemptions,
        device=device,
    )


def build_day_fleet(
    *,
    arch: str = "qwen3-0.6b",
    n_days: int = 2,
    period_s: float = 120.0,
    base_rps: float = 0.6,
    peak_rps: float = 3.0,
    night_frac: float = 0.3,
    forecast: bool = False,
    warm_pool: int = 0,
    spot_cold_start_s: float = 5.0,
    preemption_rate: float = 0.0,
    seed: int = 0,
    device=None,
) -> FleetRuntime:
    """The capacity-economics A/B fleet: a cheap spot-class tier (slow cold
    starts) plus an expensive serverless-class tier (fast starts), fed
    ``n_days`` compressed diurnal cycles with hard zero-traffic nights.

    Build it twice — ``forecast=False`` (reactive EWMA autoscaling) and
    ``forecast=True`` (seasonal provisioning one cold-start ahead) — on the
    same seed and the arms see the identical trace; the difference in
    ``usd_per_1k_tokens`` / ``slo_attainment()`` is pure controller.
    ``preemption_rate=0`` keeps the A/B deterministic; turn it up to also
    exercise the stochastic spot-reclaim drain path.
    """
    from repro_torch.configs import get_config
    from repro_torch.fleet.workload import day_cycle_trace

    vocab = get_config(arch).reduce().vocab_size
    workload = day_cycle_trace(
        n_days, vocab_size=vocab, period_s=period_s, base_rps=base_rps,
        peak_rps=peak_rps, night_frac=night_frac,
        prompt_len=(8, 8), max_new=(4, 12), seed=seed,
    )
    tiers = [
        # spot class: 0.35x multiplier makes this the cost-mode workhorse;
        # the price is a slow provision (the morning-ramp trap the
        # forecast arm exists to avoid)
        TierSpec(name="spot", arch=arch, tier_class="spot",
                 cost_per_hour=3.0, nominal_t_max=1.0, latency_s=2.0,
                 decode_batch=2, decode_chunk=4, queue_limit=6,
                 base_capacity=6, initial_replicas=1,
                 cold_start_s=spot_cold_start_s, cold_start_sigma=0.0,
                 preemption_rate=preemption_rate, warm_pool=warm_pool,
                 page_size=8),
        # serverless class: 2.5x multiplier, near-instant starts — the
        # burst absorber the controller spills to when spot lags
        TierSpec(name="burst", arch=arch, tier_class="serverless",
                 cost_per_hour=3.0, nominal_t_max=2.0, latency_s=1.0,
                 decode_batch=4, decode_chunk=4, queue_limit=8,
                 base_capacity=4, initial_replicas=0,
                 cold_start_s=1.0, cold_start_sigma=0.0,
                 page_size=8),
    ]
    return FleetRuntime(
        tiers, workload,
        FleetConfig(
            seed=seed,
            forecast=forecast, forecast_period_s=period_s,
            controller=ControllerConfig(hysteresis_margin=0.25,
                                        min_dwell_s=4.0),
            # true scale-to-zero on the hard night gaps: without the
            # epsilon, ceil() of the decaying arrival EWMA pins one
            # replica per tier all night and the idle window bills anyway
            autoscaler=AutoscalerConfig(scale_down_stabilization_s=10.0,
                                        scale_to_zero_eps=0.05),
        ),
        device=device,
    )


def build_multimodel_day_fleet(
    *,
    llm_arch: str = "qwen3-0.6b",
    scan_arch: str = "rwkv6-7b",
    job_arch: str = "sd21",
    n_days: int = 2,
    period_s: float = 120.0,
    llm_base_rps: float = 0.6,
    llm_peak_rps: float = 2.5,
    scan_rps: float = 0.4,
    job_burst: int = 12,
    job_max_new: Tuple[int, int] = (6, 12),
    capacity_trading: bool = True,
    seed: int = 0,
    device=None,
) -> FleetRuntime:
    """The heterogeneous multi-model fleet: three model FAMILIES behind one
    runtime — a paged transformer LLM tier, a constant-state scan tier
    (rwkv), and a diffusion-style job tier (the paper's sd21 DUs) — each
    fed its own tagged workload so the dispatcher's model-aware routing is
    load-bearing (a misroute would put a diffusion job on an LLM engine).

    The LLM trace is diurnal with hard zero-traffic nights; the diffusion
    jobs arrive as one synchronized burst INSIDE the second night window —
    exactly when the LLM pool is idle — so with ``capacity_trading`` on,
    the jobs tier (ceiling 1) borrows pool ceiling from the sleeping LLM
    tier, traced as ``ctl.capacity_trade`` decisions, and returns it
    before the morning ramp.

    The port has no job engine yet, so a ``job_arch`` from ``JOB_ARCHES``
    (the default) makes the runtime raise ``ValueError`` at construction."""
    from repro_torch.configs import get_config
    from repro_torch.fleet.workload import (INTERACTIVE, burst_of, day_cycle_trace,
                                            poisson_trace)

    vocab_llm = get_config(llm_arch).reduce().vocab_size
    vocab_scan = get_config(scan_arch).reduce().vocab_size
    llm_reqs = day_cycle_trace(
        n_days, vocab_size=vocab_llm, period_s=period_s,
        base_rps=llm_base_rps, peak_rps=llm_peak_rps, night_frac=0.3,
        prompt_len=(8, 8), max_new=(4, 12), seed=seed, model=llm_arch)
    scan_reqs = poisson_trace(
        lambda t: scan_rps, n_days * period_s, vocab_size=vocab_scan,
        prompt_len=(8, 8), max_new=(4, 10), classes=(INTERACTIVE,),
        seed=seed + 1, max_rate=scan_rps, model=scan_arch)
    # the diffusion burst lands just inside the LAST night window (t =
    # (n_days-1)*period .. +0.3*period): LLM demand has decayed to ~0, so
    # the trade has a willing donor
    burst_t = (n_days - 1) * period_s + 0.05 * period_s
    job_reqs = burst_of(job_burst, vocab_size=1024, at_t=burst_t,
                        prompt_len=8, max_new=job_max_new, seed=seed + 2,
                        model=job_arch, slo_class="job")
    workload: List[Request] = []
    rid = 0
    for group in (llm_reqs, scan_reqs, job_reqs):
        for r in group:
            r.rid = rid
            rid += 1
            workload.append(r)

    tiers = [
        TierSpec(name="llm", arch=llm_arch, cost_per_hour=2.0,
                 nominal_t_max=1.5, latency_s=1.0, decode_batch=4,
                 decode_chunk=4, queue_limit=8, base_capacity=6,
                 initial_replicas=1, provision_delay_s=2.0,
                 paged_kv=True, page_size=8),
        TierSpec(name="scan", arch=scan_arch, cost_per_hour=1.5,
                 nominal_t_max=1.0, latency_s=1.5, decode_batch=2,
                 decode_chunk=4, queue_limit=6, base_capacity=3,
                 initial_replicas=1, provision_delay_s=2.0,
                 mixed_step=False),
        # ceiling 1 on purpose: the burst CANNOT be served in time on the
        # jobs tier's own budget — serving it is what the trade buys
        TierSpec(name="jobs", arch=job_arch, cost_per_hour=2.5,
                 nominal_t_max=0.5, latency_s=5.0, decode_batch=4,
                 max_len=64, decode_chunk=4, queue_limit=12,
                 base_capacity=1, initial_replicas=1,
                 provision_delay_s=1.0, mixed_step=False),
    ]
    return FleetRuntime(
        tiers, workload,
        FleetConfig(
            seed=seed, capacity_trading=capacity_trading,
            controller=ControllerConfig(hysteresis_margin=0.25,
                                        min_dwell_s=4.0),
            autoscaler=AutoscalerConfig(scale_down_stabilization_s=8.0,
                                        scale_to_zero_eps=0.05),
        ),
        device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny-config gate: ~100 requests, assert zero dropped")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=3.0)
    ap.add_argument("--outage", default="",
                    help="start:end control-loop seconds of cheap-tier outage")
    ap.add_argument("--paged", action="store_true",
                    help="serve with the paged KV cache (prefix reuse on)")
    ap.add_argument("--trace-out", default="",
                    help="write the flight-recorder event trace (JSONL) here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-run summary lines (warnings only)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    # stdout + bare-message format keeps --smoke output byte-identical to
    # the historical print() lines while routing through logging (so
    # --quiet, or an embedding application's handlers, can filter it)
    logging.basicConfig(stream=sys.stdout, format="%(message)s",
                        level=logging.WARNING if args.quiet else logging.INFO)

    outage = None
    if args.outage:
        s, e = (float(x) for x in args.outage.split(":"))
        outage = (s, e)
    rt = build_demo_fleet(arch=args.arch, n_requests=args.requests,
                          rate=args.rate, outage=outage, paged=args.paged,
                          device=args.device)
    t0 = time.perf_counter()
    report = rt.run()
    wall = time.perf_counter() - t0
    s = report.summary()
    logger.info("fleet summary: %s", {k: round(v, 3) for k, v in s.items()})
    logger.info("mode trace: %s",
                [(round(t, 1), m) for t, m in report.mode_trace])
    tel = {k: {kk: round(vv, 3) for kk, vv in v.items()}
           for k, v in report.telemetry.items()}
    logger.info("telemetry: %s", tel)
    logger.info("wall: %.1fs for %d ticks (%.0f goodput tok/s of decode wall)",
                wall, report.ticks, report.goodput_tokens_per_s)
    if args.trace_out:
        n_ev = rt.tracer.dump_jsonl(args.trace_out)
        logger.info("trace: %d events -> %s (%d dropped to ring wrap)",
                    n_ev, args.trace_out, rt.tracer.dropped)
    if args.smoke:
        n_done = len(report.requests.records)
        assert n_done == args.requests, (
            f"smoke: {n_done}/{args.requests} requests completed")
        assert not report.requests.dropped, (
            f"smoke: {len(report.requests.dropped)} requests dropped")
        assert all(d.explains() for d in report.decisions), (
            "smoke: unexplainable controller decision in the audit log")
        print(f"fleet smoke OK: {n_done}/{args.requests} requests, 0 dropped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
