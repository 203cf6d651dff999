"""Arrival traces for the fleet runtime: the §5.1 workload taxonomy at
request granularity.

The analytic simulator samples a scalar RPS per tick; the fleet runtime
needs actual *requests* — a prompt, an output budget, an SLO class, and an
arrival timestamp.  Arrivals are an inhomogeneous Poisson process (thinning
over any rate function, including the simulator's ``steady`` / ``diurnal_cycle``
/ ``bursty`` traces), with prompt/output lengths drawn per request and a
mixed SLO population (interactive vs batch).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class SLOClass:
    """A latency service class (what the paper's 900 ms threshold becomes
    at request granularity)."""

    name: str
    ttft_target_s: float
    latency_target_s: float
    weight: float = 1.0           # sampling weight in the mixed population


INTERACTIVE = SLOClass("interactive", ttft_target_s=2.0,
                       latency_target_s=15.0, weight=0.7)
BATCH = SLOClass("batch", ttft_target_s=30.0,
                 latency_target_s=120.0, weight=0.3)
# diffusion-style jobs (the paper's sd21 DUs): seconds-long, non-streaming,
# highly batchable — no meaningful TTFT (the whole output lands at once),
# but a completion deadline tighter than batch backfill
JOB = SLOClass("job", ttft_target_s=10.0,
               latency_target_s=30.0, weight=0.0)

# class-name -> SLOClass, the targets ``RequestLog.slo_attainment`` scores
# against (the economics bench's SLO axis)
SLO_TARGETS = {c.name: c for c in (INTERACTIVE, BATCH, JOB)}


@dataclass
class Request:
    """One generation request flowing through the fleet."""

    rid: int
    arrival_t: float
    prompt: np.ndarray            # (1, prompt_len) int tokens
    max_new: int
    slo_class: str = "interactive"
    retries: int = 0              # incremented on every requeue after failure
    priority: int = 0             # higher dispatches/admits first in-class
    deadline_s: Optional[float] = None   # relative to arrival; past it the
                                         # request keeps serving but loses
                                         # hedging (latency is already lost)
    model: str = ""               # arch this request targets ("" = any tier);
                                  # the dispatcher only places it on tiers
                                  # whose TierSpec.arch matches
    # lazy int-tuple form of the prompt (the prefix-cache key shape);
    # carried through retried() copies so a backlogged request boxes once
    _token_key: Optional[tuple] = field(default=None, repr=False, compare=False)
    # durable-KV recovery: a stored KVFrontier attached by the runtime's
    # requeue/arrival path (the replica resumes decode from it), and whether
    # this request already completed a prefill on a replica that later died
    # (its retry prefill then counts as RECOMPUTED work in telemetry)
    frontier: Optional[object] = field(default=None, repr=False, compare=False)
    prefilled_once: bool = field(default=False, repr=False, compare=False)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[1])

    @property
    def deadline_t(self) -> float:
        """Absolute deadline in control-loop time (inf when none)."""
        if self.deadline_s is None:
            return float("inf")
        return self.arrival_t + self.deadline_s

    def past_deadline(self, now: float) -> bool:
        return now > self.deadline_t

    def token_key(self) -> tuple:
        if self._token_key is None:
            self._token_key = tuple(int(t) for t in self.prompt[0])
        return self._token_key

    def retried(self) -> "Request":
        return replace(self, retries=self.retries + 1)


def poisson_arrival_times(
    rate_fn: Callable[[float], float],
    duration_s: float,
    *,
    seed: int = 0,
    max_rate: Optional[float] = None,
) -> np.ndarray:
    """Inhomogeneous Poisson arrivals over [0, duration_s) by thinning."""
    rng = np.random.default_rng(seed)
    if max_rate is None:
        grid = np.linspace(0.0, duration_s, 512, endpoint=False)
        max_rate = max(float(rate_fn(float(t))) for t in grid) * 1.05
    if max_rate <= 0:
        return np.array([])
    times: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / max_rate)
        if t >= duration_s:
            break
        if rng.uniform() * max_rate <= float(rate_fn(t)):
            times.append(t)
    return np.asarray(times)


def poisson_trace(
    rate_fn: Callable[[float], float],
    duration_s: float,
    *,
    vocab_size: int,
    prompt_len: Tuple[int, int] = (8, 16),
    max_new: Tuple[int, int] = (4, 16),
    classes: Sequence[SLOClass] = (INTERACTIVE, BATCH),
    seed: int = 0,
    n_max: Optional[int] = None,
    max_rate: Optional[float] = None,
    model: str = "",
) -> List[Request]:
    """Sample a full request trace: Poisson arrivals + per-request shapes.

    ``prompt_len``/``max_new`` are inclusive [lo, hi] ranges; SLO classes
    are drawn by ``weight``.  Deterministic for a given seed.
    """
    times = poisson_arrival_times(rate_fn, duration_s, seed=seed,
                                  max_rate=max_rate)
    if n_max is not None:
        times = times[:n_max]
    rng = np.random.default_rng(seed + 1)
    weights = np.array([c.weight for c in classes], dtype=np.float64)
    weights = weights / weights.sum()
    reqs: List[Request] = []
    for rid, t in enumerate(times):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        new = int(rng.integers(max_new[0], max_new[1] + 1))
        cls = classes[int(rng.choice(len(classes), p=weights))]
        prompt = rng.integers(0, vocab_size, (1, plen), dtype=np.int64)
        reqs.append(Request(rid=rid, arrival_t=float(t), prompt=prompt,
                            max_new=new, slo_class=cls.name, model=model))
    return reqs


def day_cycle_rate(
    base_rps: float,
    peak_rps: float,
    *,
    period_s: float = 86400.0,
    night_frac: float = 0.25,
) -> Callable[[float], float]:
    """One simulated day, repeating: a HARD zero-traffic night window over
    the first ``night_frac`` of each period (the scale-to-zero opportunity),
    then a sin² daytime hump ramping base → peak → base.

    Unlike ``core.simulator.diurnal_cycle`` (which never touches zero), the
    night gap here is exactly 0 RPS — the workload where releasing every
    replica is the right answer and holding one is pure standby cost.
    """
    if not 0.0 < night_frac < 1.0:
        raise ValueError(f"night_frac must be in (0, 1), got {night_frac}")

    def rate(t: float) -> float:
        phase = (t % period_s) / period_s
        if phase < night_frac:
            return 0.0
        x = (phase - night_frac) / (1.0 - night_frac)
        return base_rps + (peak_rps - base_rps) * float(np.sin(np.pi * x)) ** 2

    return rate


def day_cycle_trace(
    n_days: int,
    *,
    vocab_size: int,
    period_s: float = 240.0,
    base_rps: float = 0.5,
    peak_rps: float = 4.0,
    night_frac: float = 0.25,
    prompt_len: Tuple[int, int] = (8, 16),
    max_new: Tuple[int, int] = (4, 16),
    classes: Sequence[SLOClass] = (INTERACTIVE, BATCH),
    seed: int = 0,
    model: str = "",
) -> List[Request]:
    """``n_days`` compressed diurnal cycles of Poisson arrivals over
    ``day_cycle_rate`` — zero-traffic night gaps included, deterministic
    under ``seed`` (the forecast-vs-reactive A/B runs the SAME trace)."""
    rate = day_cycle_rate(base_rps, peak_rps,
                          period_s=period_s, night_frac=night_frac)
    return poisson_trace(rate, n_days * period_s, vocab_size=vocab_size,
                         prompt_len=prompt_len, max_new=max_new,
                         classes=classes, seed=seed,
                         max_rate=peak_rps * 1.05, model=model)


def shared_prefix_trace(
    n_personas: int,
    requests_per_persona: int,
    *,
    vocab_size: int,
    prefix_len: int = 48,
    suffix_len: int = 4,
    max_new: Tuple[int, int] = (4, 12),
    spacing_s: float = 0.0,
    seed: int = 0,
) -> List[Request]:
    """N personas × M requests, every request = persona system prompt +
    a short unique user suffix — the workload where paged-KV prefix reuse
    pays: all but the first request per persona should hit the prefix
    cache and skip prefilling ``prefix_len`` tokens.

    Prompt lengths are FIXED (prefix_len + suffix_len) so the engine
    sees one prefill and one suffix shape.  Personas interleave
    round-robin (the adversarial order for a single replica's cache);
    ``spacing_s`` spreads arrivals, 0 means one saturating burst.
    """
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab_size, (prefix_len,), dtype=np.int64)
                for _ in range(n_personas)]
    reqs: List[Request] = []
    rid = 0
    for _ in range(requests_per_persona):
        for i in range(n_personas):
            suffix = rng.integers(0, vocab_size, (suffix_len,), dtype=np.int64)
            prompt = np.concatenate([prefixes[i], suffix])[None, :]
            reqs.append(Request(
                rid=rid, arrival_t=rid * spacing_s, prompt=prompt,
                max_new=int(rng.integers(max_new[0], max_new[1] + 1)),
                slo_class="interactive",
            ))
            rid += 1
    return reqs


def burst_of(
    n: int,
    *,
    vocab_size: int,
    at_t: float = 0.0,
    prompt_len: int = 8,
    max_new: Tuple[int, int] = (4, 12),
    seed: int = 0,
    rid_base: int = 0,
    model: str = "",
    slo_class: str = "interactive",
) -> List[Request]:
    """A synchronized burst (all requests arrive at once) — the saturating
    workload for goodput benchmarks and failover drills."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=rid_base + i,
            arrival_t=at_t,
            prompt=rng.integers(0, vocab_size, (1, prompt_len), dtype=np.int64),
            max_new=int(rng.integers(max_new[0], max_new[1] + 1)),
            slo_class=slo_class,
            model=model,
        )
        for i in range(n)
    ]
