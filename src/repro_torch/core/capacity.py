"""Capacity-pool dynamics: the DU_i^p(t) side of the control loop.

Models what Karpenter NodePools gave the paper: a per-DU ceiling on
obtainable replicas that moves over time (spot reclaims, capacity
shortfalls, synthetic limits like Fig. 6's L4 cap), plus a provisioning
delay between *requesting* a replica and it becoming *ready*
(node launch + image pull + model load in the paper's stack).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass
class CapacityEvent:
    """Pool-capacity change over [start, end): capacity clipped to `limit`."""

    start: float
    end: float
    limit: int


@dataclass
class CapacityPool:
    """Obtainable-replica ceiling for one DU type, with provisioning lag."""

    base_capacity: int
    provision_delay_s: float = 30.0
    events: List[CapacityEvent] = field(default_factory=list)
    # (ready_time, count) for replicas still warming up
    _pending: List[Tuple[float, int]] = field(default_factory=list)
    ready: int = 0
    # cold-start model: when set, every scale-up replica pays its OWN
    # sampled provisioning delay (one pending entry per replica) instead of
    # the flat ``provision_delay_s`` — the runtime owns the sampler (seeded
    # RNG per tier) so the economics layer can meter each draw
    delay_sampler: Optional[Callable[[], float]] = None
    # warm standby stock: pre-provisioned replicas holding a node (billable)
    # but taking no traffic; ``request`` promotes them to ready INSTANTLY,
    # bypassing the cold start — the TTFT-for-standby-cost trade
    warm: int = 0
    _warm_pending: List[Tuple[float, int]] = field(default_factory=list)

    def capacity_at(self, t: float) -> int:
        """DU_i^p(t): the ceiling at time t (min over active events)."""
        cap = self.base_capacity
        for ev in self.events:
            if ev.start <= t < ev.end:
                cap = min(cap, ev.limit)
        return cap

    @property
    def inflight(self) -> int:
        """Replicas requested but still provisioning (not yet ready)."""
        return sum(n for _, n in self._pending)

    @property
    def warm_inflight(self) -> int:
        """Standby replicas requested but still cold-starting."""
        return sum(n for _, n in self._warm_pending)

    def _delays(self, t: float, count: int) -> List[Tuple[float, int]]:
        """Pending entries for ``count`` new replicas: one per replica with
        its own sampled delay when a sampler is set, else one grouped entry
        at the flat ``provision_delay_s`` (byte-identical legacy path)."""
        if self.delay_sampler is None:
            return [(t + self.provision_delay_s, count)]
        return [(t + float(self.delay_sampler()), 1) for _ in range(count)]

    def request(self, t: float, target: int) -> int:
        """Scale toward `target` replicas (clipped to capacity at t).

        Warm standby stock is promoted FIRST (instantly — those nodes are
        already up); the remainder of a scale-up enters the pending queue
        and becomes ready after the (possibly sampled) provisioning delay.
        Scale-downs are immediate (graceful drain is modeled by the router
        finishing in-flight work within the tick).  When ``ready <= target
        < ready + inflight`` the pending queue is trimmed to ``target -
        ready`` (keeping the earliest, i.e. soonest-ready, requests) so
        maturing replicas never overshoot the target.  Returns the number
        of warm standbys promoted.
        """
        target = min(target, self.capacity_at(t))
        current = self.ready + self.inflight
        promoted = 0
        if target > current:
            promoted = min(self.warm, target - current)
            if promoted:
                self.warm -= promoted
                self.ready += promoted
                current += promoted
            if target > current:
                self._pending.extend(self._delays(t, target - current))
        elif target < self.ready:
            self.ready = target
            self._pending = []  # cancel warming replicas on scale-down
        elif target < current:
            keep = target - self.ready
            trimmed: List[Tuple[float, int]] = []
            for rt, n in self._pending:
                take = min(n, keep)
                if take > 0:
                    trimmed.append((rt, take))
                    keep -= take
            self._pending = trimmed
        return promoted

    def stock_warm(self, t: float, target: int) -> int:
        """Maintain the warm standby stock at ``target`` replicas.

        Scale-ups pay the cold start like any provision (a standby is only
        a standby once its node is up); scale-downs release instantly.
        Returns the number of NEW standby provisions started this call.
        """
        target = max(0, min(target,
                            self.capacity_at(t) - self.ready - self.inflight))
        current = self.warm + self.warm_inflight
        if target > current:
            self._warm_pending.extend(self._delays(t, target - current))
            return target - current
        if target < current:
            drop = current - target
            while drop > 0 and self._warm_pending:  # cancel newest starts first
                rt, n = self._warm_pending[-1]
                take = min(n, drop)
                if take == n:
                    self._warm_pending.pop()
                else:
                    self._warm_pending[-1] = (rt, n - take)
                drop -= take
            self.warm = max(0, self.warm - drop)
        return 0

    def cancel_pending(self, n: int = 1) -> int:
        """Cancel up to ``n`` in-flight cold starts (newest first — e.g. a
        spot reclaim hit a node mid-provision); returns how many were
        cancelled."""
        cancelled = 0
        while cancelled < n and self._pending:
            rt, cnt = self._pending[-1]
            take = min(cnt, n - cancelled)
            if take == cnt:
                self._pending.pop()
            else:
                self._pending[-1] = (rt, cnt - take)
            cancelled += take
        return cancelled

    def release_standby(self, n: int = 1) -> int:
        """Drop ``n`` warm standbys (spot reclaimed an idle node); returns
        how many were actually held."""
        take = min(n, self.warm)
        self.warm -= take
        return take

    def tick(self, t: float) -> int:
        """Advance time: mature pending replicas; enforce capacity ceiling."""
        matured = [(rt, n) for rt, n in self._pending if rt <= t]
        self._pending = [(rt, n) for rt, n in self._pending if rt > t]
        for _, n in matured:
            self.ready += n
        self.warm += sum(n for rt, n in self._warm_pending if rt <= t)
        self._warm_pending = [(rt, n) for rt, n in self._warm_pending if rt > t]
        cap = self.capacity_at(t)
        if self.ready + self.warm > cap:  # reclaim: standby nodes die first
            self.warm = max(0, min(self.warm, cap - self.ready))
        if self.ready > cap:  # reclaim (spot interruption / forced shortfall)
            self.ready = cap
        return self.ready


def synthetic_outage(start: float, end: float) -> CapacityEvent:
    """Fig. 7's simulated insufficient capacity: pool pinned to zero."""
    return CapacityEvent(start=start, end=end, limit=0)


def synthetic_limit(start: float, end: float, limit: int) -> CapacityEvent:
    """Fig. 6's synthetic L4 capacity limit."""
    return CapacityEvent(start=start, end=end, limit=limit)
