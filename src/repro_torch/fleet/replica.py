"""Replica lifecycle: provisioning → warming → ready → draining → failed.

One ``Replica`` is a live deployment-unit instance: a ``QueueSession``
(bounded request queue + decode slots) over a tier-shared ``ServingEngine``.
Sharing the engine means every replica of a tier reuses ONE set of
weights and kernels (provisioning a replica allocates a fresh KV-cache
session, whose steps capture their own graphs on the card), while keeping
per-replica decode state fully isolated.

Lifecycle transitions (driven by the fleet runtime against the
``CapacityPool`` it mirrors):

  PROVISIONING --warm()--> WARMING --activate()--> READY
  READY --drain()--> DRAINING --(pump to empty)--> TERMINATED
  READY/DRAINING --fail()--> FAILED   (in-flight rids returned for requeue)
"""
from __future__ import annotations

import enum
from typing import List, Optional


from repro_torch.fleet.workload import Request
from repro_torch.obs import Tracer
from repro_torch.serving.engine import PumpReport, QueueSession, ServingEngine


class ReplicaState(enum.Enum):
    PROVISIONING = "provisioning"   # node requested, nothing allocated yet
    WARMING = "warming"             # session allocated, not yet taking traffic
    READY = "ready"                 # serving
    DRAINING = "draining"           # no new admissions; finishing in-flight
    FAILED = "failed"               # killed; in-flight requeued elsewhere
    TERMINATED = "terminated"       # drained clean / cancelled while warming


class Replica:
    """One live replica of a tier: state machine + bounded queue session."""

    def __init__(self, name: str, tier: str, engine: ServingEngine,
                 *, queue_limit: int = 8):
        self.name = name
        self.tier = tier
        self.engine = engine
        self.queue_limit = queue_limit
        self.state = ReplicaState.PROVISIONING
        self.session: Optional[QueueSession] = None
        self.born_t: float = 0.0
        self.pumps = 0
        # preemption-with-notice: absolute deadline by which this replica's
        # node disappears (None = no notice pending)
        self.preempt_deadline: Optional[float] = None
        # test hook: a wedged replica looks READY but its pump does nothing
        # and never heartbeats — the model of a hung process that only the
        # missed-pump detector can catch
        self.wedged = False
        self._hb = None               # HeartbeatMonitor (runtime-owned)
        self._hb_id: Optional[int] = None
        # flight recorder (runtime-owned; disabled stub when standalone so
        # every transition site emits unconditionally)
        self.tracer: Tracer = Tracer.disabled()
        # controller-commanded speculative depth, remembered across the
        # session-less window (None = never commanded: the session keeps
        # the engine-config default)
        self._spec_k_cmd: Optional[int] = None

    def _trace_state(self) -> None:
        self.tracer.event(f"replica.{self.state.value}", cat="ctl",
                          replica=self.name, tier=self.tier)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Replica({self.name}, {self.tier}, {self.state.value}, load={self.load})"

    # -- lifecycle ----------------------------------------------------------
    def warm(self) -> None:
        assert self.state == ReplicaState.PROVISIONING, self.state
        self.session = self.engine.new_session()
        if self._spec_k_cmd is not None:
            # the controller commanded a depth before this session existed
            # (tick 0, or a replica provisioned mid-run): a session born
            # under capacity pressure must not speculate at the config
            # ceiling until the next controller edge
            self.session.spec_k = self._spec_k_cmd
        self.state = ReplicaState.WARMING
        self._trace_state()

    def activate(self, t: float = 0.0) -> None:
        if self.state == ReplicaState.PROVISIONING:
            self.warm()
        assert self.state == ReplicaState.WARMING, self.state
        self.state = ReplicaState.READY
        self.born_t = t
        self._trace_state()

    def drain(self) -> None:
        """Graceful scale-down: stop admissions, finish in-flight work."""
        if self.state in (ReplicaState.PROVISIONING, ReplicaState.WARMING):
            self.state = ReplicaState.TERMINATED
            self.session = None
            self._trace_state()
            return
        assert self.state in (ReplicaState.READY, ReplicaState.DRAINING), self.state
        if self.state != ReplicaState.DRAINING:
            self.state = ReplicaState.DRAINING
            self._trace_state()

    def preempt(self, deadline_t: float) -> None:
        """Spot-reclaim NOTICE: the node disappears at ``deadline_t``.  The
        replica drains (no new admissions) and the runtime flushes its KV
        frontiers to the fleet store every pump until the deadline, then
        crash-kills whatever is left."""
        self.preempt_deadline = deadline_t
        self.drain()

    @property
    def preempting(self) -> bool:
        return self.preempt_deadline is not None and self.live

    def wedge(self) -> None:
        """Test hook: hang the replica (state stays READY, pumps become
        no-ops, heartbeats stop).  Only missed-pump detection can see it."""
        self.wedged = True
        self.tracer.event("replica.wedged", cat="ctl",
                          replica=self.name, tier=self.tier)

    def release(self) -> None:
        """Instant clean termination of an IDLE replica — the path a spot
        reclaim takes when its victim is a warm-pool standby (WARMING) or
        ready with zero live requests: nothing to drain, nothing to
        requeue, nothing to flush, so no ``PreemptionEvent`` machinery and
        no ``req.requeued`` traces.  The node just goes away."""
        assert self.load == 0, f"release() on loaded replica {self.name}"
        self.preempt_deadline = None
        self.state = ReplicaState.TERMINATED
        self.session = None
        self._trace_state()
        if self._hb is not None and self._hb_id is not None:
            self._hb.forget(self._hb_id)

    def fail(self) -> List[int]:
        """Kill mid-decode (spot reclaim / crash): the session dies with the
        replica; every incomplete rid is returned for requeueing."""
        rids = self.session.inflight_rids() if self.session is not None else []
        self.state = ReplicaState.FAILED
        self.session = None
        self.preempt_deadline = None
        self.tracer.event("replica.failed", cat="ctl", replica=self.name,
                          tier=self.tier, inflight=len(rids))
        return rids

    # -- traffic ------------------------------------------------------------
    @property
    def accepting(self) -> bool:
        return (self.state == ReplicaState.READY
                and self.session is not None
                and self.session.load < self.queue_limit)

    @property
    def load(self) -> int:
        return self.session.load if self.session is not None else 0

    def prefix_match_len(self, prompt) -> int:
        """Tokens of ``prompt`` ((1, Sp) array or token tuple) already cached
        in this replica's paged KV — the dispatcher's prefix-affinity score
        (0 when the replica is not serving or paging is off)."""
        if self.session is None:
            return 0
        return self.session.prefix_match_len(prompt)

    def set_chunk_budget(self, budget: int) -> None:
        """Retune the mixed-step token budget (the TTFT/TPOT knob) on the
        live session — steps key on the pow-2 chunk bucket, which warmup
        prepares.  No-op while the replica holds no session."""
        if self.session is not None:
            self.session.token_budget = max(1, int(budget))

    def set_speculation(self, k: int) -> None:
        """Retune the speculative-decode draft depth on the live session —
        the controller's compute-for-latency knob, live like
        ``set_chunk_budget`` (verify steps key on the pow-2 spec quantum).
        k=0 disables drafting entirely; remembered while
        the replica holds no session and applied when one is created."""
        self._spec_k_cmd = max(0, int(k))
        if self.session is not None:
            self.session.spec_k = self._spec_k_cmd

    @property
    def live(self) -> bool:
        return self.state in (ReplicaState.READY, ReplicaState.DRAINING)

    @property
    def billable(self) -> bool:
        """Accruing cost: anything holding a node (warming included)."""
        return self.state in (ReplicaState.WARMING, ReplicaState.READY,
                              ReplicaState.DRAINING)

    def fits(self, req: Request) -> bool:
        """Whether this replica's engine/page budget can EVER hold ``req``
        (independent of current load)."""
        return (self.session is not None
                and self.session.fits(req.prompt_len, req.max_new))

    def submit(self, req: Request) -> bool:
        if not self.accepting or not self.fits(req):
            return False
        self.session.submit(req.rid, req.prompt, req.max_new,
                            slo_class=req.slo_class, priority=req.priority,
                            deadline_s=req.deadline_s,
                            recompute=req.prefilled_once,
                            frontier=req.frontier)
        return True

    # -- durable KV / liveness ----------------------------------------------
    def attach_heartbeat(self, monitor, hb_id: int) -> None:
        """Register with the runtime's missed-pump detector; every live
        ``pump`` call beats (idle included — an idle replica responded, it
        just had no work)."""
        self._hb = monitor
        self._hb_id = hb_id

    def checkpoint_frontiers(self):
        """Every decoding request's frontier — ``KVFrontier`` on paged
        sessions, ``StateFrontier`` on scan-state sessions — the flush unit
        the runtime pushes into the fleet KV store."""
        if self.session is None or not self.session.supports_frontiers:
            return []
        return self.session.extract_frontiers()

    def pump(self, now: Optional[float] = None) -> Optional[PumpReport]:
        """One admission+chunk cycle; DRAINING replicas that empty out
        transition to TERMINATED and return their final report."""
        if not self.live or self.session is None:
            return None
        if self.wedged:               # hung: no beat, no work, looks READY
            return None
        if self._hb is not None:
            self._hb.beat(self._hb_id, now)
        if self.session.idle:
            if self.state == ReplicaState.DRAINING:
                self._terminate()
            return None
        report = self.session.pump()
        self.pumps += 1
        if self.state == ReplicaState.DRAINING and self.session.idle:
            self._terminate()
        return report

    def _terminate(self) -> None:
        """Clean exit after a drain: release the session and stop the
        heartbeat record (a terminated replica's last beat must not age
        into a false death)."""
        self.state = ReplicaState.TERMINATED
        self.session = None
        self._trace_state()
        if self._hb is not None and self._hb_id is not None:
            self._hb.forget(self._hb_id)
