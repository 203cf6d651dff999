"""The streaming request lifecycle: one client API from engine to fleet.

The paper's control loop exists to hold *per-request* latency targets under
shifting capacity, so the public serving surface is built around the unit
that control plane reasons about — a streaming request handle with an SLO
class, a deadline, and cancellation (the shape SageServe's SLO-tiered
scheduling and WVA's global control plane treat as primitive):

* ``InferenceRequest`` — what a client asks for: prompt, output budget,
  SLO class, priority, deadline.
* ``RequestHandle`` — what a client holds while the request runs: an
  incremental ``tokens()`` iterator fed per engine pump (not buffered to
  completion), a ``status`` state machine, ``cancel()``, and a
  ``RequestRecord`` whose TTFT is stamped at the *actual first emitted
  token* rather than inferred at completion time.
* ``EngineClient`` — the handle API over one bare ``ServingEngine``
  (one ``QueueSession``); ``repro_torch.fleet.client.FleetClient`` is the
  same handle API over a whole ``FleetRuntime``.

Handle lifecycle::

    QUEUED --first token--> STREAMING --last token--> COMPLETED
       |                        |
       +---- cancel() ----------+--> CANCELLED   (partial tokens kept)
       |
       +---- dropped by the fleet --> FAILED

Both clients are *tick-driven*: ``tick()`` advances the underlying
runtime one cycle (one ``QueueSession.pump`` / one fleet tick) and feeds
every handle its token deltas.  ``RequestHandle.tokens()`` drives the
owning client itself when starved, so ``for tok in handle.tokens():`` is
all a streaming consumer writes.

The port's counterpart of the JAX package's ``serving/api.py``.  An
``EngineClient``'s ``device`` defaults to the card and must be its
engine's.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.metrics import RequestRecord
from repro_torch.device import resolve_device
from repro_torch.obs import Tracer
from repro_torch.serving.engine import PumpReport, QueueSession, ServingEngine


class RequestStatus(enum.Enum):
    """Lifecycle states of a ``RequestHandle``."""

    QUEUED = "queued"          # submitted; no token emitted yet
    STREAMING = "streaming"    # at least one token delivered
    COMPLETED = "completed"    # full output delivered; ``record`` is final
    CANCELLED = "cancelled"    # client abandoned it; partial tokens kept
    FAILED = "failed"          # the serving layer dropped it for good

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.COMPLETED, RequestStatus.CANCELLED,
                        RequestStatus.FAILED)


@dataclass
class InferenceRequest:
    """One client-side generation request (the unit the control plane
    reasons about).  ``prompt`` is (Sp,) or (1, Sp) int tokens;
    ``deadline_s`` is relative to submission — soonest-deadline-first
    admission within a class, and requests past their deadline are still
    served (never dropped for lateness) but are no longer hedged."""

    prompt: np.ndarray
    max_new: int
    slo_class: str = "interactive"
    priority: int = 0                 # higher admits first within a class
    deadline_s: Optional[float] = None
    speculate: bool = True            # opt-out of speculative drafting for
                                      # this request (it still rides spec
                                      # dispatches, contributing 1 token)
    model: str = ""                   # target arch ("" = any): the fleet
                                      # dispatcher only routes to tiers whose
                                      # TierSpec.arch matches (multi-model
                                      # fleets; single-engine clients ignore)

    def prompt_2d(self) -> np.ndarray:
        p = np.asarray(self.prompt)
        return p[None, :] if p.ndim == 1 else p

    @property
    def prompt_len(self) -> int:
        return int(self.prompt_2d().shape[1])


class RequestHandle:
    """The client's live view of one in-flight request.

    Tokens accumulate as the serving layer emits them (per pump, not at
    completion); ``tokens()`` yields them incrementally, driving the
    owning client when starved.  ``record`` is the per-request
    ``RequestRecord``, built at completion with ``first_token_t`` stamped
    when the first token actually reached this handle — after a replica
    kill and requeue the handle keeps streaming from where it left off
    (greedy retries are token-exact), so the stamp survives retries.
    """

    def __init__(self, request: InferenceRequest, rid: int, client,
                 arrival_t: float):
        self.request = request
        self.rid = rid
        self.arrival_t = arrival_t
        self.first_token_t: Optional[float] = None
        self.complete_t: Optional[float] = None
        self.status = RequestStatus.QUEUED
        self.record: Optional[RequestRecord] = None
        self.tier = ""
        self.replica = ""
        self.retries = 0
        self.failure_reason: Optional[str] = None   # set when status FAILED
        self._client = client
        self._streamed: List[int] = []
        self._cursor = 0              # tokens already yielded by tokens()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"RequestHandle(rid={self.rid}, {self.status.value}, "
                f"{len(self._streamed)}/{self.request.max_new} tokens)")

    # -- client-facing surface ----------------------------------------------
    @property
    def done(self) -> bool:
        return self.status.terminal

    @property
    def delivered(self) -> int:
        """Tokens streamed to this handle so far."""
        return len(self._streamed)

    def take(self) -> List[int]:
        """Non-blocking poll: return the tokens that arrived since the last
        ``take()``/``tokens()`` consumption, without driving the client.
        The polling counterpart of the ``tokens()`` iterator."""
        out = self._streamed[self._cursor:]
        self._cursor = len(self._streamed)
        return list(out)

    def tokens(self) -> Iterator[int]:
        """Yield output tokens as they stream, driving the client while the
        request is live.  Ends when the handle reaches a terminal state
        (a cancelled/failed stream ends early, mid-sequence)."""
        while True:
            while self._cursor < len(self._streamed):
                tok = self._streamed[self._cursor]
                self._cursor += 1
                yield tok
            if self.status.terminal:
                return
            self._client._drive()

    def result(self) -> np.ndarray:
        """Block (tick the client) until terminal; return the delivered
        tokens.  COMPLETED returns the full sequence — token-exact with
        the legacy completion-time array; CANCELLED returns the partial
        prefix delivered before the cancel; FAILED raises."""
        while not self.status.terminal:
            self._client._drive()
        if self.status is RequestStatus.FAILED:
            why = f": {self.failure_reason}" if self.failure_reason else ""
            raise RuntimeError(f"request {self.rid} was dropped{why}")
        return np.asarray(self._streamed, np.int64)

    def cancel(self) -> bool:
        """Abandon the request wherever it is (queued, mid-prefill,
        mid-decode): slots and KV pages are released immediately.  Returns
        False when it already reached a terminal state."""
        if self.status.terminal:
            return False
        return self._client.cancel(self)

    # -- serving-layer feed hooks --------------------------------------------
    def _feed(self, toks: Sequence[int], t: float) -> None:
        if self.status.terminal or not len(toks):
            return
        if self.first_token_t is None:
            self.first_token_t = t
        self._streamed.extend(int(x) for x in toks)
        self.status = RequestStatus.STREAMING

    def _finish(self, toks: np.ndarray, t: float, *, tier: str = "",
                replica: str = "", retries: int = 0) -> None:
        if self.status.terminal:
            return
        final = [int(x) for x in np.asarray(toks).ravel()]
        # the completion array is authoritative (it IS the legacy result);
        # streamed deltas are a prefix of it by construction
        self._streamed = final
        self.complete_t = t
        if self.first_token_t is None:    # instant (max_new<=0) completion
            self.first_token_t = t
        self.status = RequestStatus.COMPLETED
        self.tier, self.replica, self.retries = tier, replica, retries
        self.record = RequestRecord(
            rid=self.rid, arrival_t=self.arrival_t,
            first_token_t=self.first_token_t, complete_t=t,
            prompt_len=self.request.prompt_len, tokens=len(final),
            retries=retries, tier=tier, replica=replica,
            slo_class=self.request.slo_class,
        )

    def _cancelled(self, t: float) -> None:
        if not self.status.terminal:
            self.complete_t = t
            self.status = RequestStatus.CANCELLED

    def _fail(self, t: float, reason: str = "") -> None:
        if not self.status.terminal:
            self.complete_t = t
            self.status = RequestStatus.FAILED
            self.failure_reason = reason or None


class EngineClient:
    """The streaming handle API over one bare ``ServingEngine``.

    Wraps a single ``QueueSession``; ``tick()`` runs one pump and feeds
    every handle the tokens its slots emitted that pump.  Timestamps are
    wall-clock seconds (``time.perf_counter``) — the fleet client uses
    control-loop time instead, same handle semantics.
    """

    def __init__(self, engine: ServingEngine, *, tracer: Optional[Tracer] = None,
                 device=None):
        dev = resolve_device(device)
        if engine.device != dev:
            raise ValueError(f"engine runs on {engine.device}, client asked for {dev}")
        self.engine = engine
        self.session = QueueSession(engine)
        self.handles: Dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._clock = time.perf_counter
        # flight recorder on the wall clock (fleet clients trace through
        # the runtime's control-loop tracer instead); timestamps are passed
        # explicitly so a shared tracer's own clock is never clobbered
        self.tracer = tracer if tracer is not None else Tracer.disabled()

    # -- lifecycle ------------------------------------------------------------
    def submit(self, request: InferenceRequest, *,
               rid: Optional[int] = None) -> RequestHandle:
        """Queue a request; returns its handle.  Raises ``ValueError`` for
        requests the engine can never hold (``QueueSession.submit``'s
        bounds), leaving the rid unused."""
        if rid is None:
            while self._next_rid in self.handles:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        self.session.submit(
            rid, request.prompt_2d(), request.max_new,
            slo_class=request.slo_class, priority=request.priority,
            deadline_s=request.deadline_s, speculate=request.speculate,
        )
        now = self._clock()
        handle = RequestHandle(request, rid, self, now)
        self.handles[rid] = handle
        self.tracer.event("req.queued", t=now, cat="req", rid=rid,
                          prompt_len=request.prompt_len,
                          max_new=int(request.max_new),
                          slo=request.slo_class, model=request.model)
        return handle

    def tick(self) -> PumpReport:
        """One engine cycle: pump the session, stream the deltas."""
        report = self.session.pump()
        now = self._clock()
        self.tracer.event("engine.pump", t=now, cat="engine", sampled=True,
                          wall_s=report.wall_s, admit_s=report.admit_s,
                          dispatch_s=report.dispatch_s, sync_s=report.sync_s,
                          occupancy=report.occupancy)
        if report.spec_rounds:
            self.tracer.event("engine.speculate", t=now, cat="engine",
                              sampled=True, drafted=report.drafted_tokens,
                              accepted=report.accepted_tokens,
                              rounds=report.spec_rounds)
        for rid, toks in report.tokens.items():
            h = self.handles.get(rid)
            if h is not None:
                if h.first_token_t is None and len(toks):
                    self.tracer.event("req.first_token", t=now, cat="req",
                                      rid=rid)
                h._feed(toks, now)
        for rid, arr in report.completed.items():
            h = self.handles.get(rid)
            if h is not None:
                h._finish(arr, now)
                self.tracer.event("req.completed", t=now, cat="req", rid=rid,
                                  tokens=int(np.asarray(arr).size))
        return report

    _drive = tick                     # what starved handle iterators call

    def cancel(self, handle: Union[RequestHandle, int]) -> bool:
        h = handle if isinstance(handle, RequestHandle) else self.handles.get(handle)
        if h is None:
            return False                  # unknown rid: nothing to cancel
        hit = self.session.cancel(h.rid)
        if hit:
            now = self._clock()
            h._cancelled(now)
            self.tracer.event("req.cancelled", t=now, cat="req", rid=h.rid)
        return hit

    # -- introspection --------------------------------------------------------
    @property
    def idle(self) -> bool:
        return self.session.idle

    def drain(self) -> None:
        """Tick until every submitted request reached a terminal state."""
        while not self.idle:
            self.tick()


# class -> admission rank: interactive streams first, diffusion-style jobs
# next (seconds-long but deadline-bearing), batch backfill last.  Unknown
# classes rank with interactive, preserving the legacy two-class order.
_SLO_RANK = {"batch": 2, "job": 1}


def slo_order_key(slo_class: str, priority: int, deadline_at: float,
                  seq: int = 0) -> tuple:
    """The one ordering rule for pending work, everywhere: interactive
    ahead of jobs ahead of batch, higher priority first within a class,
    then soonest deadline, then submission order."""
    return (_SLO_RANK.get(slo_class, 0), -int(priority),
            deadline_at, seq)
