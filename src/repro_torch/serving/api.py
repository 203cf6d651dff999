"""The streaming request lifecycle over one port engine.

Counterpart of the JAX package's ``serving/api.py`` for a single engine:

* ``InferenceRequest`` — prompt, output budget, SLO class, priority,
  deadline.
* ``RequestHandle`` — incremental ``tokens()`` fed per engine pump, a
  ``status`` state machine, ``cancel()``, and a ``RequestRecord`` whose
  TTFT is stamped at the first token that actually reached the handle.
* ``EngineClient`` — the handle API over one ``ServingEngine`` (one
  ``QueueSession``).  ``tick()`` runs one pump and feeds every handle.

Handle lifecycle::

    QUEUED --first token--> STREAMING --last token--> COMPLETED
       |                        |
       +---- cancel() ----------+--> CANCELLED   (partial tokens kept)

The JAX client's ``Tracer`` argument comes with the port of ``obs``.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.metrics import RequestRecord
from repro_torch.device import resolve_device
from repro_torch.serving.engine import PumpReport, QueueSession, ServingEngine


class RequestStatus(enum.Enum):
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
    """One client-side generation request.  ``prompt`` is (Sp,) or (1, Sp)
    int tokens; ``deadline_s`` is relative to submission."""

    prompt: np.ndarray
    max_new: int
    slo_class: str = "interactive"
    priority: int = 0                 # higher admits first within a class
    deadline_s: Optional[float] = None

    def prompt_2d(self) -> np.ndarray:
        p = np.asarray(self.prompt)
        return p[None, :] if p.ndim == 1 else p

    @property
    def prompt_len(self) -> int:
        return int(self.prompt_2d().shape[1])


class RequestHandle:
    """The client's live view of one in-flight request."""

    def __init__(self, request: InferenceRequest, rid: int, client, arrival_t: float):
        self.request = request
        self.rid = rid
        self.arrival_t = arrival_t
        self.first_token_t: Optional[float] = None
        self.complete_t: Optional[float] = None
        self.status = RequestStatus.QUEUED
        self.record: Optional[RequestRecord] = None
        self._client = client
        self._streamed: List[int] = []
        self._cursor = 0

    @property
    def done(self) -> bool:
        return self.status.terminal

    @property
    def delivered(self) -> int:
        return len(self._streamed)

    def take(self) -> List[int]:
        """Non-blocking poll: the tokens that arrived since the last take."""
        out = self._streamed[self._cursor:]
        self._cursor = len(self._streamed)
        return list(out)

    def tokens(self) -> Iterator[int]:
        """Yield output tokens as they stream, driving the client while the
        request is live."""
        while True:
            while self._cursor < len(self._streamed):
                tok = self._streamed[self._cursor]
                self._cursor += 1
                yield tok
            if self.status.terminal:
                return
            self._client.tick()

    def result(self) -> np.ndarray:
        """Tick the client until terminal; return the delivered tokens."""
        while not self.status.terminal:
            self._client.tick()
        if self.status is RequestStatus.FAILED:
            raise RuntimeError(f"request {self.rid} was dropped")
        return np.asarray(self._streamed, np.int64)

    def cancel(self) -> bool:
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

    def _finish(self, toks: np.ndarray, t: float) -> None:
        if self.status.terminal:
            return
        final = [int(x) for x in np.asarray(toks).ravel()]
        self._streamed = final            # the completion array is authoritative
        self.complete_t = t
        if self.first_token_t is None:    # instant (max_new <= 0) completion
            self.first_token_t = t
        self.status = RequestStatus.COMPLETED
        self.record = RequestRecord(
            rid=self.rid, arrival_t=self.arrival_t, first_token_t=self.first_token_t,
            complete_t=t, prompt_len=self.request.prompt_len, tokens=len(final),
            slo_class=self.request.slo_class)

    def _cancelled(self, t: float) -> None:
        if not self.status.terminal:
            self.complete_t = t
            self.status = RequestStatus.CANCELLED


class EngineClient:
    """The streaming handle API over one ``ServingEngine``.  ``device``
    defaults to the card and must be the engine's device."""

    def __init__(self, engine: ServingEngine, *, device=None):
        dev = resolve_device(device)
        if engine.device != dev:
            raise ValueError(f"engine runs on {engine.device}, client asked for {dev}")
        self.engine = engine
        self.session = QueueSession(engine)
        self.handles: Dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._clock = time.perf_counter

    def submit(self, request: InferenceRequest) -> RequestHandle:
        """Queue a request; returns its handle.  Raises ``ValueError`` for a
        request the engine can never hold, leaving the rid unused."""
        rid = self._next_rid
        self.session.submit(rid, request.prompt_2d(), request.max_new,
                            slo_class=request.slo_class, priority=request.priority,
                            deadline_s=request.deadline_s)
        self._next_rid += 1
        handle = RequestHandle(request, rid, self, self._clock())
        self.handles[rid] = handle
        return handle

    def tick(self) -> PumpReport:
        """One engine cycle: pump the session, stream the deltas."""
        report = self.session.pump()
        now = self._clock()
        for rid, toks in report.tokens.items():
            h = self.handles.get(rid)
            if h is not None:
                h._feed(toks, now)
        for rid, arr in report.completed.items():
            h = self.handles.get(rid)
            if h is not None:
                h._finish(arr, now)
        return report

    def cancel(self, handle: Union[RequestHandle, int]) -> bool:
        h = handle if isinstance(handle, RequestHandle) else self.handles.get(handle)
        if h is None:
            return False
        hit = self.session.cancel(h.rid)
        if hit:
            h._cancelled(self._clock())
        return hit

    @property
    def idle(self) -> bool:
        return self.session.idle

    def drain(self) -> None:
        """Tick until every submitted request reached a terminal state."""
        while not self.idle:
            self.tick()


# class -> admission rank: interactive first, jobs next, batch last;
# unknown classes rank with interactive
_SLO_RANK = {"batch": 2, "job": 1}


def slo_order_key(slo_class: str, priority: int, deadline_at: float, seq: int = 0) -> tuple:
    """The one ordering rule for pending work: interactive ahead of jobs
    ahead of batch, higher priority first, soonest deadline, then FIFO."""
    return (_SLO_RANK.get(slo_class, 0), -int(priority), deadline_at, seq)
