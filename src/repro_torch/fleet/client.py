"""FleetClient: the streaming request lifecycle over a whole fleet.

The same handle API as ``repro_torch.serving.api.EngineClient`` — ``submit``
returns a ``RequestHandle``, ``tokens()`` streams, ``cancel()`` withdraws —
but the serving layer underneath is a ``FleetRuntime``: heterogeneous
tiers, weighted dispatch, hedging, replica failure and requeue.  One
client API spans a bare engine, a replica, and the whole fleet.

Event flow
----------
The client registers itself as a *streaming sink* on the runtime
(``FleetRuntime.attach_sink``).  Each ``tick()`` advances the control loop
one cycle; during the tick the runtime calls back with per-replica token
deltas, completions, and drops, and the client feeds the handles.

Replica deaths and hedging make fleet streams special: the same request
can emit from two replicas (hedge twins), or restart from token 0 on a
fresh replica after a kill.  Greedy decoding makes every retry/twin
token-exact, so the client reconciles by *position*: it tracks how many
tokens each (request, replica) pair has produced and forwards only the
suffix beyond what the handle already holds.  A handle therefore streams
monotonically through kills — it resumes where it left off, never
replays, and its TTFT stamp (the true first token a client observed)
survives the retry.

Timestamps are control-loop seconds (the fleet's clock), not wall time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.metrics import RequestRecord
from repro_torch.fleet.runtime import FleetRuntime
from repro_torch.fleet.workload import Request
from repro_torch.serving.api import InferenceRequest, RequestHandle

__all__ = ["FleetClient"]


class FleetClient:
    """Open-loop facade over a ``FleetRuntime``: submit -> stream -> cancel.

    ``auto_warmup`` (default True) prepares the tiers' steps on the first
    tick when the runtime config asks for warmup — the same behavior
    ``run()`` has.
    """

    def __init__(self, runtime: FleetRuntime, *, auto_warmup: bool = True):
        self.runtime = runtime
        self.handles: Dict[int, RequestHandle] = {}
        self._auto_warmup = auto_warmup
        # (rid, replica_name) -> tokens that replica has emitted so far;
        # the position-based reconciliation cursor for hedges and retries
        self._progress: Dict[Tuple[int, str], int] = {}
        runtime.attach_sink(self)

    # -- intake ---------------------------------------------------------------
    def submit(self, request: InferenceRequest) -> RequestHandle:
        """Enter one request into the fleet (it joins the dispatcher
        backlog at the next tick) and return its streaming handle."""
        rid = self.runtime.new_rid()
        self.runtime.submit(Request(
            rid=rid, arrival_t=self.runtime.t, prompt=request.prompt_2d(),
            max_new=int(request.max_new), slo_class=request.slo_class,
            priority=request.priority, deadline_s=request.deadline_s,
            model=request.model,
        ))
        handle = RequestHandle(request, rid, self, self.runtime.t)
        self.handles[rid] = handle
        return handle

    def adopt_workload(self) -> List[RequestHandle]:
        """Create handles for every trace request the runtime has not yet
        admitted — how a pre-built workload (``build_demo_fleet`` et al.)
        gets streamed: adopt, then ``drain()`` or iterate ``tokens()``."""
        out: List[RequestHandle] = []
        for wreq in self.runtime.workload[self.runtime._wl_idx:]:
            if wreq.rid in self.handles:
                continue
            ireq = InferenceRequest(
                prompt=wreq.prompt, max_new=wreq.max_new,
                slo_class=wreq.slo_class, priority=wreq.priority,
                deadline_s=wreq.deadline_s, model=wreq.model,
            )
            handle = RequestHandle(ireq, wreq.rid, self, wreq.arrival_t)
            self.handles[wreq.rid] = handle
            out.append(handle)
        return out

    # -- progression ----------------------------------------------------------
    def tick(self) -> None:
        """Advance the fleet one control-loop tick; handles are fed via the
        sink callbacks the runtime fires mid-tick."""
        if self._auto_warmup and self.runtime.cfg.warmup:
            self.runtime.warmup()          # no-op once warmed
        self.runtime.tick()

    def _drive(self) -> None:
        """What starved handle iterators (``tokens()``/``result()``) call.
        Honors the runtime's tick budget: a fleet that cannot drain (the
        situation ``max_ticks`` exists for) raises instead of spinning the
        iterator forever past the documented stopping rule."""
        if self.runtime.ticks >= self.runtime.cfg.max_ticks:
            raise RuntimeError(
                f"fleet tick budget exhausted ({self.runtime.ticks} ticks) "
                "with requests still pending")
        self.tick()

    @property
    def idle(self) -> bool:
        return not self.runtime.busy

    def drain(self) -> None:
        """Tick until the fleet is idle (or the runtime's tick budget is
        exhausted — mirrors ``FleetRuntime.run``'s stopping rule)."""
        while (not self.idle
               and self.runtime.ticks < self.runtime.cfg.max_ticks):
            self.tick()

    def cancel(self, handle: Union[RequestHandle, int]) -> bool:
        h = handle if isinstance(handle, RequestHandle) else self.handles.get(handle)
        if h is None:
            return False                   # unknown rid: nothing to cancel
        hit = self.runtime.cancel(h.rid)
        if hit:
            h._cancelled(self.runtime.t)
        return hit

    # -- runtime sink protocol ------------------------------------------------
    def on_tokens(self, rid: int, toks: Sequence[int], replica: str,
                  t: float) -> None:
        handle = self.handles.get(rid)
        if handle is None or handle.done:
            return
        key = (rid, replica)
        start = self._progress.get(key, 0)       # this replica's position
        self._progress[key] = start + len(toks)
        have = handle.delivered
        if start + len(toks) <= have:
            return                               # wholly replayed (retry/twin)
        handle._feed(toks[max(0, have - start):], t)

    def on_complete(self, rid: int, toks: np.ndarray,
                    rec: RequestRecord) -> None:
        handle = self.handles.get(rid)
        if handle is not None:
            handle._finish(toks, rec.complete_t, tier=rec.tier,
                           replica=rec.replica, retries=rec.retries)
        self._forget(rid)

    def on_drop(self, rid: int, t: float, reason: str = "") -> None:
        handle = self.handles.get(rid)
        if handle is not None:
            handle._fail(t, reason)
        self._forget(rid)

    def _forget(self, rid: int) -> None:
        for key in [k for k in self._progress if k[0] == rid]:
            del self._progress[key]

    # -- convenience ----------------------------------------------------------
    def record_of(self, rid: int) -> Optional[RequestRecord]:
        h = self.handles.get(rid)
        return h.record if h is not None else None

    @property
    def tracer(self):
        """The runtime's flight recorder (``repro_torch.obs.Tracer``)."""
        return self.runtime.tracer

    def export_trace(self, path: str) -> int:
        """Dump the runtime's event trace as JSONL (the format
        ``tools/trace_export.py`` converts to a Chrome/Perfetto timeline);
        returns the event count."""
        return self.runtime.tracer.dump_jsonl(path)
