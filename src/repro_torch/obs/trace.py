"""Ring-buffered structured event tracer on the control-loop clock.

One ``Tracer`` per runtime; every event is a flat dict (``t``, ``name``,
``cat``, plus free-form args) appended to a bounded ring — the hot path is
one dict construction and one deque append, cheap enough to leave on in
production runs.  High-frequency channels (per-pump engine timings, KV
store traffic) pass ``sampled=True`` and are decimated by a deterministic
stride, so the overhead knob is one number (``sample``); lifecycle and
control-plane events are never sampled (the exporters' coverage guarantee
depends on them).

Event taxonomy (the ``cat`` field):

* ``req``    — request lifecycle: ``req.queued`` → ``req.dispatched`` →
  ``req.admitted``/``req.first_token`` → ``req.completed`` (or
  ``req.requeued`` → ``req.dispatched`` again after a replica death, or
  ``req.cancelled``/``req.failed``/``req.hedged``).  Args carry
  tier/replica/slot attribution.
* ``ctl``    — control plane: ``ctl.mode_switch`` (with the full signal
  vector), ``ctl.scale``, ``ctl.replica_fail``, ``ctl.preempt_notice``,
  ``ctl.preempt_deadline``, ``ctl.wedge_death``, ``ctl.crash_backoff``,
  ``ctl.kv_flush``, ``ctl.kv_restore``, ``ctl.speculation`` (the mode
  controller retuned a tier's speculative draft depth k),
  ``replica.*`` state transitions.
* ``engine`` — data plane: ``engine.pump`` (admission/dispatch/host-sync
  phase walls), ``engine.speculate`` (drafted/accepted token counts for
  the pump's speculative rounds — rides next to the pump it happened in),
  ``engine.compile`` (a step bucket warmup did not prepare),
  ``engine.capture`` (graphs a replica's session captured on a pump, and
  their host seconds).
* ``kv``     — fleet KV store traffic (``kv.put``/``kv.hit``/``kv.evict``).

Timestamps are whatever clock the owner installs — the fleet runtime uses
control-loop seconds; bare-engine clients use wall time.  JSONL export
(one event per line) is the on-disk interchange format
``tools/trace_export.py`` and ``tools/fleet_top.py`` consume.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional

import numpy as np

__all__ = ["Tracer", "Span", "request_chains", "validate_chain"]

# request-lifecycle event names that open a span on a replica track
_TERMINAL = ("req.completed", "req.cancelled", "req.failed")


def _json_default(o: Any):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, (tuple, set)):
        return list(o)
    return str(o)


class Span:
    """An open interval handed out by ``Tracer.begin``; ``end()`` records
    one event at the START time with a ``dur`` arg (Chrome-trace 'X'
    semantics).  Ending twice is a no-op."""

    __slots__ = ("_tracer", "name", "cat", "t0", "args", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str, t0: float,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.args = args
        self._done = False

    def end(self, t: Optional[float] = None, **more: Any) -> None:
        if self._done:
            return
        self._done = True
        t1 = self._tracer._now(t)
        self._tracer.event(self.name, t=self.t0, cat=self.cat,
                           dur=max(0.0, t1 - self.t0), **self.args, **more)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class Tracer:
    """Bounded structured event log.

    ``capacity`` bounds memory (oldest events fall off the ring — the
    ``dropped`` counter says how many); ``sample`` in (0, 1] decimates
    events recorded with ``sampled=True`` by a deterministic stride;
    ``clock`` supplies timestamps for events that don't pass ``t=``
    explicitly (the fleet runtime installs its control-loop clock)."""

    def __init__(self, capacity: int = 1 << 16, *, sample: float = 1.0,
                 clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if not 0.0 < sample <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {sample}")
        self.capacity = int(capacity)
        self.sample = float(sample)
        self._stride = max(1, round(1.0 / sample))
        self.clock = clock or (lambda: 0.0)
        self.enabled = enabled
        self.events: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self.emitted = 0          # total recorded (ring wrap drops oldest)
        self.sampled_out = 0      # high-frequency events the stride skipped
        self._hf_n = 0

    @classmethod
    def disabled(cls) -> "Tracer":
        """A no-op tracer: every emit site stays unconditional, the
        overhead gate measures this arm as the baseline."""
        return cls(capacity=1, enabled=False)

    def _now(self, t: Optional[float]) -> float:
        return float(t) if t is not None else float(self.clock())

    # -- the hot path --------------------------------------------------------
    def event(self, name: str, *, t: Optional[float] = None, cat: str = "ctl",
              sampled: bool = False, **args: Any) -> bool:
        """Record one event; returns False when disabled or sampled out."""
        if not self.enabled:
            return False
        if sampled:
            self._hf_n += 1
            if self._hf_n % self._stride:
                self.sampled_out += 1
                return False
        ev = {"t": self._now(t), "name": name, "cat": cat}
        if args:
            ev.update(args)
        self.events.append(ev)
        self.emitted += 1
        return True

    def begin(self, name: str, *, t: Optional[float] = None, cat: str = "ctl",
              **args: Any) -> Span:
        """Open a ``Span``; its ``end()`` records the event with ``dur``."""
        return Span(self, name, cat, self._now(t), args)

    # -- introspection -------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events lost to ring wrap (emitted but no longer held)."""
        return self.emitted - len(self.events)

    def select(self, *, cat: Optional[str] = None,
               name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events
                if (cat is None or e["cat"] == cat)
                and (name is None or e["name"] == name)]

    def to_list(self) -> List[Dict[str, Any]]:
        return list(self.events)

    # -- export --------------------------------------------------------------
    def dump_jsonl(self, path: str) -> int:
        """Write the ring as JSONL (one event per line); returns the event
        count.  Numpy values serialize as plain lists/scalars."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev, default=_json_default) + "\n")
        return len(self.events)


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read a ``dump_jsonl`` trace back (blank lines ignored)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# Request span chains (shared by the Chrome-trace exporter and the drill
# audit assertions)
# ---------------------------------------------------------------------------


def request_chains(events: Iterable[Dict[str, Any]]
                   ) -> Dict[int, List[Dict[str, Any]]]:
    """Group ``req.*`` lifecycle events by rid, each chain sorted by time
    (stable, so same-tick ordering preserves emission order)."""
    chains: Dict[int, List[Dict[str, Any]]] = {}
    for ev in events:
        if ev.get("cat") == "req" and "rid" in ev:
            chains.setdefault(int(ev["rid"]), []).append(ev)
    for chain in chains.values():
        chain.sort(key=lambda e: e["t"])
    return chains


def validate_chain(chain: List[Dict[str, Any]]) -> List[str]:
    """Audit one request's lifecycle chain; returns the list of violations
    (empty == contiguous).  The rules the failover/recovery drills assert:

    * exactly one ``req.queued``, and nothing precedes it;
    * every ``req.dispatched`` after the first is preceded by a
      ``req.requeued`` (the replica it left) — a request never lands on a
      second replica without the trace recording why it left the first;
    * every ``req.requeued`` names the replica of a prior dispatch;
    * at most one terminal event, nothing after it, and a completed
      request's terminal replica matches its last dispatch (hedge twins:
      the hedge replica counts as a dispatch).
    """
    problems: List[str] = []
    names = [e["name"] for e in chain]
    if names.count("req.queued") != 1:
        problems.append(f"expected exactly one req.queued, got "
                        f"{names.count('req.queued')}")
    elif names[0] != "req.queued":
        problems.append(f"chain starts with {names[0]}, not req.queued")
    dispatched_to: List[str] = []     # replicas dispatched to, in order
    requeues_pending = 0
    terminal_seen: Optional[str] = None
    for ev in chain:
        name = ev["name"]
        if terminal_seen is not None and ev.get("cat") == "req":
            problems.append(f"{name} after terminal {terminal_seen}")
            break
        if name in ("req.dispatched", "req.hedged"):
            rep = str(ev.get("replica", ""))
            if name == "req.dispatched" and dispatched_to:
                if requeues_pending <= 0:
                    problems.append(
                        f"re-dispatch to {rep} without a req.requeued")
                else:
                    requeues_pending -= 1
            dispatched_to.append(rep)
        elif name == "req.requeued":
            src = str(ev.get("replica", ""))
            if src not in dispatched_to:
                problems.append(f"requeued from {src}, never dispatched there")
            requeues_pending += 1
        elif name in _TERMINAL:
            terminal_seen = name
            if name == "req.completed":
                rep = str(ev.get("replica", ""))
                if dispatched_to and rep not in dispatched_to:
                    problems.append(
                        f"completed on {rep}, dispatched to {dispatched_to}")
                if not dispatched_to:
                    problems.append("completed without any dispatch")
    return problems
