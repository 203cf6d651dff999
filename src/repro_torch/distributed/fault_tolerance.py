"""Failure detection for the fleet runtime.

The port's copy of ``HeartbeatMonitor`` from the JAX package's
``distributed/fault_tolerance.py``: deadline-based liveness of worker ids,
which the fleet's missed-pump detector reads.  The module's mesh parts
(``elastic_mesh``, ``ElasticMesh``, ``StepGuard``, ``StragglerPolicy``)
belong to the distributed training runtime and are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class HeartbeatMonitor:
    """Deadline-based liveness tracking for worker ids."""

    deadline_s: float = 60.0
    _last: Dict[int, float] = field(default_factory=dict)

    def beat(self, worker: int, t: Optional[float] = None) -> None:
        self._last[worker] = time.monotonic() if t is None else t

    def dead(self, t: Optional[float] = None) -> List[int]:
        now = time.monotonic() if t is None else t
        return sorted(w for w, lt in self._last.items() if now - lt > self.deadline_s)

    def alive(self, t: Optional[float] = None) -> List[int]:
        now = time.monotonic() if t is None else t
        return sorted(w for w, lt in self._last.items() if now - lt <= self.deadline_s)

    def forget(self, worker: int) -> None:
        """Stop tracking a worker that left on purpose (drain/terminate) —
        otherwise its last beat ages into a false death."""
        self._last.pop(worker, None)
