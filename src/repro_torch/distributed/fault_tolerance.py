"""Failure detection for the fleet runtime and step-level resilience for
the trainer.

The port's copies of ``HeartbeatMonitor`` (deadline-based liveness of
worker ids, which the fleet's missed-pump detector reads), ``StepGuard``
and ``StragglerPolicy`` from the JAX package's
``distributed/fault_tolerance.py``.  The module's mesh parts
(``elastic_mesh``, ``ElasticMesh``) belong to the distributed training
runtime and are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


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


# ---------------------------------------------------------------------------
# step-level resilience
# ---------------------------------------------------------------------------


class StepStateLost(RuntimeError):
    """A step failed after it began to write its state in place: rerunning
    it would update part of the state twice, so only a restore helps."""


@dataclass
class StepGuard:
    """Retry/skip wrapper around one training step.

    Non-finite loss or a raised exception consumes one retry (same batch),
    then one skip (move on).  Exceeding ``max_skips`` raises: at that point
    the job should restore from the last checkpoint.  The loss is read from
    the metrics dict that ends the step's tuple.  ``StepStateLost`` passes
    through at once (a step that wrote part of its state in place is not
    safe to rerun); ``last_error`` keeps the exception behind the last
    retry or skip.
    """

    max_retries: int = 1
    max_skips: int = 10
    skipped: int = 0
    last_error: Optional[BaseException] = None

    def run(self, step_fn: Callable, *args):
        attempts = 0
        while True:
            try:
                out = step_fn(*args)
                metrics = out[-1] if isinstance(out, tuple) and out else None
                loss = metrics.get("loss") if isinstance(metrics, dict) else None
                if loss is not None and not np.isfinite(float(loss)):
                    raise FloatingPointError(f"non-finite loss {float(loss)}")
                return out
            except StepStateLost:
                raise
            except Exception as e:
                self.last_error = e
                attempts += 1
                if attempts <= self.max_retries:
                    continue
                self.skipped += 1
                if self.skipped > self.max_skips:
                    raise
                return None  # caller skips this batch


@dataclass
class StragglerPolicy:
    """EWMA step-time deadline; flags steps exceeding factor x EWMA."""

    factor: float = 3.0
    alpha: float = 0.1
    ewma_s: Optional[float] = None
    flagged: int = 0

    def observe(self, step_time_s: float) -> bool:
        if self.ewma_s is None:
            self.ewma_s = step_time_s
            return False
        slow = step_time_s > self.factor * self.ewma_s
        if slow:
            self.flagged += 1
        else:
            self.ewma_s = self.alpha * step_time_s + (1 - self.alpha) * self.ewma_s
        return slow

    @property
    def deadline_s(self) -> Optional[float]:
        return None if self.ewma_s is None else self.factor * self.ewma_s
