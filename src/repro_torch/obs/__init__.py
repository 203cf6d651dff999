"""Fleet flight recorder: structured event tracing, histogram metrics, and
the controller decision audit.

Three pieces, deliberately dependency-free (stdlib + numpy only) so every
layer of the stack — engine, replica, dispatcher, runtime, client — can
emit without import cycles:

* ``trace`` — ``Tracer``/``Span``: a ring-buffered structured event log on
  the control-loop clock.  Request lifecycle, control-plane actions, and
  engine internals all land in one stream; exporters (JSONL, Chrome trace)
  read it back out.
* ``metrics`` — ``MetricsRegistry``: counter / gauge / histogram families
  with fixed log-spaced buckets and Prometheus-style text exposition, so
  TTFT/TPOT/pump-wall get real p50/p90/p99 instead of EWMA-only.
* ``audit`` — ``DecisionRecord``: one frozen snapshot of every controller
  mode switch WITH the signal vector that caused it; ``explains()``
  recomputes the binary step from the recorded inputs, which the
  failover/recovery drills assert against.
"""
from repro_torch.obs.audit import CAPACITY_OPTIMIZED, COST_OPTIMIZED, DecisionRecord
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_buckets,
)
from repro_torch.obs.trace import Span, Tracer, request_chains, validate_chain

__all__ = [
    "CAPACITY_OPTIMIZED",
    "COST_OPTIMIZED",
    "Counter",
    "DecisionRecord",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "log_buckets",
    "request_chains",
    "validate_chain",
]
