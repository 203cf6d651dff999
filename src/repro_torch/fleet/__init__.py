"""Fleet runtime of the port: the paper's control loop closed over live
replicas of port engines (the counterpart of the JAX package's ``fleet``).

Three fidelities of the control loop:

  * ``core/`` — the analytic simulator: M/D/c latency formulas and Table-1
    ``t_max`` constants;
  * ``fleet/`` — THIS layer: a runtime hosting many ``ServingEngine``
    replicas across heterogeneous tiers, running ``ModeController`` +
    ``Autoscaler`` + ``CapacityPool`` against *measured* per-replica
    signals — the live replacement for the analytic ``t_max``;
  * ``serving/`` — one replica's data plane on the card.

The fleet runtime is request-granular: every request is dispatched,
retried on replica death, and accounted individually (``RequestLog``).
"""
from repro_torch.fleet.client import FleetClient  # noqa: F401
from repro_torch.fleet.dispatcher import Dispatcher  # noqa: F401
from repro_torch.fleet.forecast import SeasonalForecaster  # noqa: F401
from repro_torch.fleet.kv_store import KVStore, KVStoreStats  # noqa: F401
from repro_torch.fleet.replica import Replica, ReplicaState  # noqa: F401
from repro_torch.fleet.runtime import (  # noqa: F401
    TIER_CLASSES,
    FailureEvent,
    FleetConfig,
    FleetReport,
    FleetRuntime,
    PreemptionEvent,
    TierClassSpec,
    TierSpec,
    build_day_fleet,
    build_demo_fleet,
    build_recovery_fleet,
)
from repro_torch.fleet.telemetry import Ewma, TelemetryBus  # noqa: F401
from repro_torch.fleet.workload import (  # noqa: F401
    BATCH,
    INTERACTIVE,
    SLO_TARGETS,
    Request,
    SLOClass,
    day_cycle_rate,
    day_cycle_trace,
    poisson_trace,
)
