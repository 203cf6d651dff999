from repro_torch.serving.api import (  # noqa: F401
    EngineClient,
    InferenceRequest,
    RequestHandle,
    RequestStatus,
)
from repro_torch.serving.engine import (  # noqa: F401
    DecodeSlots,
    EngineConfig,
    EngineTelemetry,
    PumpReport,
    QueueSession,
    ServingEngine,
)
