from repro_torch.serving.api import (  # noqa: F401
    EngineClient,
    InferenceRequest,
    RequestHandle,
    RequestStatus,
)
from repro_torch.serving.backends import CacheBackend, StateFrontier  # noqa: F401
from repro_torch.serving.diffusion import (  # noqa: F401
    DiffusionConfig,
    DiffusionEngine,
    DiffusionSession,
)
from repro_torch.serving.engine import (  # noqa: F401
    DecodeSlots,
    EngineConfig,
    EngineTelemetry,
    PumpReport,
    QueueSession,
    ServingEngine,
)
from repro_torch.serving.paged_kv import BlockAllocator, KVFrontier  # noqa: F401
from repro_torch.serving.spec import (  # noqa: F401
    Drafter,
    NgramDrafter,
    spec_quantum,
    verify_tokens,
)
