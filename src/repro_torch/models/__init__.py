from repro_torch.models.model import DecoderKVCache, Model  # noqa: F401
from repro_torch.models.rwkv6 import RWKVLayerCache  # noqa: F401
from repro_torch.models.mamba2 import Mamba2LayerCache  # noqa: F401
from repro_torch.models.zamba2 import Zamba2Cache  # noqa: F401
