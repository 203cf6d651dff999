from repro_torch.models.model import DecoderKVCache, Model  # noqa: F401
from repro_torch.models.rwkv6 import RWKVLayerCache  # noqa: F401
