from repro_torch.models.model import DecoderKVCache, Model  # noqa: F401
