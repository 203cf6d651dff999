"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Mistral-7B decoder backbone (G 4, head_dim 128, untied ``lm_head``).  The
anyres-tiling vision frontend is a stub: a prefill takes precomputed patch
embeddings (B, Np, d), concatenated ahead of the token embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    input_mode="tokens",   # text tokens + prepended patch embeds (stub frontend)
    subquadratic=False,
)

# anyres stub geometry: number of image patch embeddings prepended per sample.
N_PATCH_EMBEDS = 576
