"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

GQA (G 16), head_dim 128, a 128k vocabulary, an untied ``lm_head``, bf16.
[arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    subquadratic=False,
)
