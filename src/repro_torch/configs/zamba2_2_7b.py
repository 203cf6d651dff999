"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240, ssm_state=64.

Mamba2 backbone (80 SSM heads of 64, state 64, conv width 4) with a SHARED
full-attention + SwiGLU block applied every 6 layers (weights shared
across applications), head_dim 80, an untied ``lm_head``, bf16.
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    attention_every=6,
    subquadratic=True,
)
