"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.

GQA (G 12) + RoPE, head_dim 128, a GELU MLP (``w_up`` → gelu → ``w_down``),
an untied ``lm_head``, bf16.  [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49_152,
    rope_theta=100_000.0,
    mlp_type="gelu",
    subquadratic=False,
)
