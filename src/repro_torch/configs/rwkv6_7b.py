"""rwkv6-7b [rwkv] — 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.

RWKV-6 "Finch": linear attention with data-dependent per-channel decay,
64 heads of 64, an untied ``lm_head``, bf16.  [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65_536,
    rwkv_head_dim=64,
    subquadratic=True,
)
