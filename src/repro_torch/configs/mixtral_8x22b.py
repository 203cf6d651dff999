"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.

MoE 8 experts top-2 + sliding-window attention (W 4096, G 6, head_dim
128), untied head, bf16.  [arXiv:2401.04088; hf]  The window bounds the
KV cache to a ring of ``min(max_len, 4096)`` rows.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    subquadratic=True,
)
