"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000.

MoE: 128 experts top-2 PLUS a dense SwiGLU residual of 7168 in parallel
(Snowflake Arctic's dense-MoE hybrid); full attention (G 7, head_dim
128), untied head, bf16.  [hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dense_residual_ff=7168,
    subquadratic=False,
)
