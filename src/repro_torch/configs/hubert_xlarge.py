"""hubert-xlarge [encoder] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only transformer backbone (wav2vec2-style): non-causal attention
at head_dim 80, a GELU MLP, a (d, V) ``head``.  The convolutional audio
frontend is a stub: a prefill takes precomputed frame embeddings (B, S,
d_model).  vocab=504 is the masked-prediction codebook size.  No decode.
[arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp_type="gelu",
    causal=False,
    input_mode="embeds",
    supports_decode=False,
    subquadratic=False,
)
