"""``ModelConfig``: architecture hyper-parameters (the port's own copy).

Same fields, derived properties and ``reduce()`` as the JAX package's
``configs/base.py`` (and its ``InputShape``, which the training data
pipeline reads), minus ``use_pallas``: the port has no kernel switch —
attention on a CUDA tensor always runs the hand-written kernels.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

FAMILIES = ("dense", "moe", "rwkv", "hybrid", "encoder", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (one instance per arch)."""

    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # --- attention ---------------------------------------------------------
    n_heads: int = 0                 # 0 for attention-free families
    n_kv_heads: int = 0
    head_dim: int = 0                # explicit (qwen3-style); 0 => d_model//n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 => full attention
    causal: bool = True              # False for encoder-only
    mlp_type: str = "swiglu"         # "swiglu" (3 mats) | "gelu" (2 mats)
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM / RWKV --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    rwkv_head_dim: int = 64
    attention_every: int = 0
    # --- IO ----------------------------------------------------------------
    input_mode: str = "tokens"       # "tokens" | "embeds"
    tie_embeddings: bool = False
    # --- numerics / execution ---------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # --- capability flags --------------------------------------------------
    supports_decode: bool = True     # False for encoder-only
    subquadratic: bool = False       # True => runs long_500k
    # --- distribution defaults --------------------------------------------
    remat: bool = True
    scan_layers: bool = True
    scan_group: int = 0
    seq_parallel: bool = False

    # -- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and sanity)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "encoder":
            emb = v * d
        mlp_mats = 3 if self.mlp_type == "swiglu" else 2
        per_layer = 0
        if self.family in ("dense", "moe", "encoder", "vlm"):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.is_moe:
                ffn = self.n_experts * 3 * d * f + d * self.n_experts
                if self.moe_dense_residual:
                    ffn += 3 * d * (self.dense_residual_ff or f)
            else:
                ffn = mlp_mats * d * f
            per_layer = attn + ffn + 2 * d
        elif self.family == "rwkv":
            per_layer = 5 * d * d + 2 * d * 64 + (d * f + f * d + d * d) + 4 * d
        elif self.family == "hybrid":
            d_inner = 2 * d
            H = d_inner // self.ssm_head_dim
            per_layer = d * (2 * d_inner + 2 * self.ssm_state + H)
            per_layer += 4 * (d_inner + 2 * self.ssm_state)
            per_layer += d_inner * d + d_inner
        n = emb + self.n_layers * per_layer + d
        if self.attention_every:
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            n += 3 * d * f + 2 * d
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * f
        return self.param_count() - inactive

    def reduce(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.attention_every else 4),
            d_model=128,
            d_ff=256,
            vocab_size=512,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            dense_residual_ff=128 if self.moe_dense_residual else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            rwkv_head_dim=32,
            attention_every=2 if self.attention_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
