"""Decoder transformer of the serving path: layer modules, seeded init,
the decode and mixed layer loops, and the tied-embedding logits.

Counterpart of the JAX package's ``models/transformer.py`` for the dense
family.  The JAX stack scans over stacked (L, ...) leaves and builds the
fused ``wqkv``/``w_gu`` once per jitted dispatch; the port keeps one
``DecoderLayer`` module per layer, holding those fused matrices from the
moment weights load, so no step ever rebuilds them.  The layer loops are
Python loops; each layer writes its KV slice in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers


class DecoderLayer(nn.Module):
    """ln1 → attention → residual → ln2 → SwiGLU (fused [w_gate|w_up])."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, **kw), requires_grad=False)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, **kw), requires_grad=False)
        self.attn = attention.Attention(cfg, device=device, dtype=dtype)
        self.w_gu = nn.Parameter(torch.empty(cfg.d_model, 2 * cfg.d_ff, **kw), requires_grad=False)
        self.w_down = nn.Parameter(torch.empty(cfg.d_ff, cfg.d_model, **kw), requires_grad=False)


def check_supported(cfg: ModelConfig) -> None:
    """The port serves the dense token-LM family with SwiGLU for now."""
    if (cfg.family != "dense" or cfg.is_moe or cfg.mlp_type != "swiglu"
            or cfg.input_mode != "tokens" or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: only the dense SwiGLU token-LM family with tied embeddings is ported "
            f"(family {cfg.family!r}, mlp {cfg.mlp_type!r})")
    if cfg.sliding_window > 0:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not ported yet (it comes with mixtral)")


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` with N(0, std²) drawn in fp32 and cast, as the JAX init
    (``normal(fp32) * s`` then ``astype``) does."""
    t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                        dtype=torch.float32).mul_(std))


@torch.no_grad()
def init_layer_(layer: DecoderLayer, cfg: ModelConfig, generator: torch.Generator) -> None:
    """Seeded random init of one layer: every matrix N(0, 1/fan_in) as
    ``dense_init``, norms at one.  q/k/v share fan-in d_model, so the fused
    ``wqkv`` is drawn in one piece; likewise ``w_gu``."""
    d = cfg.d_model
    _normal_(layer.attn.wqkv, 1.0 / math.sqrt(d), generator)
    _normal_(layer.attn.wo, 1.0 / math.sqrt(cfg.q_dim), generator)
    _normal_(layer.w_gu, 1.0 / math.sqrt(d), generator)
    _normal_(layer.w_down, 1.0 / math.sqrt(cfg.d_ff), generator)
    layer.ln1.fill_(1.0)
    layer.ln2.fill_(1.0)
    if layer.attn.qk_norm is not None:
        layer.attn.qk_norm.fill_(1.0)


def _mlp(layer: DecoderLayer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = layers.rms_norm(x, layer.ln2, cfg.norm_eps)
    return x + layers.swiglu_fused(h, layer.w_gu, layer.w_down)


def run_layers_decode(
    layer_list: nn.ModuleList,
    x: torch.Tensor,               # (B, 1, d)
    cache_k: torch.Tensor,         # (L, B, S, Hkv, Dh), written in place
    cache_v: torch.Tensor,
    cache_len: torch.Tensor,       # (B,) int32
    cfg: ModelConfig,
) -> torch.Tensor:
    for li, layer in enumerate(layer_list):
        h = layers.rms_norm(x, layer.ln1, cfg.norm_eps)
        x = x + attention.attention_decode(
            layer.attn, h, attention.KVCache(cache_k[li], cache_v[li]), cache_len, cfg)
        x = _mlp(layer, x, cfg)
    return x


def run_layers_mixed(
    layer_list: nn.ModuleList,
    x: torch.Tensor,               # (B, Q, d) — ragged new-token suffixes
    cache_k: torch.Tensor,         # (L, B, S, Hkv, Dh), written in place
    cache_v: torch.Tensor,
    cache_lens: torch.Tensor,      # (B,) int32 tokens already cached
    write_index: Tuple[torch.Tensor, torch.Tensor],
    cfg: ModelConfig,
    attn_window: Optional[int] = None,
) -> torch.Tensor:
    """``run_layers_decode`` generalised to a ragged q-chunk per slot."""
    for li, layer in enumerate(layer_list):
        h = layers.rms_norm(x, layer.ln1, cfg.norm_eps)
        x = x + attention.attention_mixed(
            layer.attn, h, attention.KVCache(cache_k[li], cache_v[li]), cache_lens, cfg,
            write_index, attn_window=attn_window)
        x = _mlp(layer, x, cfg)
    return x


def logits_from_hidden(embed: torch.Tensor, final_norm: torch.Tensor, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """Final norm, then the tied-embedding head: (B, S, d) -> (B, S, V)."""
    x = layers.rms_norm(x, final_norm, cfg.norm_eps)
    return x @ embed.T
