"""Zamba2 hybrid of the serving path: a Mamba-2 backbone and ONE shared
attention block.

Counterpart of the JAX package's ``models/zamba2.py``.  ``n_layers``
Mamba-2 layers run in groups of ``attention_every``; after each group the
shared full-attention + SwiGLU block runs, the same weights at every
application (zamba2's parameter sharing; the released model's
per-application LoRA adapters are omitted, as in JAX).  The shared block
is one ``transformer.DecoderLayer`` (ln1, fused ``wqkv``, ``wo``, ln2,
fused ``w_gu``, ``w_down``) held once and applied ``n_groups`` times.

Caches: the stacked Mamba-2 conv tails and states (L, B, ...) and one KV
cache per application (G, B, Sc, Hkv, Dh): each application attends over
its own history.  The layer loops are Python loops; ``run_zamba2_decode``
updates every leaf in place, where the JAX engine donates the cache, and
``run_zamba2_train``, the training loop, keeps no cache and rematerialises
each Mamba-2 layer and each shared application (JAX checkpoints each
Mamba-2 layer and each group).  The
shared block's norms run through ``kernels.rmsnorm.ops``: ln1 in the plain
form, and the residual add + ln2 as the fused form (``x + a`` summed in
fp32 and normalised before it is rounded; in fp32 this is JAX's
``x = x + a; rms_norm(x)``, in bf16 it agrees within bf16 rounding).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.models import attention, layers, mamba2
from repro_torch.models.transformer import DecoderLayer, remat


class Zamba2Cache(NamedTuple):
    conv: torch.Tensor       # (L, B, K-1, conv_ch)
    state: torch.Tensor      # (L, B, H, P, N) fp32
    attn_k: torch.Tensor     # (G, B, Sc, Hkv, Dh)
    attn_v: torch.Tensor


def n_groups(cfg: ModelConfig) -> int:
    if not cfg.attention_every or cfg.n_layers % cfg.attention_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a whole number of "
                         f"groups of attention_every={cfg.attention_every}")
    return cfg.n_layers // cfg.attention_every


def _mlp_after_attention(shared: DecoderLayer, x: torch.Tensor, a: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    """x + a, then ln2 (one fused kernel), then x + SwiGLU."""
    h, x = norm_ops.rmsnorm(a, shared.ln2, x, eps=cfg.norm_eps)
    return x + layers.swiglu_fused(h, shared.w_gu, shared.w_down)


def _shared_block_seq(shared: DecoderLayer, x: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, attention.KVCache]:
    """The shared block over a whole (B, S, d) prompt; returns x and the
    application's prompt KV (B, S, Hkv, Dh)."""
    h = norm_ops.rms_norm(x, shared.ln1, cfg.norm_eps)
    a, cache = attention.attention_block(shared.attn, h, cfg)
    return _mlp_after_attention(shared, x, a, cfg), cache


def run_zamba2_seq(layer_list: nn.ModuleList, shared: DecoderLayer, x: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Zamba2Cache]:
    """The prefill layer loop over x (B, S, d).  Returns x and the cache:
    conv tails and final states of every Mamba-2 layer, and the prompt KV
    (G, B, S, Hkv, Dh) of every shared application."""
    B, S, _ = x.shape
    G, Lg = n_groups(cfg), cfg.attention_every
    m = mamba2.empty_cache(cfg, len(layer_list), B, x.dtype, x.device)
    shape = (G, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    ks = torch.empty(shape, dtype=x.dtype, device=x.device)
    vs = torch.empty(shape, dtype=x.dtype, device=x.device)
    for g in range(G):
        for li in range(g * Lg, (g + 1) * Lg):
            x, c = mamba2.mamba2_layer(layer_list[li], x, cfg)
            m.conv[li].copy_(c.conv)
            m.state[li].copy_(c.state)
        x, kv = _shared_block_seq(shared, x, cfg)
        ks[g].copy_(kv.k)
        vs[g].copy_(kv.v)
    return x, Zamba2Cache(conv=m.conv, state=m.state, attn_k=ks, attn_v=vs)


def _mamba2_layer_train(layer: mamba2.Mamba2Layer, x: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    return mamba2.mamba2_layer(layer, x, cfg)[0]


def _shared_block_train(shared: DecoderLayer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _shared_block_seq(shared, x, cfg)[0]


def run_zamba2_train(layer_list: nn.ModuleList, shared: DecoderLayer, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """The training layer loop over x (B, S, d), differentiable: no cache,
    every Mamba-2 layer and every shared application rematerialised
    (``transformer.remat``)."""
    G, Lg = n_groups(cfg), cfg.attention_every
    for g in range(G):
        for li in range(g * Lg, (g + 1) * Lg):
            x = remat(_mamba2_layer_train, layer_list[li], x, cfg)
        x = remat(_shared_block_train, shared, x, cfg)
    return x


def run_zamba2_decode(layer_list: nn.ModuleList, shared: DecoderLayer, x: torch.Tensor,
                      cache: Zamba2Cache, cache_len: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """One token x (B, 1, d) through every layer at the per-slot lengths
    ``cache_len`` (B,) int32; writes each Mamba-2 layer's new conv tail and
    state and each application's new KV row into ``cache`` in place."""
    G, Lg = n_groups(cfg), cfg.attention_every
    for g in range(G):
        for li in range(g * Lg, (g + 1) * Lg):
            x, c = mamba2.mamba2_layer_decode(
                layer_list[li], x, cfg, mamba2.Mamba2LayerCache(cache.conv[li], cache.state[li]))
            cache.conv[li].copy_(c.conv)
            cache.state[li].copy_(c.state)
        h = norm_ops.rms_norm(x, shared.ln1, cfg.norm_eps)
        a = attention.attention_decode(
            shared.attn, h, attention.KVCache(cache.attn_k[g], cache.attn_v[g]), cache_len, cfg)
        x = _mlp_after_attention(shared, x, a, cfg)
    return x


def empty_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                device) -> Zamba2Cache:
    """The zeroed decode cache: conv tails and states of every layer, and a
    (G, B, max_len, Hkv, Dh) KV pair for the shared applications."""
    m = mamba2.empty_cache(cfg, cfg.n_layers, batch, dtype, device)
    shape = (n_groups(cfg), batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return Zamba2Cache(conv=m.conv, state=m.state,
                       attn_k=torch.zeros(shape, dtype=dtype, device=device),
                       attn_v=torch.zeros(shape, dtype=dtype, device=device))
