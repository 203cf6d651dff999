"""Full attention block of the serving path: fused qkv, qk-norm, RoPE, GQA
against a contiguous KV cache.

Counterpart of the JAX package's ``models/attention.py`` for full
attention on the contiguous cache (the sliding-window ring and the paged
pool come with later slices).  The cache is a per-layer (B, S_max, Hkv,
Dh) pair updated IN PLACE — where the JAX engine donated the buffer to
its jitted step, the port writes into it.

On a CUDA tensor the attention itself always runs the hand-written
kernels (``kernels.decode_attention.ops``); on a CPU tensor their plain
versions.  There is no ``use_pallas``-style switch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops
from repro_torch.models import layers


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, Hkv, Dh)
    v: torch.Tensor


class Attention(nn.Module):
    """One layer's attention weights, with q/k/v fused at load time:
    ``wqkv`` = [wq | wk | wv] (d, q_dim + 2·kv_dim); ``qk_norm`` is the
    (Hq + Hkv, Dh) per-head norm weight [q_norm × Hq ; k_norm × Hkv]."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        hd = cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype)
        self.wqkv = nn.Parameter(torch.empty(cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim, **kw),
                                 requires_grad=False)
        self.wo = nn.Parameter(torch.empty(cfg.q_dim, cfg.d_model, **kw), requires_grad=False)
        self.qk_norm = (nn.Parameter(torch.ones(cfg.n_heads + cfg.n_kv_heads, hd, **kw),
                                     requires_grad=False)
                        if cfg.qk_norm else None)


def fuse_qkv_weights(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """[wq | wk | wv] as one (d, q_dim + 2·kv_dim) matrix."""
    return torch.cat([wq, wk, wv], dim=-1)


def fuse_qk_norm(q_norm: torch.Tensor, k_norm: torch.Tensor, n_heads: int,
                 n_kv_heads: int) -> torch.Tensor:
    """The (Hq + Hkv, Dh) norm weight of the concatenated q/k head axis."""
    return torch.cat([q_norm.expand(n_heads, -1), k_norm.expand(n_kv_heads, -1)])


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused projection: ONE matmul, then one norm+rope pass over the
    concatenated (Hq + Hkv) head axis.  Returns q (B,S,Hq,Dh), k, v
    (B,S,Hkv,Dh); q and k are views of one buffer."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    qkv = x @ p.wqkv
    q, k, v = qkv.split([cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    qk = torch.cat([q.reshape(B, S, Hq, hd), k.reshape(B, S, Hkv, hd)], dim=2)
    if cfg.qk_norm:
        qk = layers.rms_norm(qk, p.qk_norm, cfg.norm_eps)
    qk = layers.apply_rope(qk, positions, cfg.rope_theta)
    return qk[:, :, :Hq], qk[:, :, Hq:], v.reshape(B, S, Hkv, hd)


def attention_decode(
    p: Attention,
    x: torch.Tensor,            # (B, 1, d) — one new token per slot
    cache: KVCache,             # (B, S, Hkv, Dh), written in place
    cache_len: torch.Tensor,    # (B,) int32 per-slot lengths, on x's device
    cfg: ModelConfig,
) -> torch.Tensor:
    """One decode step: write the new token's KV at ``cache_len[b]``
    (clamped to the last row, as ``dynamic_update_slice`` clamps), then
    attend to the first ``cache_len[b] + 1`` positions."""
    if cache_len.dim() != 1:
        raise ValueError("decode requires (B,) per-slot cache lengths")
    B = x.shape[0]
    S = cache.k.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, cache_len[:, None])
    rows = torch.arange(B, device=x.device)
    write_at = cache_len.clamp(max=S - 1).long()
    cache.k[rows, write_at] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, write_at] = v_new[:, 0].to(cache.v.dtype)
    out = ops.decode_attention(q[:, 0], cache.k, cache.v, cache_len + 1)
    return (out.reshape(B, cfg.q_dim) @ p.wo)[:, None, :]


def mixed_write_index(cache_lens: np.ndarray, new_lens: np.ndarray, Q: int,
                      S: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of a mixed step that land in the cache: chunk row ``i`` of slot
    ``b`` writes position ``cache_lens[b] + i`` iff ``i < new_lens[b]`` and
    the position exists.  Returns (src, dst): flat indices into the
    (B·Q) chunk rows and the (B·S) cache rows — unique, so the copy is
    deterministic.  Padding rows write nothing (the JAX positional select)."""
    cache_lens = np.asarray(cache_lens, np.int64)
    new_lens = np.asarray(new_lens, np.int64)
    i = np.arange(Q)[None, :]
    pos = cache_lens[:, None] + i
    keep = (i < new_lens[:, None]) & (pos < S)
    b, col = np.nonzero(keep)
    return b * Q + col, b * S + pos[b, col]


def attention_mixed(
    p: Attention,
    x: torch.Tensor,               # (B, Q, d) — Q new tokens per slot
    cache: KVCache,                # (B, S, Hkv, Dh), written in place
    cache_lens: torch.Tensor,      # (B,) int32 tokens already cached, on x's device
    cfg: ModelConfig,
    write_index: Tuple[torch.Tensor, torch.Tensor],   # mixed_write_index, on device
    *,
    attn_window: Optional[int] = None,
) -> torch.Tensor:
    """One mixed-batch step: every slot advances by its own ragged suffix.
    Only rows ``i < new_lens[b]`` write KV (``write_index``); query ``i``
    attends to every position ``<= cache_lens[b] + i``.  ``attn_window``
    bounds the cache span read: the kernel takes the ``[:, :W]`` view in
    place through its batch stride (no copy)."""
    B, Q, _ = x.shape
    S = cache.k.shape[1]
    positions = cache_lens[:, None] + torch.arange(Q, device=x.device, dtype=cache_lens.dtype)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    src, dst = write_index
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        flat = buf.view(B * S, *buf.shape[2:])
        flat.index_copy_(0, dst, new.reshape(B * Q, *new.shape[2:]).index_select(0, src)
                         .to(buf.dtype))
    k_r, v_r = cache.k, cache.v
    if attn_window is not None:
        k_r, v_r = k_r[:, :attn_window], v_r[:, :attn_window]
    out = ops.mixed_attention(q, k_r, v_r, cache_lens)
    return out.reshape(B, Q, cfg.q_dim) @ p.wo

