"""Plain PyTorch versions of the decode-attention kernels (GQA, length-masked).

These are the oracles the CUDA kernels in ``csrc/decode_attention.cu`` are
held against on the card, and what ``ops`` runs for a tensor on the CPU.
Counterparts of the JAX package's ``kernels/decode_attention/ref.py``
(``decode_attention_ref``, ``decode_attention_splitk_ref``,
``mixed_attention_ref``) and of its split-K stages (``kernel.py``
``_splitk_partial_kernel`` / ``_splitk_combine_kernel``).

Numerics follow the TPU kernels: scores and softmax state in fp32, masking
with ``-1e30`` (never ``-inf``), ``p`` cast to V's dtype before the PV
product, the output divided by ``max(l, 1e-30)``.  A split chunk wholly
past the length emits the identity state (m=-1e30, l=0, acc=0).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def _scale(D: int) -> float:
    return 1.0 / math.sqrt(D)


def decode_attention(
    q: torch.Tensor,          # (B, Hq, D) — one new token per sequence
    k_cache: torch.Tensor,    # (B, S, Hkv, D)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,    # (B,) int32 valid prefix
) -> torch.Tensor:
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * _scale(D)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention_splitk_partial(
    q: torch.Tensor,          # (B, Hq, D)
    k_cache: torch.Tensor,    # (B, S, Hkv, D)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,    # (B,) int32
    *,
    k_splits: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1 of split-K flash decoding: per-chunk unnormalised state.
    Returns m, l (B, Hkv, K, G) and acc (B, Hkv, K, G, D), all fp32."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    if S % k_splits:
        raise ValueError(f"cache length {S} not divisible by k_splits={k_splits}")
    ck = S // k_splits
    qg = q.reshape(B, Hkv, G, D).float()
    kb = k_cache.reshape(B, k_splits, ck, Hkv, D).float()
    vb = v_cache.reshape(B, k_splits, ck, Hkv, D)
    s = torch.einsum("bhgd,bckhd->bhcgk", qg, kb) * _scale(D)
    pos = torch.arange(S, device=q.device).reshape(k_splits, ck)
    valid = pos[None] < lengths[:, None, None]                        # (B, K, ck)
    vmask = valid[:, None, :, None, :]                                # (B,1,K,1,ck)
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)                                                # (B, H, K, G)
    # masked keys contribute nothing; an all-masked chunk is the identity
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhcgk,bckhd->bhcgd", p.to(v_cache.dtype).float(), vb.float())
    return m, l, acc


def splitk_combine(
    m: torch.Tensor,          # (B, Hkv, K, G) fp32
    l: torch.Tensor,
    acc: torch.Tensor,        # (B, Hkv, K, G, D) fp32
    dtype: torch.dtype,
) -> torch.Tensor:
    """Stage 2: log-sum-exp merge of the K partial states -> (B, Hq, D)."""
    B, Hkv, K, G, D = acc.shape
    m_star = m.amax(dim=2)                                            # (B, H, G)
    alpha = torch.exp(m - m_star[:, :, None])                         # (B, H, K, G)
    l_star = (l * alpha).sum(dim=2)
    out = (acc * alpha[..., None]).sum(dim=2)
    out = out / torch.clamp(l_star, min=1e-30)[..., None]
    return out.reshape(B, Hkv * G, D).to(dtype)


def decode_attention_splitk(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_splits: int,
) -> torch.Tensor:
    """Two-stage split-K decode: partial states, then the combine."""
    m, l, acc = decode_attention_splitk_partial(
        q, k_cache, v_cache, lengths, k_splits=k_splits)
    return splitk_combine(m, l, acc, q.dtype)


def mixed_attention(
    q: torch.Tensor,          # (B, Q, Hq, D) — Q new tokens per sequence
    k_cache: torch.Tensor,    # (B, S, Hkv, D), chunk KV already written
    v_cache: torch.Tensor,
    cache_lens: torch.Tensor, # (B,) int32 tokens cached BEFORE the chunk
) -> torch.Tensor:
    """Chunked-prefill attention: query i of sequence b sits at position
    ``cache_lens[b] + i`` and attends keys at positions ``<=`` it."""
    B, S, Hkv, D = k_cache.shape
    Q, Hq = q.shape[1], q.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Q, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * _scale(D)
    keypos = torch.arange(S, device=q.device)
    qpos = cache_lens[:, None] + torch.arange(Q, device=q.device)[None, :]   # (B, Q)
    valid = keypos[None, None, :] <= qpos[:, :, None]                       # (B, Q, S)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, Q, Hq, D).to(q.dtype)
