"""Plain PyTorch versions of the flash-attention forward (GQA, causal/window).

``flash_attention`` is the oracle the CUDA kernel in
``csrc/flash_attention.cu`` is held against on the card, and what ``ops``
runs for a tensor on the CPU: an online-softmax loop over ``block_k``-key
tiles, as the kernel walks them.  ``attention_ref`` materialises the
(Sq, Sk) scores in one piece.  Counterparts of the JAX package's
``kernels/flash_attention/kernel.py`` (``_flash_kernel``) and
``kernels/flash_attention/ref.py`` (``attention_ref``).

Semantics: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with Hkv | Hq; query head
h reads kv head h // G.  Query i sits at position ``i + Sk - Sq``
(right-aligned).  Key j is visible to it when ``j <= q_pos`` (``causal``)
and ``j > q_pos - window`` (``window > 0``).  Numerics follow the TPU
kernel: fp32 scores and softmax state, masking with ``-1e30`` (never
``-inf``), p cast to V's dtype before the PV product, the output divided by
``max(l, 1e-30)``.  No length is required to divide by a tile.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _visible(Sq: int, Sk: int, causal: bool, window: int, k0: int, k1: int,
             device) -> torch.Tensor:
    """(Sq, k1 - k0) bool: which keys of [k0, k1) each query may see."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_k: int = 128) -> torch.Tensor:
    """Online softmax over ``block_k``-key tiles (the last one ragged)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, k0:k1].float()) * scale
        s = torch.where(_visible(Sq, Sk, causal, window, k0, k1, q.device), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v[:, k0:k1].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """The same function with the whole (Sq, Sk) score matrix at once."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(D))
    s = torch.where(_visible(Sq, Sk, causal, window, 0, Sk, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
