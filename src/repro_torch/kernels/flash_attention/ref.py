"""Plain PyTorch versions of the flash-attention forward (GQA, causal/window).

``flash_attention`` is the oracle the CUDA kernel in
``csrc/flash_attention.cu`` is held against on the card, and what ``ops``
runs for a tensor on the CPU: an online-softmax loop over ``block_k``-key
tiles, as the kernel walks them.  ``attention_ref`` materialises the
(Sq, Sk) scores in one piece.  ``flash_attention_vjp`` is the backward of
``ops``' autograd function: the autograd of ``flash_attention`` itself,
recomputed one query chunk at a time (``q0`` places a chunk's queries).
Counterparts of the JAX package's ``kernels/flash_attention/kernel.py``
(``_flash_kernel``) and ``kernels/flash_attention/ref.py``
(``attention_ref``).

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
# key tile of the backward's recompute: JAX's backward recomputes its chunked
# oracle in 512 x 512 blocks (``ops.flash_attention``'s block_q, block_k)
BWD_BLOCK_K = 512


def _visible(Sq: int, q0: int, causal: bool, window: int, k0: int, k1: int,
             device) -> torch.Tensor:
    """(Sq, k1 - k0) bool: which keys of [k0, k1) each query may see, query
    i at position ``q0 + i``."""
    qpos = torch.arange(Sq, device=device)[:, None] + q0
    kpos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_k: int = 128, q0=None, p_dtype=None) -> torch.Tensor:
    """Online softmax over ``block_k``-key tiles (the last one ragged).
    ``q0`` is the position of query 0 (default ``Sk - Sq``, right-aligned);
    ``p_dtype`` is the dtype p is rounded to before the PV product (default
    v's)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    q0 = Sk - Sq if q0 is None else q0
    G = Hq // Hkv
    p_dtype = v.dtype if p_dtype is None else p_dtype
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, k0:k1].float()) * scale
        s = torch.where(_visible(Sq, q0, causal, window, k0, k1, q.device), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), v[:, k0:k1].float())
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
    s = torch.where(_visible(Sq, Sk - Sq, causal, window, 0, Sk, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *,
                        causal: bool = True, window: int = 0, q_chunk: int = 512) -> tuple:
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the output
    gradient g: the autograd of ``flash_attention`` over ``BWD_BLOCK_K``-key
    tiles, recomputed for one ``q_chunk``-query chunk at a time (JAX
    recomputes its chunked oracle per 512 x 512 block under
    ``jax.checkpoint``), so at most (Cq, Sk) scores are alive.  A chunk whose every query sees a key reads
    only the keys it can see (up to its last query with ``causal``, from
    its first query's window start with ``window``); a chunk holding a
    query that sees none (causal, Sk < Sq) reads all keys, as the forward
    averages them all for such a row.  Each chunk's k and v enter the
    recompute as fp32 copies (the same values; p still rounded to v's
    dtype), so its dk and dv shares come back in fp32; they are summed in
    fp32 and rounded to k's and v's dtype once, as the plain autograd
    rounds its whole sum once."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i0 in range(0, Sq, q_chunk):
        i1 = min(i0 + q_chunk, Sq)
        first, last = i0 + Sk - Sq, i1 - 1 + Sk - Sq       # positions of the chunk's queries
        lo, hi = 0, Sk
        if first >= 0:
            hi = last + 1 if causal else Sk
            lo = max(0, first - window + 1) if window > 0 else 0
        with torch.enable_grad():
            qc = q[:, i0:i1].detach().requires_grad_()
            kc = k[:, lo:hi].detach().float().requires_grad_()
            vc = v[:, lo:hi].detach().float().requires_grad_()
            out = flash_attention(qc, kc, vc, causal=causal, window=window,
                                  block_k=BWD_BLOCK_K, q0=first - lo, p_dtype=v.dtype)
            gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc), g[:, i0:i1])
        dq[:, i0:i1] = gq
        dk[:, lo:hi] += gk
        dv[:, lo:hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)
