"""Dispatch for the flash-decoding kernels.

A tensor on the card goes to its CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain version (``ref``).  There is no fallback: a launch
that fails raises.  ``decode_attention`` picks single-stage or split-K by
the same policies as the JAX package's ``ops.auto_k_splits`` and
``ops.auto_paged_k_splits``.

With ``page_table`` the KV operands are the shared page pool
(P, page_size, Hkv, D) read through (B, n_blocks) block tables, and the
short/long split applies over the logical length n_blocks·page_size.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import kernel, ref

# caches at/above this length get the split-K treatment by default
SPLITK_MIN_S = 2048
SPLITK_MAX = 8
SPLITK_BLOCK = 512
# each paged split chunk streams at least this many tokens
SPLITK_MIN_CHUNK = 256


def auto_k_splits(S: int) -> int:
    """Largest split <= SPLITK_MAX whose chunk is a whole number of
    SPLITK_BLOCK-key blocks."""
    if S < SPLITK_MIN_S:
        return 1
    for k in range(min(SPLITK_MAX, S // SPLITK_BLOCK), 1, -1):
        if S % k == 0 and (S // k) % min(SPLITK_BLOCK, S // k) == 0:
            return k
    return 1


def auto_paged_k_splits(n_blocks: int, page_size: int) -> int:
    """Largest split <= SPLITK_MAX that divides the block table evenly,
    covers >= SPLITK_MIN_S logical tokens, and keeps every chunk streaming
    >= SPLITK_MIN_CHUNK tokens (a chunk is a whole number of pages)."""
    if n_blocks * page_size < SPLITK_MIN_S:
        return 1
    for k in range(min(SPLITK_MAX, n_blocks), 1, -1):
        if n_blocks % k == 0 and (n_blocks // k) * page_size >= SPLITK_MIN_CHUNK:
            return k
    return 1


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no decode-attention path for device {t.device}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *,
                     page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token GQA attention with per-sequence lengths.
    q (B, Hq, D); K/V (B, S, Hkv, D), or with ``page_table`` (B, n_blocks)
    int32 the pool (P, ps, Hkv, D); lengths (B,) int32."""
    if page_table is not None:
        k_splits = auto_paged_k_splits(page_table.shape[1], k_cache.shape[1])
        if k_splits > 1:
            if _on_card(q):
                return kernel.decode_attention_paged_splitk_cuda(
                    q, k_cache, v_cache, page_table, lengths, k_splits=k_splits)
            return ref.decode_attention_paged_splitk(q, k_cache, v_cache, page_table, lengths,
                                                     k_splits=k_splits)
        if _on_card(q):
            return kernel.decode_attention_paged_cuda(q, k_cache, v_cache, page_table, lengths)
        return ref.decode_attention_paged(q, k_cache, v_cache, page_table, lengths)
    k_splits = auto_k_splits(k_cache.shape[1])
    if k_splits > 1:
        if _on_card(q):
            return kernel.decode_attention_splitk_cuda(q, k_cache, v_cache, lengths,
                                                       k_splits=k_splits)
        return ref.decode_attention_splitk(q, k_cache, v_cache, lengths, k_splits=k_splits)
    if _on_card(q):
        return kernel.decode_attention_cuda(q, k_cache, v_cache, lengths)
    return ref.decode_attention(q, k_cache, v_cache, lengths)


def mixed_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    cache_lens: torch.Tensor, *,
                    page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q-chunk GQA attention for the mixed (prefill+decode) engine step:
    query i of sequence b sits at position ``cache_lens[b] + i`` and sees
    keys at or before it; the chunk's KV is already in the cache (or, with
    ``page_table``, in the pool)."""
    if page_table is not None:
        if _on_card(q):
            return kernel.mixed_attention_paged_cuda(q, k_cache, v_cache, page_table, cache_lens)
        return ref.mixed_attention_paged(q, k_cache, v_cache, page_table, cache_lens)
    if _on_card(q):
        return kernel.mixed_attention_cuda(q, k_cache, v_cache, cache_lens)
    return ref.mixed_attention(q, k_cache, v_cache, cache_lens)
