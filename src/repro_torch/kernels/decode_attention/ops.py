"""Dispatch for the flash-decoding kernels.

A tensor on the card goes to its CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain version (``ref``).  There is no fallback: a launch
that fails raises.  ``decode_attention`` picks single-stage or split-K by
the same policy as the JAX package's ``ops.auto_k_splits``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel, ref

# caches at/above this length get the split-K treatment by default
SPLITK_MIN_S = 2048
SPLITK_MAX = 8
SPLITK_BLOCK = 512


def auto_k_splits(S: int) -> int:
    """Largest split <= SPLITK_MAX whose chunk is a whole number of
    SPLITK_BLOCK-key blocks."""
    if S < SPLITK_MIN_S:
        return 1
    for k in range(min(SPLITK_MAX, S // SPLITK_BLOCK), 1, -1):
        if S % k == 0 and (S // k) % min(SPLITK_BLOCK, S // k) == 0:
            return k
    return 1


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no decode-attention path for device {t.device}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention with per-sequence lengths.
    q (B, Hq, D); K/V (B, S, Hkv, D); lengths (B,) int32."""
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
                    cache_lens: torch.Tensor) -> torch.Tensor:
    """Q-chunk GQA attention for the mixed (prefill+decode) engine step:
    query i of sequence b sits at position ``cache_lens[b] + i`` and sees
    keys at or before it; the chunk's KV is already in the cache."""
    if _on_card(q):
        return kernel.mixed_attention_cuda(q, k_cache, v_cache, cache_lens)
    return ref.mixed_attention(q, k_cache, v_cache, cache_lens)
