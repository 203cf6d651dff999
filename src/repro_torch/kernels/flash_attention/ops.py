"""Dispatch for the flash-attention forward.

A tensor on the card goes to the CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain version (``ref``).  There is no fallback: a launch
that fails raises.  The JAX package's ``ops.flash_attention`` wraps its
kernel in a ``custom_vjp`` whose backward is the chunked oracle's; the
port serves under ``no_grad`` and has no backward yet (training is a later
slice), so this is a plain function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D), Hkv | Hq;
    queries right-aligned to the keys (position ``i + Sk - Sq``)."""
    if q.device.type == "cuda":
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash-attention path for device {q.device}")
