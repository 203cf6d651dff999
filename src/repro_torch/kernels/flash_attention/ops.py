"""Dispatch for flash attention, differentiable as in the JAX package.

A tensor on the card goes to the CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain version (``ref``).  There is no fallback: a launch
that fails raises.

Every call is a ``torch.autograd.Function``, the counterpart of the JAX
package's ``custom_vjp`` in ``ops.flash_attention``: its forward is the
kernel (or the plain version) and saves only q, k and v; its backward is the plain
version's autograd, recomputed (``ref.flash_attention_vjp``), as JAX's
backward is ``jax.vjp`` of its chunked oracle.  The recompute runs one
512-query chunk at a time against the keys that chunk can see, so, like
JAX's per-query-block ``jax.checkpoint``, it never holds the (S, S) scores
of the whole sequence.  There is no backward kernel.  Under ``no_grad``, or
when no input requires a gradient (serving), ``apply`` runs the forward
alone and records no graph.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    if q.device.type == "cuda":
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash-attention path for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel.  Backward: the plain version's autograd,
    recomputed per query chunk."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_vjp(q, k, v, g, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D), Hkv | Hq;
    queries right-aligned to the keys (position ``i + Sk - Sq``)."""
    return FlashAttention.apply(q, k, v, bool(causal), int(window))
