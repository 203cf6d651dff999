"""Dispatch for the WKV6 recurrence, differentiable as in the JAX package.

A tensor on the card goes to the CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain chunk form (``ref.wkv6_chunked``).  There is no
fallback: a launch that fails raises.

Every call is a ``torch.autograd.Function``, the counterpart of the JAX
package's ``custom_vjp`` in ``ops.wkv6``: its forward is the kernel (or the
plain chunk form) and saves the inputs; its backward is the autograd of
``ref.wkv6_chunked``, recomputed from them, as JAX's backward is
``jax.vjp`` of its ``wkv_chunked`` oracle.  The chunk form masks its
pairwise exponents before the ``exp``, so a strong decay gives finite
gradients (no 0·inf).  There is no backward kernel.  Under ``no_grad``, or when no input requires a gradient (serving), ``apply``
runs the forward alone and records no graph.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._vjp import recompute_vjp
from repro_torch.kernels.rwkv6_scan import kernel, ref


def _plain(r, k, v, logw, u, state0):
    if state0 is None:
        B, _, H, N = r.shape
        state0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    return ref.wkv6_chunked(r, k, v, logw, u, state0)


def _forward(r, k, v, logw, u, state0):
    if r.device.type == "cuda":
        return kernel.wkv6_cuda(r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        return _plain(r, k, v, logw, u, state0)
    raise ValueError(f"no wkv6 path for device {r.device}")


class WKV6(torch.autograd.Function):
    """Forward: the kernel.  Backward: ``ref.wkv6_chunked``'s autograd."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        ctx.save_for_backward(r, k, v, logw, u, state0)
        return _forward(r, k, v, logw, u, state0)

    @staticmethod
    def backward(ctx, gy, gstate):
        return recompute_vjp(_plain, ctx.saved_tensors, (gy, gstate), ctx.needs_input_grad)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, state0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw (B, S, H, N), u (H, N), state0 (B, H, N, N) fp32 or None
    (zeros).  Returns y (B, S, H, N) fp32 and the final state fp32."""
    return WKV6.apply(r, k, v, logw, u, state0)
