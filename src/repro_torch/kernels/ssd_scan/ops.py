"""Dispatch for the Mamba-2 SSD scan, differentiable as in the JAX package.

A tensor on the card goes to the CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain chunk form (``ref.ssd_chunked``).  There is no
fallback: a launch that fails raises.

Every call is a ``torch.autograd.Function``, the counterpart of the JAX
package's ``custom_vjp`` in ``ops.ssd``: its forward is the kernel (or the
plain chunk form) and saves the inputs; its backward is the autograd of
``ref.ssd_chunked``, recomputed from them, as JAX's backward is
``jax.vjp`` of its ``ssd_chunked`` oracle.  The port's chunk form masks
its pairwise exponents before the ``exp``; the JAX one masks after it, so
once a chunk's log-decay sums below about -88 (at the model's decay, a
128-token chunk) its exponents above the diagonal overflow to inf and its
backward multiplies them by the masked zeros (0·inf = NaN), where the
port's gradients stay finite.  There is no backward kernel.
Under ``no_grad``, or when no input requires a gradient (serving), ``apply``
runs the forward alone and records no graph.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._vjp import recompute_vjp
from repro_torch.kernels.ssd_scan import kernel, ref


def _plain(x, dt, A, Bm, Cm, state0):
    if state0 is None:
        B, _, H, P = x.shape
        state0 = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    return ref.ssd_chunked(x, dt, A, Bm, Cm, state0)


def _forward(x, dt, A, Bm, Cm, state0):
    if x.device.type == "cuda":
        return kernel.ssd_cuda(x, dt, A, Bm, Cm, state0)
    if x.device.type == "cpu":
        return _plain(x, dt, A, Bm, Cm, state0)
    raise ValueError(f"no ssd path for device {x.device}")


class SSD(torch.autograd.Function):
    """Forward: the kernel.  Backward: ``ref.ssd_chunked``'s autograd."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, state0):
        ctx.save_for_backward(x, dt, A, Bm, Cm, state0)
        return _forward(x, dt, A, Bm, Cm, state0)

    @staticmethod
    def backward(ctx, gy, gstate):
        return recompute_vjp(_plain, ctx.saved_tensors, (gy, gstate), ctx.needs_input_grad)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, state0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, B/C (B, S, N), state0
    (B, H, P, N) fp32 or None (zeros).  Returns y (B, S, H, P) fp32 and the
    final state fp32."""
    return SSD.apply(x, dt, A, Bm, Cm, state0)
