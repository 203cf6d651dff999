"""Dispatch for the row RMSNorm, differentiable.

A tensor on the card goes to the CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain version (``ref.rmsnorm_ref``).  There is no fallback:
a launch that fails raises.

Each form is a ``torch.autograd.Function`` whose forward is the kernel (or
the plain version) and whose backward is the autograd of ``ref.rmsnorm_ref``,
recomputed from the saved inputs; the fused form's backward takes both
outputs' gradients, the normed rows' and the sum's.  The JAX hybrid calls
plain ``layers.rms_norm`` here, so these gradients are held to
``jax.grad`` of that function.  There is no backward kernel.
Under ``no_grad``, or when no input requires a gradient (serving), ``apply``
runs the forward alone and records no graph.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._vjp import recompute_vjp
from repro_torch.kernels.rmsnorm import kernel, ref


def _forward(x, weight, residual, eps):
    if x.device.type == "cuda":
        return kernel.rmsnorm_cuda(x, weight, residual, eps=eps)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, weight, residual, eps)
    raise ValueError(f"no rmsnorm path for device {x.device}")


class RMSNorm(torch.autograd.Function):
    """The plain form: normed rows only (the second output is x itself)."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, None, eps)[0]

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        return (*recompute_vjp(lambda x, w: ref.rmsnorm_ref(x, w, None, eps)[0],
                               ctx.saved_tensors, (g,), ctx.needs_input_grad[:2]), None)


class RMSNormFused(torch.autograd.Function):
    """The fused form: (normed(x + residual), x + residual)."""

    @staticmethod
    def forward(ctx, x, weight, residual, eps: float):
        ctx.save_for_backward(x, weight, residual)
        ctx.eps = eps
        return _forward(x, weight, residual, eps)

    @staticmethod
    def backward(ctx, g_normed, g_sum):
        eps = ctx.eps
        return (*recompute_vjp(lambda x, w, r: ref.rmsnorm_ref(x, w, r, eps),
                               ctx.saved_tensors, (g_normed, g_sum),
                               ctx.needs_input_grad[:3]), None)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, residual: Optional[torch.Tensor] = None,
            *, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm over the last axis of x (..., d), after adding ``residual``
    when one is given.  Returns (normed, x + residual), or (normed, x)."""
    if residual is None:
        return RMSNorm.apply(x, weight, eps), x
    return RMSNormFused.apply(x, weight, residual, eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The plain form alone: ``layers.rms_norm`` through the kernel."""
    return rmsnorm(x, weight, eps=eps)[0]
