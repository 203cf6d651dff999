"""Dispatch for the row RMSNorm.

A tensor on the card goes to the CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain version (``ref.rmsnorm_ref``).  There is no fallback:
a launch that fails raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rmsnorm import kernel, ref


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, residual: Optional[torch.Tensor] = None,
            *, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm over the last axis of x (..., d), after adding ``residual``
    when one is given.  Returns (normed, x + residual), or (normed, x)."""
    if x.device.type == "cuda":
        return kernel.rmsnorm_cuda(x, weight, residual, eps=eps)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, weight, residual, eps)
    raise ValueError(f"no rmsnorm path for device {x.device}")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The plain form alone: ``layers.rms_norm`` through the kernel."""
    return rmsnorm(x, weight, eps=eps)[0]
