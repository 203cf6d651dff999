"""Plain PyTorch version of the row RMSNorm (the CUDA kernel's oracle).

``rmsnorm_ref`` computes the two forms of the JAX package's
``rmsnorm_pallas``: without a residual, ``(normed(x), x)``; with one,
``(normed(x + residual), x + residual)``, the sum taken in fp32, normalised
in fp32 and returned rounded to x's dtype.  The norm is ``layers.rms_norm``
op for op (mean of squares in fp32, ``x · rsqrt(var + eps)``, then the
weight, cast to x's dtype), so the plain form is bitwise that function.

In fp32 the fused form equals the JAX ``x = x + a; rms_norm(x)``.  In bf16
it differs within bf16 rounding: JAX rounds ``x + a`` to bf16 before the
norm, the fused form normalises the unrounded fp32 sum (as the TPU kernel
``_rmsnorm_fused_kernel`` does).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, residual: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (normed, x + residual), or (normed, x) without a residual."""
    if residual is None:
        xf, summed = x.float(), x
    else:
        xf = x.float() + residual.float()
        summed = xf.to(x.dtype)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype), summed
