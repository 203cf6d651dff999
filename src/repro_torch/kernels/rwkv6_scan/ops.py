"""Dispatch for the WKV6 recurrence.

A tensor on the card goes to the CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain chunk form (``ref.wkv6_chunked``).  There is no
fallback: a launch that fails raises.  The JAX package's ``ops.wkv6``
wraps its kernel in a ``custom_vjp`` whose backward is the oracle's; the
port serves under ``no_grad`` and has no backward yet (training is a later
slice), so this is a plain function.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rwkv6_scan import kernel, ref


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, state0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw (B, S, H, N), u (H, N), state0 (B, H, N, N) fp32 or None
    (zeros).  Returns y (B, S, H, N) fp32 and the final state fp32."""
    if r.device.type == "cuda":
        return kernel.wkv6_cuda(r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        if state0 is None:
            B, _, H, N = r.shape
            state0 = torch.zeros((B, H, N, N), dtype=torch.float32)
        return ref.wkv6_chunked(r, k, v, logw, u, state0)
    raise ValueError(f"no wkv6 path for device {r.device}")
