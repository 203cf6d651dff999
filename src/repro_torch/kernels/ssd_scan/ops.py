"""Dispatch for the Mamba-2 SSD scan.

A tensor on the card goes to the CUDA kernel (``kernel``); a tensor on the
CPU goes to the plain chunk form (``ref.ssd_chunked``).  There is no
fallback: a launch that fails raises.  The JAX package's ``ops.ssd`` wraps
its kernel in a ``custom_vjp`` whose backward is the chunked oracle's; the
port serves under ``no_grad`` and has no backward yet (training is a later
slice), so this is a plain function.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel, ref


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, state0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, B/C (B, S, N), state0
    (B, H, P, N) fp32 or None (zeros).  Returns y (B, S, H, P) fp32 and the
    final state fp32."""
    if x.device.type == "cuda":
        return kernel.ssd_cuda(x, dt, A, Bm, Cm, state0)
    if x.device.type == "cpu":
        if state0 is None:
            B, _, H, P = x.shape
            state0 = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32)
        return ref.ssd_chunked(x, dt, A, Bm, Cm, state0)
    raise ValueError(f"no ssd path for device {x.device}")
