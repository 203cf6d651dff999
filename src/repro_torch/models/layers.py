"""Core layers of the serving path, plain PyTorch.

Counterparts of the JAX package's ``models/layers.py``: ``rms_norm``,
``rope_frequencies``/``apply_rope``, ``fuse_gate_up_weights`` and
``swiglu_fused``.  The casts follow the JAX code: norm, rope and silu run
in fp32 and cast back to the working dtype; ``silu(g)`` is cast before
the product with ``u``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 over the last axis, cast back to the input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer.  Half-split rotary."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)          # (Dh/2,)
    angles = positions[..., None].float() * freqs                # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def fuse_gate_up_weights(w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """[w_gate | w_up] as one (d, 2f) matrix; built once when weights load."""
    return torch.cat([w_gate, w_up], dim=-1)


def swiglu_fused(x: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU with the gate/up pair as ONE matmul against ``w_gu``."""
    g, u = (x @ w_gu).chunk(2, dim=-1)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down
