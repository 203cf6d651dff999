"""Core layers of the serving path, plain PyTorch.

Counterparts of the JAX package's ``models/layers.py``: ``rms_norm``,
``group_norm`` (rwkv's per-head ``ln_x``), ``rope_frequencies``/
``apply_rope``, ``fuse_gate_up_weights``, ``swiglu_fused`` and
``gelu_mlp`` (the gelu branch of the JAX ``transformer.mlp_block``).  The
casts follow the JAX code: norms, rope, silu and gelu run in fp32 and cast
back to the working dtype; ``silu(g)`` is cast before the product with
``u``.
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


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last axis in ``num_groups`` groups (rwkv's per-head
    ``ln_x``): fp32 statistics with the biased variance, as ``jnp.var``,
    then the affine in fp32, cast back to the input dtype."""
    c = x.shape[-1]
    xf = x.float().reshape(*x.shape[:-1], num_groups, c // num_groups)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xf * weight + bias).to(x.dtype)


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


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The two-matrix GELU MLP: ``x @ w_up``, the tanh-form GELU in fp32
    (``jax.nn.gelu``'s default ``approximate=True``; the erf form differs
    by up to 4.7e-4) cast back, then ``@ w_down``."""
    h = x @ w_up
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w_down
