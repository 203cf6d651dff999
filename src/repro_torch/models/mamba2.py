"""Mamba-2 (SSD) layers of the hybrid family's serving path.

Counterpart of the JAX package's ``models/mamba2.py`` (without its sharding
pins, ``shard_batch_heads``, which only place data across a mesh).  Per
head h (P channels, N state dims, a scalar decay per step):

    S_t = exp(dt_t · A_h) · S_{t-1} + dt_t · x_t ⊗ B_t        S ∈ R^{P×N}
    y_t = S_t · C_t + D_h · x_t

A layer is: RMSNorm → in_proj → [z | x | B | C | dt] → depthwise causal
conv (width ``CONV_K``) and silu over [x | B | C] → the SSD scan → the D
skip → the gate silu(z) → RMSNorm → out_proj → residual.  The sequence
form (``mamba2_layer``) runs the scan through ``kernels.ssd_scan.ops.ssd``
(the CUDA kernel on the card, its plain chunk form on the CPU) and reads
x, B and C in place as slices of the conv output; the one-token step
(``ssd_decode``) and the conv are plain PyTorch, as in JAX.  Both norms of
a layer run through ``kernels.rmsnorm.ops`` (the CUDA kernel on the card,
``layers.rms_norm`` op for op on the CPU).  Under autograd (the training
loop, ``zamba2.run_zamba2_train``) the scan and the norms are
differentiable: their kernels' forwards with the plain versions' autograd
as the backward.

Each ``Mamba2Layer`` holds the leaves of the JAX ``init_mamba2_layer``
under the same names; ``A_log``, ``D`` and ``dt_bias`` stay fp32.  The
casts follow the JAX code: the conv tail is kept in the working dtype, the
conv sums and silu run in fp32 and cast back, dt is ``softplus(raw +
dt_bias)`` in fp32, the scan and the D skip in fp32, and the gated output
is cast to the working dtype before its norm.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.ssd_scan import ops
from repro_torch.models import transformer

CONV_K = 4   # depthwise causal conv kernel width


class Mamba2LayerCache(NamedTuple):
    conv: torch.Tensor     # (B, CONV_K-1, conv_channels) conv tail; stacked (L, B, ...)
    state: torch.Tensor    # (B, H, P, N) fp32 ssm state; stacked (L, B, H, P, N)


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, P, H, N, conv_channels)."""
    d_inner = 2 * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, P, H, N, d_inner + 2 * N


class Mamba2Layer(nn.Module):
    """One Mamba-2 block; parameter names and shapes are the JAX leaves of
    ``init_mamba2_layer``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        d_inner, P, H, N, conv_ch = dims(cfg)

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt), requires_grad=False)

        self.ln = param(d)
        # in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        self.in_proj = param(d, 2 * d_inner + 2 * N + H)
        self.conv_w, self.conv_b = param(CONV_K, conv_ch), param(conv_ch)
        self.A_log = param(H, dt=torch.float32)          # A = -exp(A_log)
        self.D = param(H, dt=torch.float32)
        self.dt_bias = param(H, dt=torch.float32)
        self.out_norm = param(d_inner)
        self.out_proj = param(d_inner, d)


@torch.no_grad()
def init_mamba2_layer_(layer: Mamba2Layer, generator: torch.Generator) -> None:
    """Seeded random init of one layer, from the JAX distributions
    (``layers.dense_init``): in_proj and out_proj N(0, 1/fan_in), conv_w
    N(0, 0.5²), conv_b, A_log and dt_bias at zero (so A = -1 and dt =
    softplus(raw)), D and the norms at one."""
    for t in (layer.in_proj, layer.out_proj):
        transformer._normal_(t, 1.0 / math.sqrt(t.shape[0]), generator)
    transformer._normal_(layer.conv_w, 0.5, generator)
    for name, value in (("ln", 1.0), ("conv_b", 0.0), ("A_log", 0.0), ("D", 1.0),
                        ("dt_bias", 0.0), ("out_norm", 1.0)):
        getattr(layer, name).fill_(value)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. x (B, S, C); w (K, C); tail (B, K-1,
    C) or None (zeros).  Returns (silu(conv) (B, S, C) in x's dtype, the new
    tail: the last K-1 inputs)."""
    B, S, C = x.shape
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)                                   # (B, S+K-1, C)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S].float() * w[i].float()
    out = out + b.float()
    return F.silu(out).to(x.dtype), xp[:, S:]


def ssd_decode(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step. x (B, H, P); dt (B, H); A (H,); B/C (B, N); state (B, H, P, N)
    fp32.  Returns y (B, H, P) fp32 and the new state."""
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    da = torch.exp(dtf * A.float()[None, :])                           # (B, H)
    upd = dtf[..., None, None] * xf[..., :, None] * Bf[:, None, None, :]
    state_new = da[..., None, None] * state + upd
    return torch.einsum("bhpn,bn->bhp", state_new, Cf), state_new


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """Views (z, x, B, C, dt_raw) of the in_proj output."""
    d_inner, P, H, N, _ = dims(cfg)
    return zxbcdt.split([d_inner, d_inner, N, N, H], dim=-1)


def _gated_out(layer: Mamba2Layer, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """The gate silu(z), the out norm (the kernel's plain form) and out_proj:
    y (B, S, d_inner) fp32 -> x + out."""
    g = (y * F.silu(z.float())).to(x.dtype)
    return x + norm_ops.rms_norm(g, layer.out_norm, cfg.norm_eps) @ layer.out_proj


def _conv_inputs(layer: Mamba2Layer, x: torch.Tensor, cfg: ModelConfig):
    """Norm and in_proj: (z, conv_in = [x | B | C], dt_raw), views of one
    projection (the columns of x, B and C are adjacent, so no concat)."""
    d_inner, P, H, N, conv_ch = dims(cfg)
    xn = norm_ops.rms_norm(x, layer.ln, cfg.norm_eps)
    zxbcdt = xn @ layer.in_proj
    z, _, _, _, dt_raw = _split_proj(zxbcdt, cfg)
    return z, zxbcdt[..., d_inner:d_inner + conv_ch], dt_raw


def mamba2_layer(layer: Mamba2Layer, x: torch.Tensor, cfg: ModelConfig,
                 cache: Optional[Mamba2LayerCache] = None
                 ) -> Tuple[torch.Tensor, Mamba2LayerCache]:
    """Sequence form over x (B, S, d), from ``cache`` or from zeros.
    Returns x and the layer's new cache (conv tail, final state)."""
    B, S, _ = x.shape
    d_inner, P, H, N, _ = dims(cfg)
    z, conv_in, dt_raw = _conv_inputs(layer, x, cfg)
    tail = None if cache is None else cache.conv.to(conv_in.dtype)
    conv_out, new_tail = _causal_conv(conv_in, layer.conv_w, layer.conv_b, tail)
    xr = conv_out[..., :d_inner].reshape(B, S, H, P)       # views of conv_out, read in place
    Bm = conv_out[..., d_inner:d_inner + N]
    Cm = conv_out[..., d_inner + N:]
    dt = F.softplus(dt_raw.float() + layer.dt_bias)
    A = -torch.exp(layer.A_log)
    y, state = ops.ssd(xr, dt, A, Bm, Cm, None if cache is None else cache.state)
    y = y + layer.D[None, None, :, None] * xr.float()
    return (_gated_out(layer, y.reshape(B, S, d_inner), z, x, cfg),
            Mamba2LayerCache(conv=new_tail, state=state))


def mamba2_layer_decode(layer: Mamba2Layer, x: torch.Tensor, cfg: ModelConfig,
                        cache: Mamba2LayerCache) -> Tuple[torch.Tensor, Mamba2LayerCache]:
    """One token x (B, 1, d) against the layer's cache; returns x and the new
    cache (fresh tensors: ``cache`` is only read)."""
    B = x.shape[0]
    d_inner, P, H, N, _ = dims(cfg)
    z, conv_in, dt_raw = _conv_inputs(layer, x, cfg)
    conv_out, new_tail = _causal_conv(conv_in, layer.conv_w, layer.conv_b,
                                      cache.conv.to(conv_in.dtype))
    xr = conv_out[:, 0, :d_inner].reshape(B, H, P)
    Bm = conv_out[:, 0, d_inner:d_inner + N]
    Cm = conv_out[:, 0, d_inner + N:]
    dt = F.softplus(dt_raw[:, 0].float() + layer.dt_bias)
    A = -torch.exp(layer.A_log)
    y, state = ssd_decode(xr, dt, A, Bm, Cm, cache.state)
    y = y + layer.D[None, :, None] * xr.float()
    return (_gated_out(layer, y.reshape(B, 1, d_inner), z, x, cfg),
            Mamba2LayerCache(conv=new_tail, state=state))


def empty_cache(cfg: ModelConfig, n_layers: int, batch: int, dtype: torch.dtype,
                device) -> Mamba2LayerCache:
    """Zeroed stacked caches for ``n_layers`` layers: conv tails (L, B, K-1,
    conv_channels) in ``dtype``, states (L, B, H, P, N) fp32."""
    d_inner, P, H, N, conv_ch = dims(cfg)
    return Mamba2LayerCache(
        conv=torch.zeros((n_layers, batch, CONV_K - 1, conv_ch), dtype=dtype, device=device),
        state=torch.zeros((n_layers, batch, H, P, N), dtype=torch.float32, device=device),
    )
