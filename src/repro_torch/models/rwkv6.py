"""RWKV-6 "Finch" layers of the serving path: attention-free token mixing
with a data-dependent decay, carried as a constant-size state per slot.

Counterpart of the JAX package's ``models/rwkv6.py`` (without its sharding
pins).  Per head, with r, k, v rows of N and an (N, N) fp32 state S:

    y_t = r_t · (S_{t-1} + (u ∘ k_t)ᵀ v_t)
    S_t = diag(exp(logw_t)) · S_{t-1} + k_tᵀ v_t

The sequence form (``time_mix``) runs the recurrence through
``kernels.rwkv6_scan.ops.wkv6``: the CUDA kernel on the card, its plain
chunk form on the CPU.  The JAX model computes the same function with its
hoisted ``lax.scan`` (``wkv_chunked``, the default) or the Pallas kernel
(``use_pallas``); the port has no switch.  The one-token step
(``wkv_decode``) is plain PyTorch, as in JAX.

Each ``RWKVLayer`` holds the leaves of the JAX ``init_rwkv_layer`` under
the same names.  The layer loops are Python loops; ``run_rwkv_decode``
updates the stacked (L, B, ...) cache leaves in place, where the JAX
engine donates them, and ``run_rwkv_train``, the training loop, keeps no
cache and rematerialises each layer (JAX's per-layer ``jax.checkpoint``);
under autograd ``ops.wkv6`` is differentiable (the plain chunk form's
autograd, recomputed).  The casts follow the JAX code: tanh of the LoRAs,
``-exp`` of the log-decay, silu of the gate, relu² and sigmoid in fp32;
``(y · g)`` and relu² cast to the working dtype before their matmuls.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.models import layers, transformer

DECAY_LORA = 64
MIX_LORA = 32


class RWKVLayerCache(NamedTuple):
    state: torch.Tensor        # (B, H, N, N) fp32 wkv state; stacked (L, B, H, N, N)
    shift_att: torch.Tensor    # (B, d) previous normed token (time mix); stacked (L, B, d)
    shift_ffn: torch.Tensor    # (B, d) previous normed token (channel mix); stacked (L, B, d)


class RWKVLayer(nn.Module):
    """ln1 → time mix → residual → ln2 → channel mix → residual.  Parameter
    names and shapes are the JAX leaves of ``init_rwkv_layer``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt), requires_grad=False)

        self.ln1, self.ln2 = param(d), param(d)
        # token-shift mixes (static part) + shared data-dependent LoRA, for r, k, v, w, g
        self.mu, self.mu_x = param(5, d), param(d)
        self.mix_w1, self.mix_w2 = param(d, 5 * MIX_LORA), param(5, MIX_LORA, d)
        self.wr, self.wk, self.wv = param(d, d), param(d, d), param(d, d)
        self.wg, self.wo = param(d, d), param(d, d)
        # decay: logw = -exp(w0 + tanh(x_w A) B); bonus u
        self.w0 = param(d)
        self.decay_a, self.decay_b = param(d, DECAY_LORA), param(DECAY_LORA, d)
        self.u = param(d)
        self.ln_x_w = param(d, dt=torch.float32)
        self.ln_x_b = param(d, dt=torch.float32)
        # channel mix
        self.cm_mu_k, self.cm_mu_r = param(d), param(d)
        self.cm_wk, self.cm_wv, self.cm_wr = param(d, f), param(f, d), param(d, d)


def _dense_(t: torch.Tensor, generator: torch.Generator, scale: Optional[float] = None) -> None:
    """``layers.dense_init``: N(0, scale²) drawn in fp32 and cast, with
    scale 1/sqrt(fan_in) (fan_in = ``shape[-2]``) unless given."""
    s = scale if scale is not None else 1.0 / math.sqrt(t.shape[-2])
    t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                        dtype=torch.float32).mul_(s))


@torch.no_grad()
def init_rwkv_layer_(layer: RWKVLayer, generator: torch.Generator) -> None:
    """Seeded random init of one layer, from the JAX distributions: the
    projections N(0, 1/fan_in), the LoRA matrices at scale 0.01, the mixes
    at 0.5, w0 at -2, u at 0, the norms at one and ln_x's bias at zero."""
    for name in ("mix_w1", "mix_w2", "decay_a", "decay_b"):
        _dense_(getattr(layer, name), generator, 0.01)
    for name in ("wr", "wk", "wv", "wg", "wo", "cm_wk", "cm_wv", "cm_wr"):
        _dense_(getattr(layer, name), generator)
    for name, value in (("ln1", 1.0), ("ln2", 1.0), ("mu", 0.5), ("mu_x", 0.5), ("w0", -2.0),
                        ("u", 0.0), ("ln_x_w", 1.0), ("ln_x_b", 0.0), ("cm_mu_k", 0.5),
                        ("cm_mu_r", 0.5)):
        getattr(layer, name).fill_(value)


# ---------------------------------------------------------------------------
# time mix and channel mix
# ---------------------------------------------------------------------------


def _ddlerp(layer: RWKVLayer, x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Data-dependent token-shift mixes for (r, k, v, w, g): (B, S, 5, d)."""
    base = x + sx * layer.mu_x
    lora = torch.tanh((base @ layer.mix_w1).float()).to(x.dtype)
    lora = lora.reshape(*lora.shape[:-1], 5, MIX_LORA)
    mw = torch.einsum("bsir,ird->bsid", lora, layer.mix_w2)
    return x[:, :, None, :] + sx[:, :, None, :] * (layer.mu + mw)


def _time_mix_common(layer: RWKVLayer, xn: torch.Tensor, sx: torch.Tensor, cfg: ModelConfig):
    """r, k, v (B, S, H, N) in the working dtype, the gate g (B, S, d) fp32
    and logw (B, S, H, N) fp32."""
    B, S, d = xn.shape
    N = cfg.rwkv_head_dim
    H = d // N
    xr, xk, xv, xw, xg = _ddlerp(layer, xn, sx).unbind(2)
    r = (xr @ layer.wr).reshape(B, S, H, N)
    k = (xk @ layer.wk).reshape(B, S, H, N)
    v = (xv @ layer.wv).reshape(B, S, H, N)
    g = F.silu((xg @ layer.wg).float())
    # data-dependent decay in log space (<= about -e^w0)
    wln = layer.w0 + torch.tanh((xw @ layer.decay_a).float()) @ layer.decay_b.float()
    logw = -torch.exp(wln.float()).reshape(B, S, H, N)
    return r, k, v, g, logw


def _shifted(xn: torch.Tensor, prev_row: Optional[torch.Tensor]) -> torch.Tensor:
    """sx = (previous token's xn) - xn; the row before the first token is
    ``prev_row`` (a cache's shift row) or zeros."""
    B, _, d = xn.shape
    prev = (torch.zeros((B, 1, d), dtype=xn.dtype, device=xn.device) if prev_row is None
            else prev_row[:, None].to(xn.dtype))
    return torch.cat([prev, xn[:, :-1]], dim=1) - xn


def _mix_out(layer: RWKVLayer, y: torch.Tensor, g: torch.Tensor, H: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Per-head ln_x on the fp32 wkv output, the gate, then ``wo``."""
    y = layers.group_norm(y, layer.ln_x_w, layer.ln_x_b, H)
    return (y.float() * g).to(dtype) @ layer.wo


def time_mix(layer: RWKVLayer, x: torch.Tensor, cfg: ModelConfig,
             cache: Optional[RWKVLayerCache] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Sequence form over x (B, S, d).  Returns the mix output and
    (final wkv state, the last normed row for the next shift)."""
    B, S, d = x.shape
    xn = layers.rms_norm(x, layer.ln1, cfg.norm_eps)
    sx = _shifted(xn, None if cache is None else cache.shift_att)
    r, k, v, g, logw = _time_mix_common(layer, xn, sx, cfg)
    H, N = r.shape[2], r.shape[3]
    y, state = ops.wkv6(r, k, v, logw, layer.u.reshape(H, N),
                        None if cache is None else cache.state)
    return _mix_out(layer, y.reshape(B, S, d), g, H, x.dtype), (state, xn[:, -1])


def _channel_mix_rows(layer: RWKVLayer, xn: torch.Tensor, sx: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    xk = xn + sx * layer.cm_mu_k
    xr = xn + sx * layer.cm_mu_r
    kk = torch.square(torch.relu((xk @ layer.cm_wk).float())).to(dtype)
    vv = kk @ layer.cm_wv
    rr = torch.sigmoid((xr @ layer.cm_wr).float())
    return (rr * vv.float()).to(dtype)


def channel_mix(layer: RWKVLayer, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[RWKVLayerCache] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mix over x (B, S, d).  Returns the output and the
    last normed row for the next shift."""
    xn = layers.rms_norm(x, layer.ln2, cfg.norm_eps)
    sx = _shifted(xn, None if cache is None else cache.shift_ffn)
    return _channel_mix_rows(layer, xn, sx, x.dtype), xn[:, -1]


def rwkv_layer(layer: RWKVLayer, x: torch.Tensor, cfg: ModelConfig,
               cache: Optional[RWKVLayerCache] = None
               ) -> Tuple[torch.Tensor, RWKVLayerCache]:
    """One layer in sequence form.  Returns x and the layer's new cache."""
    att, (state, shift_a) = time_mix(layer, x, cfg, cache)
    x = x + att
    ffn, shift_f = channel_mix(layer, x, cfg, cache)
    return x + ffn, RWKVLayerCache(state=state, shift_att=shift_a, shift_ffn=shift_f)


# ---------------------------------------------------------------------------
# one-token step
# ---------------------------------------------------------------------------


def wkv_decode(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
               u: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence: r, k, v, logw (B, H, N); u (H, N); state
    (B, H, N, N) fp32.  Returns y (B, H, N) fp32 and the new state."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", rf, state + u.float()[None, :, :, None] * kv)
    return y, torch.exp(wf)[..., None] * state + kv


def rwkv_layer_decode(layer: RWKVLayer, x: torch.Tensor, cfg: ModelConfig,
                      cache: RWKVLayerCache) -> Tuple[torch.Tensor, RWKVLayerCache]:
    """One token x (B, 1, d) against the layer's cache; returns x and the
    new cache (fresh tensors: ``cache`` is only read)."""
    B, _, d = x.shape
    xn = layers.rms_norm(x, layer.ln1, cfg.norm_eps)
    sx = cache.shift_att[:, None].to(xn.dtype) - xn
    r, k, v, g, logw = _time_mix_common(layer, xn, sx, cfg)
    H, N = r.shape[2], r.shape[3]
    y, state = wkv_decode(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], layer.u.reshape(H, N),
                          cache.state)
    x = x + _mix_out(layer, y.reshape(B, 1, d), g, H, x.dtype)

    xn2 = layers.rms_norm(x, layer.ln2, cfg.norm_eps)
    sx2 = cache.shift_ffn[:, None].to(xn2.dtype) - xn2
    x = x + _channel_mix_rows(layer, xn2, sx2, x.dtype)
    return x, RWKVLayerCache(state=state, shift_att=xn[:, -1], shift_ffn=xn2[:, -1])


# ---------------------------------------------------------------------------
# layer loops and the cache
# ---------------------------------------------------------------------------


def run_rwkv_seq(layer_list: nn.ModuleList, x: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, RWKVLayerCache]:
    """The prefill layer loop over x (B, S, d).  Returns x and the stacked
    caches: state (L, B, H, N, N) fp32, shift rows (L, B, d)."""
    cache = empty_cache(cfg, len(layer_list), x.shape[0], x.dtype, x.device)
    for li, layer in enumerate(layer_list):
        x, c = rwkv_layer(layer, x, cfg)
        for buf, leaf in zip(cache, c):
            buf[li].copy_(leaf)
    return x, cache


def _rwkv_layer_train(layer: RWKVLayer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rwkv_layer(layer, x, cfg)[0]


def run_rwkv_train(layer_list: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The training layer loop over x (B, S, d), differentiable: no cache,
    every layer rematerialised (``transformer.remat``)."""
    for layer in layer_list:
        x = transformer.remat(_rwkv_layer_train, layer, x, cfg)
    return x


def run_rwkv_decode(layer_list: nn.ModuleList, x: torch.Tensor, caches: RWKVLayerCache,
                    cfg: ModelConfig) -> torch.Tensor:
    """One token x (B, 1, d) through every layer; writes each layer's new
    state and shift rows into the stacked ``caches`` in place."""
    for li, layer in enumerate(layer_list):
        x, c = rwkv_layer_decode(layer, x, cfg, RWKVLayerCache(*(leaf[li] for leaf in caches)))
        for buf, leaf in zip(caches, c):
            buf[li].copy_(leaf)
    return x


def empty_cache(cfg: ModelConfig, n_layers: int, batch: int, dtype: torch.dtype,
                device) -> RWKVLayerCache:
    """Zeroed stacked caches for ``n_layers`` layers: state (L, B, H, N, N)
    fp32 and shift rows (L, B, d) in ``dtype``."""
    d, N = cfg.d_model, cfg.rwkv_head_dim
    return RWKVLayerCache(
        state=torch.zeros((n_layers, batch, d // N, N, N), dtype=torch.float32, device=device),
        shift_att=torch.zeros((n_layers, batch, d), dtype=dtype, device=device),
        shift_ffn=torch.zeros((n_layers, batch, d), dtype=dtype, device=device),
    )
