"""Decoder transformer of the port: layer modules, seeded init, the
prefill, decode and mixed layer loops, the training layer loop, the logits
head and the loss, and the check of which configs the port serves.

Counterpart of the JAX package's ``models/transformer.py`` for the dense,
moe, vlm and encoder families.  The JAX stack scans over stacked (L, ...)
leaves and builds the fused ``wqkv``/``w_gu`` once per jitted dispatch; the
port keeps one ``DecoderLayer`` module per layer, holding those fused
matrices from the moment weights load, so no step ever rebuilds them.  A
GELU layer (``mlp_type="gelu"``) holds ``w_up``/``w_down`` unfused, as JAX
has no ``w_gu`` for it; an MoE layer holds a ``moe.MoE`` in place of its
MLP (JAX ``mlp_block``'s MoE branch).  The layer loops are Python loops;
the serving loops write each layer's KV slice in place.  The training loop
(``run_layers_train``) writes no cache, rematerialises every layer under
``torch.utils.checkpoint`` (JAX's per-layer ``jax.checkpoint``) and sums
the MoE auxiliary loss over layers, as JAX's ``run_layers_seq`` does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe


class DecoderLayer(nn.Module):
    """ln1 → attention → residual → ln2 → SwiGLU (fused [w_gate|w_up]), or
    with ``mlp_type="gelu"`` the GELU MLP (``w_up``, ``w_down``), or in an
    MoE model the ``moe.MoE`` block."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, **kw), requires_grad=False)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, **kw), requires_grad=False)
        self.attn = attention.Attention(cfg, device=device, dtype=dtype)
        if cfg.is_moe:
            self.moe = moe.MoE(cfg, device=device, dtype=dtype)
            return
        if cfg.mlp_type == "gelu":
            self.w_up = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff, **kw), requires_grad=False)
        else:
            self.w_gu = nn.Parameter(torch.empty(cfg.d_model, 2 * cfg.d_ff, **kw),
                                     requires_grad=False)
        self.w_down = nn.Parameter(torch.empty(cfg.d_ff, cfg.d_model, **kw), requires_grad=False)


def check_supported(cfg: ModelConfig) -> None:
    """The port serves the dense, moe and vlm token-LM families and prefills
    the encoder family (SwiGLU or GELU, tied or untied; the moe family's
    experts top-k routed, with or without a dense residual), with full
    attention or, on the dense and moe families, a sliding window (the
    decode cache a ring); and serves the rwkv family (token input, decoding)
    and the hybrid family (token input, decoding, a SwiGLU shared block
    with full attention after every ``attention_every`` Mamba-2 layers).
    Anything else raises ``NotImplementedError``."""
    if cfg.family in ("rwkv", "hybrid"):
        if cfg.input_mode != "tokens" or not cfg.supports_decode:
            raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is ported for "
                                      f"token input and decoding only")
        if cfg.family == "hybrid" and (
                cfg.mlp_type != "swiglu" or cfg.sliding_window > 0 or not cfg.attention_every
                or cfg.n_layers % cfg.attention_every):
            raise NotImplementedError(
                f"{cfg.name}: the hybrid family is ported with a SwiGLU shared block, full "
                f"attention and whole groups of attention_every layers")
        return
    if (cfg.family not in ("dense", "moe", "vlm", "encoder")
            or cfg.is_moe != (cfg.family == "moe")
            or cfg.mlp_type not in ("swiglu", "gelu")):
        raise NotImplementedError(
            f"{cfg.name}: only the dense, moe, vlm and encoder families with a SwiGLU or GELU "
            f"MLP (experts in the moe family alone), the rwkv family and the hybrid family are "
            f"ported (family {cfg.family!r}, mlp {cfg.mlp_type!r}, experts {cfg.n_experts})")
    if cfg.is_moe and not 0 < cfg.top_k <= cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: top_k {cfg.top_k} of {cfg.n_experts} experts")
    encoder = cfg.family == "encoder"
    if cfg.input_mode != ("embeds" if encoder else "tokens") or (encoder and cfg.supports_decode):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is ported with "
            f"{'embeds input and no decode' if encoder else 'token input'} "
            f"(input_mode {cfg.input_mode!r}, supports_decode {cfg.supports_decode})")
    if cfg.sliding_window > 0 and cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is ported on the dense and moe families only")


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` with N(0, std²) drawn in fp32 and cast, as the JAX init
    (``normal(fp32) * s`` then ``astype``) does."""
    t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                        dtype=torch.float32).mul_(std))


@torch.no_grad()
def init_layer_(layer: DecoderLayer, cfg: ModelConfig, generator: torch.Generator) -> None:
    """Seeded random init of one layer: every matrix N(0, 1/fan_in) as
    ``dense_init``, norms at one.  q/k/v share fan-in d_model, so the fused
    ``wqkv`` is drawn in one piece; likewise ``w_gu`` (or a GELU layer's
    ``w_up``)."""
    d = cfg.d_model
    _normal_(layer.attn.wqkv, 1.0 / math.sqrt(d), generator)
    _normal_(layer.attn.wo, 1.0 / math.sqrt(cfg.q_dim), generator)
    if cfg.is_moe:
        _init_moe_(layer.moe, cfg, generator)
    else:
        _normal_(layer.w_up if cfg.mlp_type == "gelu" else layer.w_gu, 1.0 / math.sqrt(d),
                 generator)
        _normal_(layer.w_down, 1.0 / math.sqrt(cfg.d_ff), generator)
    layer.ln1.fill_(1.0)
    layer.ln2.fill_(1.0)
    if layer.attn.qk_norm is not None:
        layer.attn.qk_norm.fill_(1.0)


def _init_moe_(p: moe.MoE, cfg: ModelConfig, generator: torch.Generator) -> None:
    """The JAX ``init_moe_params`` distributions: ``router`` N(0, 0.02²) in
    fp32, the experts' and the residual's matrices N(0, 1/fan_in).  The
    experts are drawn one at a time: arctic's whole ``w_gu`` drawn at once
    would need an fp32 temporary of twice its bf16 size."""
    d = cfg.d_model
    _normal_(p.router, 0.02, generator)
    for e in range(cfg.n_experts):
        _normal_(p.w_gu[e], 1.0 / math.sqrt(d), generator)
        _normal_(p.w_down[e], 1.0 / math.sqrt(cfg.d_ff), generator)
    if cfg.moe_dense_residual:
        _normal_(p.res_gu, 1.0 / math.sqrt(d), generator)
        _normal_(p.res_down, 1.0 / math.sqrt(p.res_down.shape[0]), generator)


def _mlp(layer: DecoderLayer, x: torch.Tensor, cfg: ModelConfig, *, aux: bool = False):
    """ln2, the layer's MLP (the MoE block, GELU or fused SwiGLU), residual:
    the one MLP of every layer loop (JAX ``mlp_block``).  An MoE call routes
    every token of ``x`` together: B for a decode step, B·Q for a mixed
    step, the prompt for a prefill or a training microbatch.  With ``aux``
    returns (x, the MoE auxiliary loss, 0 without experts)."""
    h = layers.rms_norm(x, layer.ln2, cfg.norm_eps)
    if cfg.is_moe:
        m, loss = moe.moe_block(layer.moe, h, cfg, aux=aux)
    else:
        if cfg.mlp_type == "gelu":
            m = layers.gelu_mlp(h, layer.w_up, layer.w_down)
        else:
            m = layers.swiglu_fused(h, layer.w_gu, layer.w_down)
        loss = torch.zeros((), dtype=torch.float32, device=x.device) if aux else None
    return (x + m, loss) if aux else x + m


def run_layers_seq(
    layer_list: nn.ModuleList,
    x: torch.Tensor,               # (B, S, d) — whole prompts
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The prefill layer loop.  Returns x and the stacked prompt caches
    k, v (L, B, S, Hkv, Dh), each layer's copied into one preallocated
    buffer so no layer's projection outlives it; with a sliding window W
    below S, only the ring a decode cache holds (L, B, W, Hkv, Dh), the
    last W positions with position p at row p % W
    (``attention.ring_rows``).  The serving path takes no MoE auxiliary
    loss; the training loop, ``run_layers_train``, does."""
    B, S, _ = x.shape
    W = cfg.sliding_window
    rows = min(S, W) if W > 0 else S
    shape = (len(layer_list), B, rows, cfg.n_kv_heads, cfg.resolved_head_dim)
    ks = torch.empty(shape, dtype=x.dtype, device=x.device)
    vs = torch.empty(shape, dtype=x.dtype, device=x.device)
    for li, layer in enumerate(layer_list):
        h = layers.rms_norm(x, layer.ln1, cfg.norm_eps)
        a, cache = attention.attention_block(layer.attn, h, cfg)
        ks[li].copy_(attention.ring_rows(cache.k, W))
        vs[li].copy_(attention.ring_rows(cache.v, W))
        x = _mlp(layer, x + a, cfg)
    return x, (ks, vs)


def _layer_train(layer: DecoderLayer, x: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the training loop: no cache; returns x and the layer's
    MoE auxiliary loss (0 without experts)."""
    h = layers.rms_norm(x, layer.ln1, cfg.norm_eps)
    a, _ = attention.attention_block(layer.attn, h, cfg)
    return _mlp(layer, x + a, cfg, aux=True)


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward, the counterpart of ``jax.checkpoint``.  Without grad mode it
    is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def run_layers_train(layer_list: nn.ModuleList, x: torch.Tensor,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training layer loop over x (B, S, d), differentiable: no KV
    cache, every layer rematerialised (``remat``; JAX checkpoints each layer
    of its scan, and with ``cfg.remat`` each group too, which changes its
    memory, not its values).  Returns x and the MoE auxiliary loss summed
    over layers (fp32; 0 without experts), as JAX's ``run_layers_seq``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layer_list:
        x, a = remat(_layer_train, layer, x, cfg)
        aux = aux + a
    return x, aux


def run_layers_decode(
    layer_list: nn.ModuleList,
    x: torch.Tensor,               # (B, 1, d)
    cache_k: torch.Tensor,         # (L, B, S, Hkv, Dh) or a pool (L, P, ps, Hkv, Dh)
    cache_v: torch.Tensor,
    cache_len: torch.Tensor,       # (B,) int32
    cfg: ModelConfig,
    page_table: Optional[torch.Tensor] = None,   # (B, nb) int32 => paged pool
    write_plan: Optional[tuple] = None,          # attention.paged_decode_plan
) -> torch.Tensor:
    for li, layer in enumerate(layer_list):
        h = layers.rms_norm(x, layer.ln1, cfg.norm_eps)
        x = x + attention.attention_decode(
            layer.attn, h, attention.KVCache(cache_k[li], cache_v[li]), cache_len, cfg,
            page_table=page_table, write_plan=write_plan)
        x = _mlp(layer, x, cfg)
    return x


def run_layers_mixed(
    layer_list: nn.ModuleList,
    x: torch.Tensor,               # (B, Q, d) — ragged new-token suffixes
    cache_k: torch.Tensor,         # (L, B, S, Hkv, Dh) or a pool (L, P, ps, Hkv, Dh)
    cache_v: torch.Tensor,
    cache_lens: torch.Tensor,      # (B,) int32 tokens already cached
    write_plan: tuple,             # attention.mixed_write_plan / paged_write_plan
    cfg: ModelConfig,
    attn_window: Optional[int] = None,
    page_table: Optional[torch.Tensor] = None,   # (B, nb) int32 => paged pool
) -> torch.Tensor:
    """``run_layers_decode`` generalised to a ragged q-chunk per slot."""
    for li, layer in enumerate(layer_list):
        h = layers.rms_norm(x, layer.ln1, cfg.norm_eps)
        x = x + attention.attention_mixed(
            layer.attn, h, attention.KVCache(cache_k[li], cache_v[li]), cache_lens, cfg,
            write_plan, attn_window=attn_window, page_table=page_table)
        x = _mlp(layer, x, cfg)
    return x


def logits_from_hidden(head: torch.Tensor, final_norm: torch.Tensor, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """Final norm, then the (d, V) head -- the encoder's ``encoder_head``, else
    ``embed.T`` when tied, ``lm_head`` otherwise: (B, S, d) -> (B, S, V)."""
    x = layers.rms_norm(x, final_norm, cfg.norm_eps)
    return x @ head


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions, in fp32: logsumexp minus the
    gold logit, the mean over every position, or with ``mask`` the masked
    sum over ``max(sum(mask), 1)`` (JAX ``softmax_xent``)."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - lf.gather(-1, targets.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
