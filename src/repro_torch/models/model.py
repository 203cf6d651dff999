"""Model facade of the port (dense, moe, vlm, encoder, rwkv and hybrid
families): prefill, decode and mixed steps, and the training loss.

    model = Model(cfg, device="cuda").init_(torch.Generator("cuda").manual_seed(0))
    logits, pcache = model.prefill(tokens)                       # (B, V), (L, B, ...)
    logits, pcache = model.prefill(tokens, patches=patches)      # vlm: (B, Np, d) ahead
    logits, pcache = model.prefill(embeds=x, all_logits=True)    # encoder: (B, S, V)
    cache = model.empty_cache(batch, max_len)
    logits = model.decode(tokens, cache, cache_len)              # (B, V)
    logits = model.step_mixed(tokens, cache, cache_lens, new_lens)
    pool = model.empty_page_pool(num_pages, page_size)           # paged KV
    logits = model.decode(tokens, pool, cache_len, page_table=tables)
    logits = model.prefill_paged(suffix, pool, page_row, start)  # (1, V)
    loss, metrics = model.train_().loss(batch)                   # {"ce", "moe_aux"}

Counterpart of the JAX package's ``models/model.py``.  ``loss`` takes
JAX's batch dict for one microbatch (``inputs``/``targets``; the vlm's
``patches``; the encoder's ``embeds``/``targets``/``mask``) and runs the
cache-free training loops under autograd; ``train_()`` turns
``requires_grad`` on for every parameter (``train_(False)`` off again).
The serving methods run under ``no_grad`` whatever the flag.
The dense KV cache keeps the JAX layout ``(L, B, S, Hkv, Dh)`` (with a
sliding window W, a ring of ``S = min(max_len, W)`` rows, position p at
row p % W), the page pool ``(L, P, page_size, Hkv, Dh)``; the rwkv cache is an
``RWKVLayerCache`` of (L, B, H, N, N) fp32 states and (L, B, d) shift
rows, whatever ``max_len``; the hybrid cache a ``Zamba2Cache`` of (L, B,
K-1, conv_ch) conv tails, (L, B, H, P, N) fp32 Mamba-2 states and one
(G, B, S, Hkv, Dh) KV pair per shared-attention application.  All are
updated in place (the JAX engine donated them).  The rwkv and hybrid
families have no mixed step and no paged KV (``step_mixed``,
``prefill_paged`` and ``empty_page_pool`` raise ``ValueError``, as in
JAX); nor has a model with a sliding window (mixtral), whose decode
cache is the ring.  The moe family routes every token of a call through
its experts together (``moe.moe_block``), idle slots and padding columns
included, so its paged writes to the trash page carry one value per row
(``attention.last_writer``).  The encoder family (hubert) takes frame
embeddings in place of tokens, attends without a causal mask and does
not decode: ``decode``,
``step_mixed``, ``prefill_paged`` and ``empty_page_pool`` raise
``ValueError``.  A vlm prefills its patch embeddings ahead of the text
and then decodes and steps on text as a dense model does.  ``device``
defaults to the card; a missing card raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, mamba2, rwkv6, transformer, zamba2


# weight of the MoE load-balancing loss in the training objective (JAX ``MOE_AUX_WEIGHT``)
MOE_AUX_WEIGHT = 0.01


class DecoderKVCache(NamedTuple):
    k: torch.Tensor   # (L, B, Sc, Hkv, Dh), or a page pool (L, P, ps, Hkv, Dh)
    v: torch.Tensor


# the cache of any family
Cache = Union[DecoderKVCache, rwkv6.RWKVLayerCache, zamba2.Zamba2Cache]


class Model(nn.Module):
    """Embedding (none for embeds input), an ``nn.ModuleList`` of
    ``DecoderLayer``s (dense, moe, vlm, encoder), ``RWKVLayer``s (rwkv) or
    ``Mamba2Layer``s (hybrid, with the one ``shared`` attention
    ``DecoderLayer``) and the final norm; the head is the encoder's
    ``encoder_head`` (d, V) (JAX's ``head`` leaf), the tied embedding, or
    ``lm_head`` (d, V) when untied.  Parameters are allocated
    empty on ``device``: call ``init_`` (seeded) or ``load_state_dict``
    (``convert.params_from_jax``) before use."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = cfg.torch_dtype
        kw = dict(device=self.device, dtype=dtype)
        if cfg.input_mode == "tokens":
            self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw),
                                      requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, **kw), requires_grad=False)
        layer_cls = {"rwkv": rwkv6.RWKVLayer, "hybrid": mamba2.Mamba2Layer}.get(
            cfg.family, transformer.DecoderLayer)
        self.layers = nn.ModuleList(
            layer_cls(cfg, device=self.device, dtype=dtype) for _ in range(cfg.n_layers))
        if self.is_hybrid:
            self.shared = transformer.DecoderLayer(cfg, device=self.device, dtype=dtype)
        if self.is_encoder:
            self.encoder_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size, **kw),
                                             requires_grad=False)
        elif not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size, **kw),
                                        requires_grad=False)

    @property
    def is_rwkv(self) -> bool:
        return self.cfg.family == "rwkv"

    @property
    def is_hybrid(self) -> bool:
        return self.cfg.family == "hybrid"

    @property
    def is_encoder(self) -> bool:
        return self.cfg.family == "encoder"

    @property
    def head(self) -> torch.Tensor:
        """The (d, V) output matrix: the encoder's ``encoder_head``, else ``embed.T``
        when tied, else ``lm_head``."""
        if self.is_encoder:
            return self.encoder_head
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Model":
        """Seeded random weights (the JAX init's distributions): embedding
        N(0, 0.02²), matrices N(0, 1/fan_in) (``lm_head`` and
        ``encoder_head`` too), norms at one; the rwkv layers as
        ``rwkv6.init_rwkv_layer_``, the Mamba-2 layers as
        ``mamba2.init_mamba2_layer_``."""
        if self.cfg.input_mode == "tokens":
            transformer._normal_(self.embed, 0.02, generator)
        self.final_norm.fill_(1.0)
        for layer in self.layers:
            if self.is_rwkv:
                rwkv6.init_rwkv_layer_(layer, generator)
            elif self.is_hybrid:
                mamba2.init_mamba2_layer_(layer, generator)
            else:
                transformer.init_layer_(layer, self.cfg, generator)
        if self.is_hybrid:
            transformer.init_layer_(self.shared, self.cfg, generator)
        if self.is_encoder or not self.cfg.tie_embeddings:
            transformer._normal_(self.head, 1.0 / math.sqrt(self.cfg.d_model), generator)
        return self

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return transformer.logits_from_hidden(self.head, self.final_norm, x, self.cfg)

    # -- training -------------------------------------------------------------
    def train_(self, flag: bool = True) -> "Model":
        """Turn ``requires_grad`` on (``flag``) or off for every parameter.
        Parameters are created with it off; the serving methods never
        record a graph either way."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    def loss(self, batch) -> Tuple[torch.Tensor, dict]:
        """The training objective on one microbatch (JAX ``Model.loss``):
        the backbone without a cache under autograd, the logits, the mean
        cross-entropy (the encoder's masked by ``mask``; the vlm's over the
        text positions only), plus ``MOE_AUX_WEIGHT`` times the MoE
        auxiliary loss summed over layers.  ``batch`` holds arrays or
        tensors: ``inputs`` (B, S) and ``targets`` (B, S); a vlm also
        ``patches`` (B, Np, d), its targets (B, S_text); the encoder
        ``embeds`` (B, S, d), ``targets`` and ``mask`` (B, S).  Returns
        (loss, {"ce", "moe_aux"}), fp32 scalars."""
        cfg = self.cfg
        x = self._embed(batch.get("inputs"), batch.get("patches"), batch.get("embeds"))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if self.is_rwkv:
            x = rwkv6.run_rwkv_train(self.layers, x, cfg)
        elif self.is_hybrid:
            x = zamba2.run_zamba2_train(self.layers, self.shared, x, cfg)
        else:
            x, aux = transformer.run_layers_train(self.layers, x, cfg)
        targets = torch.as_tensor(batch["targets"], device=self.device)
        # the vlm's logits at the text positions only (JAX cuts them after the head)
        logits = self._logits(x[:, x.shape[1] - targets.shape[1]:])
        mask = batch.get("mask")
        mask = None if mask is None else torch.as_tensor(mask, device=self.device)
        ce = transformer.softmax_xent(logits, targets, mask)
        return ce + MOE_AUX_WEIGHT * aux, {"ce": ce, "moe_aux": aux}

    # -- serving ------------------------------------------------------------
    def _embed(self, tokens, patches, embeds) -> torch.Tensor:
        """The JAX batch forms: token embeddings; a vlm's ``patches`` (B, Np,
        d) cast to the working dtype and concatenated ahead of them; or the
        encoder's ``embeds`` (B, S, d) cast to ``cfg.dtype``."""
        cfg = self.cfg
        if self.is_encoder:
            if embeds is None or tokens is not None:
                raise ValueError(f"{cfg.name}: an encoder prefills embeds=, not tokens")
            return torch.as_tensor(embeds, device=self.device).to(cfg.torch_dtype)
        if embeds is not None:
            raise ValueError(f"{cfg.name}: embeds= is the encoder family's input")
        x = self.embed[torch.as_tensor(tokens, device=self.device)]
        if patches is not None:
            if cfg.family != "vlm":
                raise ValueError(f"{cfg.name}: patches= is the vlm family's input")
            x = torch.cat([torch.as_tensor(patches, device=self.device).to(x.dtype), x], dim=1)
        return x

    @torch.no_grad()
    def prefill(self, tokens: Optional[torch.Tensor] = None, *,
                patches: Optional[torch.Tensor] = None, embeds: Optional[torch.Tensor] = None,
                all_logits: bool = False) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S); a vlm also takes ``patches`` (B, Np, d), prefilled
        ahead of the text at positions [0, Np); the encoder takes ``embeds``
        (B, S, d) in place of tokens.  Returns the LAST position's logits
        (B, V) — the all-position logits of a 2000-token prompt at full width
        would be 1.2 GB of fp32 — or with ``all_logits`` every position's (B,
        S, V) (the encoder's output), and the prompt cache: KV (L, B, S, Hkv,
        Dh) (with a sliding window W < S, the ring of the last W positions,
        position p at row p % W), for rwkv the states and shift rows after the last token, for
        hybrid the conv tails, states and (G, B, S, Hkv, Dh) shared-attention
        KV."""
        x = self._embed(tokens, patches, embeds)
        if self.is_rwkv:
            x, cache = rwkv6.run_rwkv_seq(self.layers, x, self.cfg)
        elif self.is_hybrid:
            x, cache = zamba2.run_zamba2_seq(self.layers, self.shared, x, self.cfg)
        else:
            x, (k, v) = transformer.run_layers_seq(self.layers, x, self.cfg)
            cache = DecoderKVCache(k=k, v=v)
        if all_logits:
            return self._logits(x), cache
        return self._logits(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def prefill_paged(self, tokens: torch.Tensor, pool: DecoderKVCache,
                      page_row: Union[np.ndarray, torch.Tensor], start: int) -> torch.Tensor:
        """Continuation prefill of one slot: the (1, T) suffix ``tokens``
        extends a paged cache whose positions [0, ``start``) are already in
        the pages of ``page_row`` ((nb,) int32), writing its KV at
        [start, start + T) in place.  Returns the last position's logits
        (1, V).

        This is ``step_mixed`` at B=1, Q=T, ``cache_lens=[start]`` through
        the table ``page_row[None]``, and runs as that call (the JAX
        ``run_layers_prefill_paged`` gathers the slot's whole cache per
        layer instead; the result is the same function)."""
        if not self.supports_paged_kv:
            raise ValueError(f"{self.cfg.name}: paged prefill unsupported")
        T = tokens.shape[1]
        return self.step_mixed(torch.as_tensor(tokens, device=self.device), pool,
                               self._ints([start]), self._ints([T]),
                               page_table=self._ints(page_row).reshape(1, -1))

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Cache,
               cache_len: torch.Tensor, *,
               page_table: Optional[Union[np.ndarray, torch.Tensor]] = None) -> torch.Tensor:
        """tokens (B, 1); cache_len (B,) int32 per-slot lengths.  Writes the
        new KV (rwkv: states and shift rows) into ``cache`` and returns
        next-token logits (B, V).  With ``page_table`` ((B, n_blocks) int32)
        ``cache`` is the page pool of ``empty_page_pool``, read and written
        through the tables.  An rwkv cache holds no positions, so
        ``cache_len`` is not read, as in JAX; the hybrid's shared attention
        reads it.  The encoder family raises ``ValueError``."""
        if not self.cfg.supports_decode:
            raise ValueError(f"{self.cfg.name}: decode unsupported (family "
                             f"{self.cfg.family!r} does not decode)")
        x = self.embed[tokens]
        if self.is_rwkv:
            if page_table is not None:
                raise ValueError("paged KV is not supported for rwkv caches")
            return self._logits(rwkv6.run_rwkv_decode(self.layers, x, cache, self.cfg))[:, 0]
        if self.is_hybrid:
            if page_table is not None:
                raise ValueError("paged KV is not supported for hybrid caches")
            x = zamba2.run_zamba2_decode(self.layers, self.shared, x, cache,
                                         cache_len.to(self.device, torch.int32), self.cfg)
            return self._logits(x)[:, 0]
        cache_len = cache_len.to(self.device, torch.int32)
        plan = None
        if page_table is not None:
            page_table = self._ints(page_table)
            # an MoE model's idle slots compete for expert capacity: their
            # colliding trash-page rows must read the same on any device
            plan = attention.paged_decode_plan(cache_len, page_table, cache.k.shape[2],
                                               dedupe=self.cfg.is_moe)
        x = transformer.run_layers_decode(self.layers, x, cache.k, cache.v, cache_len, self.cfg,
                                          page_table, plan)
        return self._logits(x)[:, 0]

    @torch.no_grad()
    def step_mixed(self, tokens: torch.Tensor, cache: DecoderKVCache,
                   cache_lens: Union[np.ndarray, torch.Tensor],
                   new_lens: Union[np.ndarray, torch.Tensor], *,
                   page_table: Optional[Union[np.ndarray, torch.Tensor]] = None,
                   attn_window: Optional[int] = None,
                   all_logits: bool = False) -> torch.Tensor:
        """One mixed-batch step: slot b advances by ``tokens[b, :new_lens[b]]``
        from cache position ``cache_lens[b]``.  Returns the logits at column
        ``max(new_lens - 1, 0)`` (B, V), or with ``all_logits`` at every
        column (B, Q, V).  With ``page_table`` ((B, n_blocks) int32)
        ``cache`` is the page pool, read and written through the tables.

        Nothing is read back to the host and every shape follows from the
        arguments' shapes, so the step can be captured in a CUDA graph: the
        chunk's KV rows are placed on the device from the (B,) lengths
        (``attention.mixed_write_plan``, ``paged_write_plan``).  Lengths and
        tables given as host arrays are copied to the device first."""
        if not self.supports_mixed_step:
            raise ValueError(f"{self.cfg.name}: mixed-batch step unsupported "
                             f"(family {self.cfg.family!r})")
        B, Q = tokens.shape
        cl, nl = self._ints(cache_lens), self._ints(new_lens)
        if page_table is not None:
            page_table = self._ints(page_table)
            plan = attention.paged_write_plan(cl, nl, Q, page_table, cache.k.shape[2],
                                              dedupe=self.cfg.is_moe)
        else:
            plan = attention.mixed_write_plan(cl, nl, Q, cache.k.shape[2])
        x = self.embed[tokens]
        x = transformer.run_layers_mixed(self.layers, x, cache.k, cache.v, cl, plan,
                                         self.cfg, attn_window, page_table)
        if all_logits:
            return self._logits(x)
        last = (nl - 1).clamp(min=0)
        x_last = x[torch.arange(B, device=self.device), last][:, None]
        return self._logits(x_last)[:, 0]

    def _ints(self, a) -> torch.Tensor:
        """``a`` as an int32 tensor on the model's device (no copy when it
        already is one)."""
        return torch.as_tensor(a, dtype=torch.int32, device=self.device)

    @property
    def supports_mixed_step(self) -> bool:
        """The mixed step shares the paged-KV contract: a decoding model with
        the (L, ..., S, Hkv, Dh) cache, full attention and token input (the
        JAX rule).  An rwkv or Mamba-2 state cannot replay a multi-token
        suffix per slot in one step."""
        cfg = self.cfg
        return (cfg.supports_decode and cfg.family not in ("rwkv", "hybrid")
                and cfg.sliding_window == 0 and cfg.input_mode == "tokens")

    @property
    def supports_paged_kv(self) -> bool:
        """Paged KV needs a decoding model with the (L, ..., S, Hkv, Dh)
        cache and full attention; scan-state caches have no pages to share."""
        cfg = self.cfg
        return (cfg.supports_decode and cfg.family not in ("rwkv", "hybrid")
                and cfg.sliding_window == 0)

    def empty_page_pool(self, num_pages: int, page_size: int) -> DecoderKVCache:
        """The shared paged-KV pool (L, num_pages, page_size, Hkv, Dh), zeroed."""
        cfg = self.cfg
        if not self.supports_paged_kv:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} (decoding "
                             f"{cfg.supports_decode}) cannot use paged KV")
        pool = attention.empty_page_pool(cfg, cfg.n_layers, num_pages, page_size,
                                         device=self.device, dtype=cfg.torch_dtype)
        return DecoderKVCache(k=pool.k, v=pool.v)

    def empty_cache(self, batch: int, max_len: int) -> Cache:
        """The (L, B, max_len, Hkv, Dh) cache, zeroed (with a sliding
        window W, the ring of min(max_len, W) rows, as JAX sizes it); for
        rwkv the zeroed (L, B, H, N, N) fp32 states and (L, B, d) shift
        rows; for hybrid the zeroed ``Zamba2Cache``."""
        cfg = self.cfg
        if self.is_rwkv:
            return rwkv6.empty_cache(cfg, cfg.n_layers, batch, cfg.torch_dtype, self.device)
        if self.is_hybrid:
            return zamba2.empty_cache(cfg, batch, max_len, cfg.torch_dtype, self.device)
        if cfg.sliding_window > 0:
            max_len = min(max_len, cfg.sliding_window)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        kw = dict(dtype=cfg.torch_dtype, device=self.device)
        return DecoderKVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw))
