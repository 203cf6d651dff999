"""Model facade of the port (dense family): decode and mixed steps.

    model = Model(cfg, device="cuda").init_(torch.Generator("cuda").manual_seed(0))
    cache = model.empty_cache(batch, max_len)
    logits = model.decode(tokens, cache, cache_len)              # (B, V)
    logits = model.step_mixed(tokens, cache, cache_lens, new_lens)

Counterpart of the JAX package's ``models/model.py`` for the serving path.
The KV cache keeps the JAX layout ``(L, B, S, Hkv, Dh)`` and is updated in
place (the JAX engine donated it).  ``device`` defaults to the card; a
missing card raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, transformer


class DecoderKVCache(NamedTuple):
    k: torch.Tensor   # (L, B, Sc, Hkv, Dh)
    v: torch.Tensor


def _host_ints(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, np.int64)


class Model(nn.Module):
    """Embedding, an ``nn.ModuleList`` of ``DecoderLayer``s and the final
    norm; the head is the tied embedding.  Parameters are allocated empty
    on ``device``: call ``init_`` (seeded) or ``load_state_dict``
    (``convert.params_from_jax``) before use."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = cfg.torch_dtype
        kw = dict(device=self.device, dtype=dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw),
                                  requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, **kw), requires_grad=False)
        self.layers = nn.ModuleList(
            transformer.DecoderLayer(cfg, device=self.device, dtype=dtype)
            for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Model":
        """Seeded random weights (the JAX init's distributions): embedding
        N(0, 0.02²), matrices N(0, 1/fan_in), norms at one."""
        transformer._normal_(self.embed, 0.02, generator)
        self.final_norm.fill_(1.0)
        for layer in self.layers:
            transformer.init_layer_(layer, self.cfg, generator)
        return self

    # -- serving ------------------------------------------------------------
    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: DecoderKVCache,
               cache_len: torch.Tensor) -> torch.Tensor:
        """tokens (B, 1); cache_len (B,) int32 per-slot lengths.  Writes the
        new KV into ``cache`` and returns next-token logits (B, V)."""
        x = self.embed[tokens]
        x = transformer.run_layers_decode(self.layers, x, cache.k, cache.v,
                                          cache_len.to(self.device, torch.int32), self.cfg)
        return transformer.logits_from_hidden(self.embed, self.final_norm, x, self.cfg)[:, 0]

    @torch.no_grad()
    def step_mixed(self, tokens: torch.Tensor, cache: DecoderKVCache,
                   cache_lens: Union[np.ndarray, torch.Tensor],
                   new_lens: Union[np.ndarray, torch.Tensor], *,
                   attn_window: Optional[int] = None,
                   all_logits: bool = False) -> torch.Tensor:
        """One mixed-batch step: slot b advances by ``tokens[b, :new_lens[b]]``
        from cache position ``cache_lens[b]``.  Returns the logits at column
        ``max(new_lens - 1, 0)`` (B, V), or with ``all_logits`` at every
        column (B, Q, V).

        The lengths are read on the host (the engine keeps them there) to
        place the chunk's KV rows; a device tensor is copied back first."""
        if not self.supports_mixed_step:
            raise ValueError(f"{self.cfg.name}: mixed-batch step unsupported")
        B, Q = tokens.shape
        cl, nl = _host_ints(cache_lens), _host_ints(new_lens)
        S = cache.k.shape[2]
        src, dst = attention.mixed_write_index(cl, nl, Q, S)
        write_index = (torch.as_tensor(src, device=self.device),
                       torch.as_tensor(dst, device=self.device))
        lens_dev = torch.as_tensor(cl, dtype=torch.int32, device=self.device)
        x = self.embed[tokens]
        x = transformer.run_layers_mixed(self.layers, x, cache.k, cache.v, lens_dev,
                                         write_index, self.cfg, attn_window)
        if all_logits:
            return transformer.logits_from_hidden(self.embed, self.final_norm, x, self.cfg)
        last = torch.as_tensor(np.maximum(nl - 1, 0), device=self.device)
        x_last = x[torch.arange(B, device=self.device), last][:, None]
        return transformer.logits_from_hidden(self.embed, self.final_norm, x_last, self.cfg)[:, 0]

    @property
    def supports_mixed_step(self) -> bool:
        """Every model the port builds (dense, full attention, tokens in)."""
        return self.cfg.supports_decode

    def empty_cache(self, batch: int, max_len: int) -> DecoderKVCache:
        """The (L, B, max_len, Hkv, Dh) cache, zeroed."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        kw = dict(dtype=cfg.torch_dtype, device=self.device)
        return DecoderKVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw))
