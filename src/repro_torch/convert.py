"""Weights from the JAX package's parameter tree into the port's state.

``params_from_jax`` takes the output of the JAX ``Model(cfg).init(key)``
with every leaf already converted to numpy (the caller does
``jax.tree.map(np.asarray, params)``; this module imports no JAX) and
returns a state dict for ``repro_torch.models.Model.load_state_dict``.
It splits the stacked ``(L, ...)`` layer leaves per layer and fuses what
the port keeps fused: ``wqkv = [wq|wk|wv]``, ``w_gu = [w_gate|w_up]`` and
the per-head ``qk_norm`` weight.  An rwkv layer's leaves keep their JAX
names and dtypes (``ln_x_w``/``ln_x_b`` stay fp32) with no fusion: each of
r, k, v, w and g projects its own mixed input.  An untied ``lm_head`` is
kept.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, rwkv6


def _t(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    # numpy has no bfloat16: go through fp32, which holds bf16 values exactly
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.tensor(arr).to(dtype)


def params_from_jax(tree: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """numpy JAX params -> ``Model`` state dict (CPU tensors in cfg.dtype)."""
    dtype = cfg.torch_dtype
    state = {
        "embed": _t(tree["embed"], dtype),
        "final_norm": _t(tree["final_norm"], dtype),
    }
    if not cfg.tie_embeddings:
        state["lm_head"] = _t(tree["lm_head"], dtype)
    lay = tree["layers"]
    if cfg.family == "rwkv":
        fp32 = {"ln_x_w", "ln_x_b"}
        for name in rwkv6.RWKVLayer(cfg, device="meta", dtype=dtype).state_dict():
            for li in range(cfg.n_layers):
                state[f"layers.{li}.{name}"] = _t(lay[name][li],
                                                  torch.float32 if name in fp32 else dtype)
        return state
    at, mlp = lay["attn"], lay["mlp"]
    for li in range(cfg.n_layers):
        pre = f"layers.{li}."
        state[pre + "ln1"] = _t(lay["ln1"][li], dtype)
        state[pre + "ln2"] = _t(lay["ln2"][li], dtype)
        state[pre + "attn.wqkv"] = attention.fuse_qkv_weights(
            _t(at["wq"][li], dtype), _t(at["wk"][li], dtype), _t(at["wv"][li], dtype))
        state[pre + "attn.wo"] = _t(at["wo"][li], dtype)
        if cfg.qk_norm:
            state[pre + "attn.qk_norm"] = attention.fuse_qk_norm(
                _t(at["q_norm"][li], dtype), _t(at["k_norm"][li], dtype),
                cfg.n_heads, cfg.n_kv_heads).contiguous()
        state[pre + "w_gu"] = layers.fuse_gate_up_weights(
            _t(mlp["w_gate"][li], dtype), _t(mlp["w_up"][li], dtype))
        state[pre + "w_down"] = _t(mlp["w_down"][li], dtype)
    return state
