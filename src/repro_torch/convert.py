"""Weights from the JAX package's parameter tree into the port's state.

``params_from_jax`` takes the output of the JAX ``Model(cfg).init(key)``
with every leaf already converted to numpy (the caller does
``jax.tree.map(np.asarray, params)``; this module imports no JAX) and
returns a state dict for ``repro_torch.models.Model.load_state_dict``.
It splits the stacked ``(L, ...)`` layer leaves per layer and fuses what
the port keeps fused: ``wqkv = [wq|wk|wv]``, ``w_gu = [w_gate|w_up]`` and
the per-head ``qk_norm`` weight.  An rwkv layer's leaves keep their JAX
names and dtypes (``ln_x_w``/``ln_x_b`` stay fp32) with no fusion: each of
r, k, v, w and g projects its own mixed input.  So do a Mamba-2 layer's
(``A_log``, ``D`` and ``dt_bias`` stay fp32); the hybrid's one ``shared``
block is fused as a dense layer is.  An untied ``lm_head`` is kept; a
GELU layer's ``w_up``/``w_down`` stay unfused; the encoder's ``head``
becomes ``encoder_head``, and it has no ``embed``.  An MoE layer's ``moe``
leaves become ``moe.router`` (fp32 in any model dtype), ``moe.w_gu`` =
[w_gate | w_up] per expert (E, d, 2f), ``moe.w_down``, and with a dense
residual ``moe.res_gu`` = [res_gate | res_up] and ``moe.res_down``.

``diffusion_params_from_jax`` does the same for the job engine's two
leaves (``DiffusionEngine.w_mix``, ``w_cond``), for
``serving.diffusion.DiffusionEngine.load_params``.

``frontier_fields`` and ``frontier_from_fields`` carry durable-KV
frontiers across, the counterpart of ``params_from_jax`` for state: a
``KVFrontier`` or ``StateFrontier`` of either package becomes plain fields
and numpy leaves (its payload NamedTuple's ``_asdict()``; bf16 leaves as
float32, which is exact) and back, by duck typing.  The two packages' cache
NamedTuples have the same field names and layouts (``DecoderKVCache(k,
v)``, ``RWKVLayerCache(state, shift_att, shift_ffn)``, ``Zamba2Cache(conv,
state, attn_k, attn_v)``), so a frontier taken from one package's session
resumes in the other's.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, mamba2, model, rwkv6, zamba2
from repro_torch.serving.backends import StateFrontier
from repro_torch.serving.paged_kv import KVFrontier


def _host(a) -> np.ndarray:
    # numpy has no bfloat16: go through fp32, which holds bf16 values exactly
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _t(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(_host(a)).to(dtype)


def params_from_jax(tree: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """numpy JAX params -> ``Model`` state dict (CPU tensors in cfg.dtype)."""
    dtype = cfg.torch_dtype
    state = {"final_norm": _t(tree["final_norm"], dtype)}
    if cfg.input_mode == "tokens":
        state["embed"] = _t(tree["embed"], dtype)
    if cfg.family == "encoder":
        state["encoder_head"] = _t(tree["head"], dtype)
    elif not cfg.tie_embeddings:
        state["lm_head"] = _t(tree["lm_head"], dtype)
    lay = tree["layers"]
    if cfg.family in ("rwkv", "hybrid"):
        # per-layer leaves under their JAX names, no fusion
        layer_cls, fp32 = ((rwkv6.RWKVLayer, {"ln_x_w", "ln_x_b"}) if cfg.family == "rwkv"
                           else (mamba2.Mamba2Layer, {"A_log", "D", "dt_bias"}))
        for name in layer_cls(cfg, device="meta", dtype=dtype).state_dict():
            for li in range(cfg.n_layers):
                state[f"layers.{li}.{name}"] = _t(lay[name][li],
                                                  torch.float32 if name in fp32 else dtype)
        if cfg.family == "hybrid":
            sh = tree["shared"]
            _decoder_layer(state, "shared.", sh, sh["attn"], sh["mlp"], None, cfg)
        return state
    for li in range(cfg.n_layers):
        _decoder_layer(state, f"layers.{li}.", lay, lay["attn"], lay.get("mlp"), li, cfg)
        if cfg.is_moe:
            _moe_layer(state, f"layers.{li}.moe.", lay["moe"], li, cfg)
    return state


def _moe_layer(state: Dict[str, torch.Tensor], pre: str, m: Mapping, li: int,
               cfg: ModelConfig) -> None:
    """Layer ``li`` of the stacked JAX ``moe`` leaves, fused as ``moe.MoE``
    holds them."""
    dtype = cfg.torch_dtype
    state[pre + "router"] = _t(m["router"][li], torch.float32)
    state[pre + "w_gu"] = torch.cat([_t(m["w_gate"][li], dtype), _t(m["w_up"][li], dtype)], -1)
    state[pre + "w_down"] = _t(m["w_down"][li], dtype)
    if cfg.moe_dense_residual:
        state[pre + "res_gu"] = layers.fuse_gate_up_weights(_t(m["res_gate"][li], dtype),
                                                             _t(m["res_up"][li], dtype))
        state[pre + "res_down"] = _t(m["res_down"][li], dtype)


def diffusion_params_from_jax(w_mix, w_cond) -> Dict[str, torch.Tensor]:
    """The JAX ``DiffusionEngine``'s ``w_mix`` (D, D) and ``w_cond`` (D,),
    as numpy, -> ``DiffusionEngine.load_params``' float32 CPU tensors."""
    w_mix, w_cond = np.asarray(w_mix, np.float32), np.asarray(w_cond, np.float32)
    if w_mix.ndim != 2 or w_mix.shape[0] != w_mix.shape[1] or w_cond.shape != w_mix.shape[:1]:
        raise ValueError(f"w_mix {w_mix.shape} and w_cond {w_cond.shape} are not (D, D) and (D,)")
    return {"w_mix": torch.tensor(w_mix), "w_cond": torch.tensor(w_cond)}


def _decoder_layer(state: Dict[str, torch.Tensor], pre: str, lay: Mapping, at: Mapping,
                   mlp: Mapping, li, cfg: ModelConfig) -> None:
    """One ``DecoderLayer``'s entries under ``pre``, fused: layer ``li`` of
    stacked leaves, or with ``li`` None unstacked leaves (the shared block);
    an MoE layer's ``moe`` block is ``_moe_layer``'s."""
    dtype = cfg.torch_dtype

    def leaf(tree, name):
        return _t(tree[name] if li is None else tree[name][li], dtype)

    state[pre + "ln1"] = leaf(lay, "ln1")
    state[pre + "ln2"] = leaf(lay, "ln2")
    state[pre + "attn.wqkv"] = attention.fuse_qkv_weights(
        leaf(at, "wq"), leaf(at, "wk"), leaf(at, "wv"))
    state[pre + "attn.wo"] = leaf(at, "wo")
    if cfg.qk_norm:
        state[pre + "attn.qk_norm"] = attention.fuse_qk_norm(
            leaf(at, "q_norm"), leaf(at, "k_norm"), cfg.n_heads, cfg.n_kv_heads).contiguous()
    if cfg.is_moe:
        return
    if cfg.mlp_type == "gelu":
        state[pre + "w_up"] = leaf(mlp, "w_up")
    else:
        state[pre + "w_gu"] = layers.fuse_gate_up_weights(leaf(mlp, "w_gate"), leaf(mlp, "w_up"))
    state[pre + "w_down"] = leaf(mlp, "w_down")


def frontier_fields(fr) -> Dict[str, Any]:
    """A ``KVFrontier`` (``pages_kv``) or ``StateFrontier`` (``state``) of
    either package as plain fields: ``kind`` ("kv" or "state"), the token
    fields as ints, ``page_size``, and ``leaves``, the payload's
    ``_asdict()`` as numpy arrays (bf16 as float32)."""
    kind = "kv" if hasattr(fr, "pages_kv") else "state"
    payload = fr.pages_kv if kind == "kv" else fr.state
    return dict(kind=kind, prompt=tuple(int(t) for t in fr.prompt),
                generated=tuple(int(t) for t in fr.generated), carry_tok=int(fr.carry_tok),
                page_size=int(fr.page_size),
                leaves={name: np.array(_host(leaf)) for name, leaf in payload._asdict().items()})


def frontier_from_fields(fields: Mapping[str, Any], frontier_cls: Optional[type] = None,
                         payload_cls: Optional[type] = None):
    """``frontier_fields``' output back into a frontier: by default the
    port's (``KVFrontier`` or ``StateFrontier`` by ``kind``, the payload
    NamedTuple by its field names); pass another package's frontier class
    and cache NamedTuple to build its frontier instead."""
    leaves = fields["leaves"]
    if payload_cls is None:
        payload_cls = next(c for c in (model.DecoderKVCache, rwkv6.RWKVLayerCache,
                                       zamba2.Zamba2Cache) if set(c._fields) == set(leaves))
    payload = payload_cls(**leaves)
    tokens = dict(prompt=tuple(fields["prompt"]), generated=tuple(fields["generated"]),
                  carry_tok=int(fields["carry_tok"]), page_size=int(fields["page_size"]))
    if fields["kind"] == "kv":
        return (frontier_cls or KVFrontier)(pages_kv=payload, **tokens)
    return (frontier_cls or StateFrontier)(state=payload, **tokens)
