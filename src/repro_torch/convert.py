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

The trainer's view of the parameters is JAX's tree: ``leaf_view(model)``
lists one ``Leaf`` per JAX leaf and layer (``layers/3/attn/wq``), each a
slice of a port parameter (``layers.3.attn.wqkv[:, :q_dim]``).  The
optimizer, the checkpoint and the tests work on these leaves, and the
serving modules keep their fused tensors.  Fusing ``wqkv``, ``w_gu`` and
``res_gu`` changes nothing in AdamW, which is elementwise; ``qk_norm`` does:
it holds JAX's two (Dh,) leaves ``q_norm`` and ``k_norm`` copied per head,
so a ``Leaf`` with ``rows`` reads row 0 as the leaf, takes the sum of the
copies' gradient rows as its gradient (JAX's gradient of the broadcast
vector), and ``sync_copies`` writes an updated row 0 back into every copy.
``params_to_jax`` (the inverse of ``params_from_jax``: stacked numpy
leaves under JAX's paths) and ``adamw_state_from_jax`` (JAX's moments and
step onto the leaves) go through the same view.

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

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

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


# ---------------------------------------------------------------------------
# the trainer's leaf view
# ---------------------------------------------------------------------------


class Leaf(NamedTuple):
    """One JAX leaf (one layer of a stacked one) as a slice of a port tensor."""
    path: str                    # JAX's path, "layers/attn/wq"
    layer: Optional[int]         # its index in the stacked (L, ...) leaf; None if unstacked
    param: str                   # the port parameter, "layers.3.attn.wqkv"
    index: tuple                 # the slice of it, () for the whole tensor
    rows: int = 0                # > 0: that many equal copies of the leaf, one a row

    @property
    def key(self) -> str:
        """The trainer's path of the leaf: JAX's, with the layer index after
        the stack's name (``layers/3/attn/wq``)."""
        if self.layer is None:
            return self.path
        head, _, rest = self.path.partition("/")
        return f"{head}/{self.layer}/{rest}"


def _attn_leaves(out: List[Leaf], jpre: str, ppre: str, li: Optional[int],
                 cfg: ModelConfig) -> None:
    qd, kvd, Hq, Hkv = cfg.q_dim, cfg.kv_dim, cfg.n_heads, cfg.n_kv_heads
    cols = slice(None)
    for name, sl in (("wq", slice(0, qd)), ("wk", slice(qd, qd + kvd)),
                     ("wv", slice(qd + kvd, qd + 2 * kvd))):
        out.append(Leaf(f"{jpre}attn/{name}", li, f"{ppre}attn.wqkv", (cols, sl)))
    out.append(Leaf(f"{jpre}attn/wo", li, f"{ppre}attn.wo", ()))
    if cfg.qk_norm:
        out.append(Leaf(f"{jpre}attn/q_norm", li, f"{ppre}attn.qk_norm", (slice(0, Hq),), Hq))
        out.append(Leaf(f"{jpre}attn/k_norm", li, f"{ppre}attn.qk_norm",
                        (slice(Hq, Hq + Hkv),), Hkv))


def _gate_up(out: List[Leaf], jpre: str, gate: str, up: str, li: Optional[int], param: str,
             f: int, lead: tuple = ()) -> None:
    cols = slice(None)
    out.append(Leaf(jpre + gate, li, param, lead + (cols, slice(0, f))))
    out.append(Leaf(jpre + up, li, param, lead + (cols, slice(f, 2 * f))))


def _decoder_leaves(out: List[Leaf], jpre: str, ppre: str, li: Optional[int],
                    cfg: ModelConfig) -> None:
    """A ``DecoderLayer``'s leaves: ``layers/...`` of layer ``li``, or with
    ``li`` None the hybrid's unstacked ``shared/...``."""
    out.append(Leaf(jpre + "ln1", li, ppre + "ln1", ()))
    out.append(Leaf(jpre + "ln2", li, ppre + "ln2", ()))
    _attn_leaves(out, jpre, ppre, li, cfg)
    if cfg.is_moe:
        m, mp = jpre + "moe/", ppre + "moe."
        out.append(Leaf(m + "router", li, mp + "router", ()))
        _gate_up(out, m, "w_gate", "w_up", li, mp + "w_gu", cfg.d_ff, (slice(None),))
        out.append(Leaf(m + "w_down", li, mp + "w_down", ()))
        if cfg.moe_dense_residual:
            _gate_up(out, m, "res_gate", "res_up", li, mp + "res_gu",
                     cfg.dense_residual_ff or cfg.d_ff)
            out.append(Leaf(m + "res_down", li, mp + "res_down", ()))
    elif cfg.mlp_type == "gelu":
        out.append(Leaf(jpre + "mlp/w_up", li, ppre + "w_up", ()))
        out.append(Leaf(jpre + "mlp/w_down", li, ppre + "w_down", ()))
    else:
        _gate_up(out, jpre + "mlp/", "w_gate", "w_up", li, ppre + "w_gu", cfg.d_ff)
        out.append(Leaf(jpre + "mlp/w_down", li, ppre + "w_down", ()))


def leaf_view(cfg: ModelConfig) -> List[Leaf]:
    """Every JAX leaf of ``cfg``'s parameter tree, layer by layer, as
    ``Leaf``s over the port ``Model``'s parameters."""
    out: List[Leaf] = []
    if cfg.input_mode == "tokens":
        out.append(Leaf("embed", None, "embed", ()))
    out.append(Leaf("final_norm", None, "final_norm", ()))
    if cfg.family == "encoder":
        out.append(Leaf("head", None, "encoder_head", ()))
    elif not cfg.tie_embeddings:
        out.append(Leaf("lm_head", None, "lm_head", ()))
    if cfg.family in ("rwkv", "hybrid"):
        layer_cls = rwkv6.RWKVLayer if cfg.family == "rwkv" else mamba2.Mamba2Layer
        names = list(layer_cls(cfg, device="meta", dtype=cfg.torch_dtype).state_dict())
        for li in range(cfg.n_layers):
            out.extend(Leaf(f"layers/{n}", li, f"layers.{li}.{n}", ()) for n in names)
        if cfg.family == "hybrid":
            _decoder_leaves(out, "shared/", "shared.", None, cfg)
        return out
    for li in range(cfg.n_layers):
        _decoder_leaves(out, "layers/", f"layers.{li}.", li, cfg)
    return out


def leaf_tensor(params: Mapping[str, torch.Tensor], leaf: Leaf) -> torch.Tensor:
    """The leaf as a view of its port parameter (row 0 of a copied leaf)."""
    t = params[leaf.param][leaf.index]
    return t[0] if leaf.rows else t


def leaf_grad(grads: Mapping[str, torch.Tensor], leaf: Leaf) -> torch.Tensor:
    """The leaf's gradient from per-parameter gradients: its slice, or for
    a copied leaf the sum of the copies' rows."""
    g = grads[leaf.param][leaf.index]
    return g.sum(dim=0) if leaf.rows else g


@torch.no_grad()
def sync_copies(params: Mapping[str, torch.Tensor], view: Sequence[Leaf]) -> None:
    """Write each copied leaf's row 0 into its other rows."""
    for leaf in view:
        if leaf.rows:
            t = params[leaf.param][leaf.index]
            t[1:] = t[0]


def stack_leaves(view: Sequence[Leaf], values: Sequence[np.ndarray]) -> Dict[str, Any]:
    """Per-leaf arrays -> JAX's nested tree, stacked leaves np.stack'ed over
    layers in order."""
    tree: Dict[str, Any] = {}
    stacks: Dict[str, list] = {}
    for leaf, val in zip(view, values):
        if leaf.layer is None:
            _put(tree, leaf.path, val)
        else:
            stacks.setdefault(leaf.path, []).append(val)
    for path, vals in stacks.items():
        _put(tree, path, np.stack(vals))
    return tree


def _put(tree: Dict[str, Any], path: str, val) -> None:
    *heads, last = path.split("/")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = val


def unstack_leaves(view: Sequence[Leaf], tree: Mapping) -> List[np.ndarray]:
    """JAX's nested tree (numpy) -> one array per leaf of ``view``."""
    out = []
    for leaf in view:
        node = tree
        for h in leaf.path.split("/"):
            node = node[h]
        arr = _host(node)
        out.append(arr if leaf.layer is None else arr[leaf.layer])
    return out


def params_to_jax(model) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: the port ``Model``'s weights as
    JAX's parameter tree of numpy arrays, stacked (L, ...) layer leaves
    under JAX's paths (bf16 as float32, which is exact)."""
    named = dict(model.named_parameters())
    view = leaf_view(model.cfg)
    return stack_leaves(view, [_host_tensor(leaf_tensor(named, leaf)) for leaf in view])


def _host_tensor(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy().copy()


def adamw_state_from_jax(state, model, moment_dtype: str = "float32"):
    """A JAX ``AdamWState`` (step, m, v; numpy leaves) as the port's
    ``training.optimizer.AdamWState`` over ``leaf_view(model.cfg)``: the
    step on the model's device, each leaf's moments in ``moment_dtype``."""
    from repro_torch.training.optimizer import AdamWState

    view = leaf_view(model.cfg)
    dt = getattr(torch, moment_dtype)

    def leaves(tree):
        return [torch.tensor(a).to(device=model.device, dtype=dt)
                for a in unstack_leaves(view, tree)]

    return AdamWState(step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                                        device=model.device),
                      m=leaves(state.m), v=leaves(state.v))
