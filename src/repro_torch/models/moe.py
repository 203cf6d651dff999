"""Mixture-of-Experts block of the serving path: top-k routing and
capacity-bucketed dispatch, the expert SwiGLU, the weighted combine.

Counterpart of the single-shard path of the JAX package's
``models/moe.py`` (``_route``, ``_dispatch``, ``_expert_ffn``,
``_combine``, ``_capacity``, ``moe_block``); its ``shard_map`` path over a
device mesh is not ported.  The semantics are JAX's, bit for bit where the
arithmetic allows:

* routing in fp32 (``router`` is fp32 in a bf16 model): softmax, the top
  k by a stable sort (the lower expert first among equal probabilities, as
  ``lax.top_k``), renormalised, and the Switch load-balancing loss;
* every token of the call competes for ``capacity(T)`` rows per expert,
  T the call's flattened token count (idle decode slots and mixed-step
  padding columns included); an assignment's row is its exclusive rank
  within its expert in token-major order, and assignments past capacity
  fall to the overflow row and add nothing;
* the gate product keeps an fp32 result, ``silu`` of it is cast to the
  model dtype before the product with the up projection (JAX's
  ``preferred_element_type=jnp.float32``);
* the combine gathers each assignment's expert row, weights it, and sums
  the k rows of a token as a (T, k, d) reduction: no atomics, so the
  block is deterministic, and every shape is static (no host read, no
  data-dependent size), so the decode chunk and the mixed step capture it
  in their CUDA graphs.

The expert products are batched matmuls (``torch.bmm``), as the JAX
expert products are einsums outside any Pallas kernel.  Under autograd
(``moe_block(..., aux=True)`` in the training loop) every piece is
differentiable; the card's bf16 gate product through ``GateUp``.  The layer holds
the gate and up matrices fused, ``w_gu`` (E, d, 2f), as the dense layer
holds ``w_gu``: one batched matmul with an fp32 result, whose up half is
rounded to the model dtype exactly as a model-dtype matmul rounds it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


class MoE(nn.Module):
    """One layer's MoE weights: ``router`` (d, E) in fp32, ``w_gu`` (E, d,
    2f) = [w_gate | w_up] per expert, ``w_down`` (E, f, d); with a dense
    residual (arctic) also ``res_gu`` (d, 2fr) and ``res_down`` (fr, d)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(device=device, dtype=dtype)

        def param(*shape, **over):
            return nn.Parameter(torch.empty(*shape, **{**kw, **over}), requires_grad=False)

        self.router = param(d, E, dtype=torch.float32)
        self.w_gu = param(E, d, 2 * f)
        self.w_down = param(E, f, d)
        if cfg.moe_dense_residual:
            fr = cfg.dense_residual_ff or f
            self.res_gu = param(d, 2 * fr)
            self.res_down = param(fr, d)


class Dispatch(NamedTuple):
    buf: torch.Tensor         # (E, C, d) the kept tokens, zero rows past each expert's load
    slot: torch.Tensor        # (T·k,) int64 buffer row of each assignment, E·C if dropped
    combine_w: torch.Tensor   # (T·k,) gate, 0 if dropped, in the model dtype


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert for a call of ``tokens`` tokens: int(T·k·cf / E),
    at least 4 (JAX ``_capacity``)."""
    return max(int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 4)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int, *, aux: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """x (T, d) -> gates (T, k) fp32, experts (T, k) int64, and with
    ``aux`` the Switch loss E·sum(mean probs · mean picks) (else None)."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    loss = None
    if aux:
        E = router.shape[-1]
        picks = (experts[..., None] == torch.arange(E, device=x.device)).float()
        loss = E * (probs.mean(dim=0) * picks.sum(dim=1).mean(dim=0)).sum()
    return gates, experts, loss


def dispatch(x: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
             n_experts: int, cap: int) -> Dispatch:
    """Capacity-bucketed scatter (JAX ``_dispatch`` at offset 0): each kept
    assignment's token lands at row ``expert·C + rank`` of the buffer, rank
    its exclusive cumsum within its expert in token-major order.  Each kept
    row has one source, so the scatter is deterministic; dropped
    assignments all go to the overflow row, which is cut off."""
    T, d = x.shape
    k = gates.shape[1]
    flat_e = experts.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(n_experts, device=x.device)).long()
    ranks = onehot.cumsum(dim=0) - onehot
    rank = ranks.gather(1, flat_e[:, None])[:, 0]
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank, n_experts * cap)
    token_idx = torch.arange(T * k, device=x.device) // k
    buf = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, x.index_select(0, token_idx))
    combine_w = (gates.reshape(-1) * keep.float()).to(x.dtype)
    return Dispatch(buf[:-1].reshape(n_experts, cap, d), slot, combine_w)


def combine(y: torch.Tensor, slot: torch.Tensor, combine_w: torch.Tensor, T: int) -> torch.Tensor:
    """Weighted gather back to token order (JAX ``_combine``): y (E, C, d)
    -> (T, d), each token the sum over its k assignments of its expert row
    times its weight (the overflow row is zero)."""
    E, C, d = y.shape
    y_flat = torch.cat([y.reshape(E * C, d), y.new_zeros(1, d)])
    picked = y_flat.index_select(0, slot) * combine_w[:, None]
    return picked.reshape(T, -1, d).sum(dim=1)


class GateUp(torch.autograd.Function):
    """The bf16 batched product with an fp32 result on the card, with a
    backward: ``torch.bmm(..., out_dtype=torch.float32)`` has none.  The
    gradients are JAX's transpose of its ``preferred_element_type=float32``
    einsum: the fp32 cotangent times the other operand widened to fp32,
    rounded to the operand's dtype."""

    @staticmethod
    def forward(ctx, buf, w_gu):
        ctx.save_for_backward(buf, w_gu)
        return torch.bmm(buf, w_gu, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        buf, w_gu = ctx.saved_tensors
        g = g.float()
        d_buf = (torch.bmm(g, w_gu.float().transpose(1, 2)).to(buf.dtype)
                 if ctx.needs_input_grad[0] else None)
        d_w = (torch.bmm(buf.float().transpose(1, 2), g).to(w_gu.dtype)
               if ctx.needs_input_grad[1] else None)
        return d_buf, d_w


def gate_up(buf: torch.Tensor, w_gu: torch.Tensor) -> torch.Tensor:
    """(E, C, d) x (E, d, 2f) with an fp32 result: on the card a bf16 batched
    matmul with an fp32 output (``GateUp``, for its backward); on
    the CPU, which has no such kernel, the same products of the same values
    in fp32."""
    if buf.dtype == torch.float32:
        return torch.bmm(buf, w_gu)
    if buf.is_cuda:
        return GateUp.apply(buf, w_gu)
    return torch.bmm(buf.float(), w_gu.float())


def expert_ffn(buf: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their buffers (JAX ``_expert_ffn``): the gate
    in fp32, ``silu`` of it cast to the model dtype, times the up product
    in the model dtype, through ``w_down``: (E, C, d) -> (E, C, d)."""
    g, u = gate_up(buf, w_gu).chunk(2, dim=-1)
    h = F.silu(g).to(buf.dtype) * u.to(buf.dtype)
    return torch.bmm(h, w_down)


def dispatch_compute_combine(x: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
                             w_gu: torch.Tensor, w_down: torch.Tensor, cap: int) -> torch.Tensor:
    """Scatter, the experts' SwiGLU, weighted gather: (T, d) -> (T, d)."""
    dp = dispatch(x, gates, experts, w_gu.shape[0], cap)
    return combine(expert_ffn(dp.buf, w_gu, w_down), dp.slot, dp.combine_w, x.shape[0])


def moe_block(p: MoE, x: torch.Tensor, cfg: ModelConfig, *, aux: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), the aux loss or None): all B·S tokens
    route and compete for capacity together; with a dense residual, its
    SwiGLU on the same ``x`` is added after the combine."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gates, experts, loss = route(xf, p.router, cfg.top_k, aux=aux)
    out = dispatch_compute_combine(xf, gates, experts, p.w_gu, p.w_down,
                                   capacity(B * S, cfg)).reshape(B, S, d)
    if cfg.moe_dense_residual:
        out = out + layers.swiglu_fused(x, p.res_gu, p.res_down)
    return out, loss
