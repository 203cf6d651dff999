"""Plain PyTorch versions of the WKV6 recurrence (the CUDA kernel's oracles).

    y_t = r_t · (S_{t-1} + (u ∘ k_t)ᵀ v_t)
    S_t = diag(exp(w_t)) · S_{t-1} + k_tᵀ v_t

* ``wkv6_ref`` — the exact per-token recurrence, as the JAX package's
  ``kernels/rwkv6_scan/ref.py`` ``wkv6_ref``.
* ``wkv6_chunked`` — the chunk form the TPU kernel ``_wkv6_kernel``
  computes (inter-chunk ``r·exp(a)·S``, intra-chunk pairwise decays
  ``exp(a_t - cum_s)`` for s < t, the u-bonus diagonal), at any length: a
  short last chunk is one more chunk.  The (B, H, C, C, N) pairwise-decay
  tensor is built one chunk at a time (64 MB at rwkv6-7b's H=64, N=64,
  C=64, B=1).  ``ops.wkv6`` runs this form on the CPU.  One departure from
  the TPU kernel: ``a`` is the shifted inclusive cumsum (``a_0 = 0``,
  ``a_t = cum_{t-1}``, the stored value), not ``cum - w``.  The pair
  (t, t-1) then has the exponent exactly 0; as ``cum - w`` it is the
  rounding error of a large cumulative sum, which at a strong decay
  (log-decays near -20 a token) moved y by up to 2.9e-3 against the exact
  recurrence.

Both take r, k, v (B, S, H, N) in bf16 or fp32, logw (B, S, H, N), u
(H, N) and state0 (B, H, N, N) fp32; both compute in fp32 and return y
(B, S, H, N) fp32 and the final state (B, H, N, N) fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch

CHUNK = 64


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
             u: torch.Tensor, state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token recurrence; returns (y, final state)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    uf = u.float()
    state = state0.float().clone()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]                 # (B, H, N)
        y = torch.einsum("bhn,bhnm->bhm", rt, state)
        y = y + (rt * uf * kt).sum(-1, keepdim=True) * vt
        state = torch.exp(wf[:, t])[..., None] * state + kt[..., :, None] * vt[..., None, :]
        ys.append(y)
    return torch.stack(ys, dim=1), state


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                 u: torch.Tensor, state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's chunk form (``CHUNK`` tokens, its default) at any
    length; returns (y, final state)."""
    B, S, H, N = r.shape
    uf = u.float()
    state = state0.float()
    ys = []
    for c0 in range(0, S, CHUNK):
        # (B, H, C, N) fp32 blocks of this chunk
        rb, kb, vb, wb = (t[:, c0:c0 + CHUNK].float().transpose(1, 2) for t in (r, k, v, logw))
        C = rb.shape[2]
        cum = torch.cumsum(wb, dim=2)                             # inclusive
        # chunk start -> t, exclusive: the stored cum_{t-1}, so that every
        # exponent below is the difference of two stored cumsums
        a = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
        y_inter = (rb * torch.exp(a)) @ state
        tri = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device), diagonal=-1)
        # D[t, s, n] = exp(a[t, n] - cum[s, n]) for s < t (all <= 1), else 0
        expo = a[:, :, :, None, :] - cum[:, :, None, :, :]
        D = torch.exp(torch.where(tri[:, :, None], expo, torch.full_like(expo, -torch.inf)))
        att = torch.einsum("bhtn,bhtsn,bhsn->bhts", rb, D, kb)
        y_intra = att @ vb
        y_bonus = (rb * uf[None, :, None, :] * kb).sum(-1, keepdim=True) * vb
        ys.append((y_inter + y_intra + y_bonus).transpose(1, 2))
        dec_end = torch.exp(cum[:, :, -1:, :] - cum)              # (B, H, C, N)
        state = (torch.exp(cum[:, :, -1, :])[..., None] * state
                 + (kb * dec_end).transpose(-1, -2) @ vb)
    return torch.cat(ys, dim=1), state
