"""Plain PyTorch versions of the Mamba-2 SSD scan (the CUDA kernel's oracles).

Per head h, with P channels, N state dims and a scalar decay per step:

    S_t = exp(dt_t · A_h) · S_{t-1} + dt_t · x_t ⊗ B_t        S ∈ R^{P×N}
    y_t = S_t · C_t

* ``ssd_ref`` — the exact per-step recurrence, as the JAX package's
  ``kernels/ssd_scan/ref.py`` ``ssd_ref``.
* ``ssd_chunked`` — the chunk form of the JAX ``models/mamba2.py``
  ``ssd_chunked`` (which the TPU kernel ``_ssd_kernel`` computes): per
  chunk an inter-chunk term ``exp(cum_t) · C_t · S_prev``, a (C, C)
  pairwise-decay product within the chunk and the carried state.  It takes
  any length: the JAX form asserts ``S % min(128, S) == 0``; here the tail
  chunk is padded with dt = 0 tokens (exp(0·A) = 1 and a zero update leave
  the state unchanged) whose rows are dropped.  The pairwise decays are
  masked (s > t) before the exp, so exp(cum_t - cum_s) never overflows.
  ``ops.ssd`` runs this form on the CPU.

Both take x (B, S, H, P) and B/C (B, S, N) in bf16 or fp32, dt (B, S, H),
A (H,) and state0 (B, H, P, N) fp32; both compute in fp32 and return y
(B, S, H, P) fp32 and the final state (B, H, P, N) fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

CHUNK = 128


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step recurrence; returns (y, final state)."""
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    Af = A.float()
    state = state0.float().clone()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dtf[:, t] * Af[None])                                  # (B, H)
        upd = dtf[:, t, :, None, None] * xf[:, t, :, :, None] * Bf[:, t, None, None, :]
        state = da[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, state0: torch.Tensor,
                chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX chunk form (``min(chunk, S)`` tokens per chunk) at any
    length; returns (y, final state)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    if pad:
        # dt = 0 rows: decay exp(0) = 1 and a zero update, so the state passes through
        xf, Bf, Cf = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    xc = xf.reshape(B, nc, chunk, H, P).permute(1, 0, 3, 2, 4)               # (nc, B, H, C, P)
    dtc = dtf.reshape(B, nc, chunk, H).permute(1, 0, 3, 2)                   # (nc, B, H, C)
    Bc = Bf.reshape(B, nc, chunk, N).transpose(0, 1)                         # (nc, B, C, N)
    Cc = Cf.reshape(B, nc, chunk, N).transpose(0, 1)
    Af = A.float()
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    state = state0.float()
    ys = []
    for c in range(nc):
        xb, dtb, Bb, Cb = xc[c], dtc[c], Bc[c], Cc[c]
        da = dtb * Af[None, :, None]                                         # (B, H, C) <= 0
        cum = torch.cumsum(da, dim=2)
        # inter-chunk: y_t += exp(cum[t]) · C_t · S_prev
        y_inter = torch.einsum("bcn,bhpn->bhcp", Cb, state) * torch.exp(cum)[..., None]
        # intra-chunk pairwise decays exp(cum[t] - cum[s]) for s <= t, masked before the exp
        diff = cum[:, :, :, None] - cum[:, :, None, :]
        G = torch.exp(torch.where(tri, diff, torch.full_like(diff, -torch.inf)))
        cb = torch.einsum("btn,bsn->bts", Cb, Bb)                            # (B, C, C)
        att = cb[:, None] * G * dtb[:, :, None, :]                           # weight dt_s
        y_intra = torch.einsum("bhts,bhsp->bhtp", att, xb)
        dec_end = torch.exp(cum[:, :, -1:] - cum)                            # (B, H, C)
        state = (torch.exp(cum[:, :, -1])[..., None, None] * state
                 + torch.einsum("bhs,bhsp,bsn->bhpn", dtb * dec_end, xb, Bb))
        ys.append(y_inter + y_intra)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nc * chunk, H, P)
    return y[:, :S], state
