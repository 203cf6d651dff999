"""AdamW as plain tensor math (the JAX package's ``training/optimizer.py``).

Not ``torch.optim.AdamW``: that one places the weight decay and ``eps``
elsewhere and has no ``grad_clip``, ``moment_dtype`` or
``stacked_update_dtype``.  The update here is JAX's, op for op:

    clip = min(1, grad_clip / max(|g|, 1e-9))         (1 without grad_clip)
    m = b1·m + (1 - b1)·g·clip        in wdt
    v = b2·v + (1 - b2)·g²            in fp32
    upd = m̂ / (sqrt(v̂) + eps) + weight_decay·p
    p = (p32 - lr·upd) in p's dtype;  m, v stored in moment_dtype

with ``wdt = stacked_update_dtype`` for a leaf whose JAX form has at least
3 dims and a leading dim above 4 (a stacked layer weight of a model of
more than 4 layers), else fp32, and ``lr = lr_at(step)`` (linear warm-up,
then cosine decay to ``min_lr_ratio``), all scalars in fp32 on the
parameters' device.

The leaves are a list of tensors (the trainer passes views of the model's
parameters, ``convert.leaf_view``), updated in place: ``update`` writes the
new values into the parameters and the moments and returns them with the
new step.  Each leaf's JAX form is ``(stack[i], *p.shape)`` when
``stack[i]`` (the layers a stacked JAX leaf holds) is given, else
``p.shape``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"        # "bfloat16" for >= 100B archs
    stacked_update_dtype: str = "float32"  # "bfloat16": the update of stacked layer weights
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor             # scalar int32
    m: List[torch.Tensor]          # first moments, one per leaf
    v: List[torch.Tensor]          # second moments


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in fp32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init(params: Sequence[torch.Tensor], cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.moment_dtype)
    device = params[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=[torch.zeros(p.shape, dtype=dt, device=p.device) for p in params],
        v=[torch.zeros(p.shape, dtype=dt, device=p.device) for p in params],
    )


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _wdt(cfg: AdamWConfig, p: torch.Tensor, stack: int) -> torch.dtype:
    shape = (stack, *p.shape) if stack else tuple(p.shape)
    return (getattr(torch, cfg.stacked_update_dtype) if len(shape) >= 3 and shape[0] > 4
            else torch.float32)


@torch.no_grad()
def update(grads: Sequence[torch.Tensor], state: AdamWState, params: Sequence[torch.Tensor],
           cfg: AdamWConfig, *, stack: Optional[Sequence[int]] = None
           ) -> Tuple[Sequence[torch.Tensor], AdamWState, dict]:
    """One AdamW step, in place.  Returns (params, new_state, metrics) with
    metrics {"grad_norm", "lr"}; ``params`` and the moments are the same
    tensors, updated."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            if cfg.grad_clip > 0 else None)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=sf.device), sf)
    mdt = getattr(torch, cfg.moment_dtype)
    stack = stack if stack is not None else [0] * len(params)
    # largest leaves first, as JAX orders its serialised leaf updates
    for i in sorted(range(len(params)), key=lambda i: -params[i].numel()):
        p, g, m, v = params[i], grads[i], state.m[i], state.v[i]
        wdt = _wdt(cfg, p, stack[i])
        gf = g.to(wdt) if clip is None else g.to(wdt) * clip.to(wdt)
        mf = b1 * m.to(wdt) + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * torch.square(g.float())
        mhat = mf.float() / bc1
        vhat = vf / bc2
        upd = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        m.copy_(mf.to(mdt))
        v.copy_(vf.to(mdt))
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
