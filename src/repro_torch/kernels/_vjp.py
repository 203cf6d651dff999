"""The backward of the kernels' ``autograd.Function``s: the plain version's
autograd, recomputed.

The JAX package wraps each Pallas kernel on the training path in a
``jax.custom_vjp`` whose forward is the kernel and whose backward is
``jax.vjp`` of the pure-lax oracle, recomputed from the saved inputs.  The
port does the same: the forward launches the CUDA kernel (the plain version
on the CPU), and ``recompute_vjp`` runs the plain version again under
autograd on detached copies of the inputs and returns their gradients.
There is no backward kernel.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def recompute_vjp(fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
                  grad_outputs: Sequence[Optional[torch.Tensor]],
                  needs: Sequence[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``fn(*inputs)`` (a tensor or a tuple of tensors) with
    respect to the inputs flagged in ``needs``, given the outputs'
    gradients; None for the others, for a None input, and for an input the
    outputs do not depend on."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None and o.requires_grad]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        if not pairs or not wrt:
            return tuple(None for _ in inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if t is not None and t.requires_grad else None for t in leaves)
