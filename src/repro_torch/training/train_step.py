"""Training step: microbatched gradient accumulation + AdamW (the JAX
package's ``training/train_step.py``).

The batch arrives pre-shaped as (A, micro, ...): A accumulation steps of
``micro`` sequences (``data.batch_for_step`` shapes it).  Each microbatch's
gradients come from ``torch.autograd.grad`` of ``Model.loss`` (so nothing
accumulates in ``.grad`` at the parameters' bf16) and are added to fp32
buffers as ``g.float() / A``, JAX's ``a + b.astype(adt) / A``.  The
optimizer then updates JAX's leaves (``convert.leaf_view``) in place, and
the per-head copies of ``q_norm``/``k_norm`` are written back equal.

The JAX step is a pure function, so ``StepGuard`` may rerun it or drop
its result.  Here the parameters and moments are written in place, so the
step is safe to rerun only until its first write: it writes nothing when
the mean loss is not finite (it reads the loss back to decide), and a
failure in the forward or backward leaves everything as it was; a failure
once the update has begun raises ``StepStateLost``, which ``StepGuard``
passes on without a retry (rerunning would give the leaves already
written a second update), so the job restores its last checkpoint.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch import convert
from repro_torch.distributed.fault_tolerance import StepStateLost
from repro_torch.training import optimizer as opt


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
            for k, v in batch.items()}


def trainer_leaves(model):
    """(view, named parameters, the leaf tensors, each leaf's stack depth)."""
    view = convert.leaf_view(model.cfg)
    named = dict(model.named_parameters())
    params = [convert.leaf_tensor(named, leaf) for leaf in view]
    stack = [model.cfg.n_layers if leaf.layer is not None else 0 for leaf in view]
    return view, named, params, stack


def init_state(model, ocfg: opt.AdamWConfig) -> opt.AdamWState:
    """AdamW state over the model's leaves (JAX's ``opt.init(params)``)."""
    return opt.init(trainer_leaves(model)[2], ocfg)


def make_train_step(model, ocfg: opt.AdamWConfig):
    """Returns train_step(opt_state, batch) -> (state, metrics), the model's
    parameters updated in place; metrics {"loss" (the mean cross-entropy
    over microbatches), "grad_norm", "lr"}.  ``batch`` leaves have a leading
    accumulation axis A.  Turns ``requires_grad`` on."""
    model.train_()
    view, named, params, stack = trainer_leaves(model)
    names = list(named)

    def train_step(opt_state, batch):
        batch = device_batch(batch, model.device)
        A = next(iter(batch.values())).shape[0]
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in named.items()}
        mean_loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for a in range(A):
            loss, metrics = model.loss({k: v[a] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, [named[n] for n in names], allow_unused=True)
            for n, g in zip(names, grads):
                if g is not None:
                    acc[n].add_(g.float() / A)
            mean_loss = mean_loss + metrics["ce"].detach() / A
            del loss, metrics, grads
        leaf_grads = [convert.leaf_grad(acc, leaf) for leaf in view]
        if not math.isfinite(float(mean_loss)):
            return opt_state, {"loss": mean_loss, "grad_norm": opt.global_norm(leaf_grads),
                               "lr": opt.lr_at(ocfg, opt_state.step + 1)}
        try:
            _, new_state, om = opt.update(leaf_grads, opt_state, params, ocfg, stack=stack)
            convert.sync_copies(named, view)
        except Exception as e:
            raise StepStateLost(f"step {int(opt_state.step)}: the update failed after it "
                                "began to write the parameters and moments in place; "
                                "restore the last checkpoint") from e
        return new_state, {"loss": mean_loss, **om}

    return train_step


def make_eval_step(model):
    """Returns eval_step(model, batch) -> the microbatch's mean cross-entropy."""

    @torch.no_grad()
    def eval_step(model_, batch):
        return model_.loss(device_batch(batch, model_.device))[1]["ce"]

    return eval_step


def checkpoint_state(model, opt_state: opt.AdamWState) -> dict:
    """The trainer's state as the checkpoint's tree, keyed by the trainer's
    leaf paths: {"params": {key: leaf}, "opt": {"step", "m": {key: m},
    "v": {key: v}}}, every leaf a live tensor (a view of the model's
    parameters for "params"), so that ``checkpoint.restore`` writes the
    model and the optimizer state in place."""
    view, _, params, _ = trainer_leaves(model)
    keys = [leaf.key for leaf in view]
    return {"params": dict(zip(keys, params)),
            "opt": {"step": opt_state.step, "m": dict(zip(keys, opt_state.m)),
                    "v": dict(zip(keys, opt_state.v))}}


def restore_latest(directory: str, model, opt_state: opt.AdamWState) -> int:
    """Restore the newest checkpoint under ``directory`` into the model and
    ``opt_state`` in place (the per-head norm copies written back equal).
    Returns its step, or -1 when there is none."""
    from repro_torch.training import checkpoint as ckpt

    _, step = ckpt.restore_latest(directory, checkpoint_state(model, opt_state))
    if step >= 0:
        convert.sync_copies(dict(model.named_parameters()), convert.leaf_view(model.cfg))
    return step
