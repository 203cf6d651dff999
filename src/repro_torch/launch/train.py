"""Training launcher of the port: the train loop with checkpoint/restart
and straggler tracking, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 200 --seq-len 256 --global-batch 16 --reduced --device cpu

The flags and the lines printed are the JAX launcher's (``step ... loss
... gnorm ... lr ... ms``, ``resumed from step N``, ``done``), plus
``--device`` (the card by default; a missing card raises).  ``--reduced``
runs ``cfg.reduce()`` (fp32, a few narrow layers).  The mesh flags
(``--data-parallel``, ``--model-parallel``) and ``--compress-grads`` need
the distributed runtime, which is not ported yet, and raise
``NotImplementedError``.  ``--simulate-failure-at`` exits 17 at that step
(simulated node loss; the next run resumes from the last checkpoint).

``run`` is the loop itself, for callers in process (``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-parallel", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.data_parallel or args.model_parallel or args.compress_grads:
        raise NotImplementedError(
            "--data-parallel, --model-parallel and --compress-grads need the mesh, sharding and "
            "gradient compression, which the port has not ported yet (ROADMAP item 16)")

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduce(), name=cfg.name)
    shape = InputShape("cli", "train", args.seq_len, args.global_batch)
    run(cfg, shape, steps=args.steps, accum=args.accum, lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, simulate_failure_at=args.simulate_failure_at,
        device=args.device)


def run(cfg, shape, *, steps: int, accum: int = 2, lr: float = 3e-4, ckpt_dir: str = "",
        ckpt_every: int = 50, simulate_failure_at: int = -1, device=None, log=print,
        on_step=None):
    """The train loop: the model from ``torch.Generator(...).manual_seed(0)``
    (as JAX's launcher inits from ``key(0)``), AdamW with the JAX
    launcher's schedule (warm-up ``steps // 20``, decay over ``steps``),
    ``batch_for_step`` data through the prefetch thread, each step under
    ``StepGuard`` (each skipped step logged) and timed for
    ``StragglerPolicy``, async checkpoints every ``ckpt_every`` steps and at
    the end.  ``on_step(i,
    metrics, seconds)`` sees every step.  Returns (model, opt_state)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.distributed.fault_tolerance import StepGuard, StragglerPolicy
    from repro_torch.models import Model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    from repro_torch.training.data import DataConfig, PrefetchIterator

    dev = resolve_device(device)
    gen = torch.Generator(dev.type).manual_seed(0)
    model = Model(cfg, device=dev).init_(gen)
    ocfg = opt.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1), decay_steps=steps)
    step_fn = ts.make_train_step(model, ocfg)
    state = ts.init_state(model, ocfg)

    start_step = 0
    checkpointer = None
    if ckpt_dir:
        checkpointer = ckpt.AsyncCheckpointer(ckpt_dir, keep=3)
        got = ts.restore_latest(ckpt_dir, model, state)
        if got >= 0:
            start_step = got
            log(f"resumed from step {got}")

    data = PrefetchIterator(cfg, shape, DataConfig(seed=0, accum_steps=accum),
                            start_step=start_step)
    guard = StepGuard()
    straggler = StragglerPolicy()
    try:
        for i in range(start_step, steps):
            step_idx, batch = next(data)
            assert step_idx == i
            if i == simulate_failure_at:
                raise SystemExit(17)  # simulated node loss (restart picks up)
            t0 = time.perf_counter()
            out = guard.run(step_fn, state, batch)
            if out is None:
                log(f"step {i:5d} skipped ({guard.skipped} so far): {guard.last_error!r}")
                continue
            state, metrics = out
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = straggler.observe(dt)
            if on_step is not None:
                on_step(i, metrics, dt)
            if i % 10 == 0 or i == steps - 1:
                log(f"step {i:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                    + (" [straggler]" if slow else ""))
            if checkpointer and (i + 1) % ckpt_every == 0:
                checkpointer.save(ts.checkpoint_state(model, state), i + 1)
        if checkpointer:
            checkpointer.save(ts.checkpoint_state(model, state), steps)
    finally:
        data.close()
        if checkpointer:
            # also after a simulated node loss: the writes already started
            # finish, so the resume point does not race the writer thread
            checkpointer.wait()
    log("done")
    return model, state


if __name__ == "__main__":
    main()
