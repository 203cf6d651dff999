#!/usr/bin/env python3
"""Time the bf16 attention kernels of ``chip_smoke.py`` phase 6, and their
SDPA yardsticks, by three methods on one card.

    python3 attention_timing.py [--src DIR] [--label NAME]

The rows are phase 6's: the mixed q-chunk step (B=8, Q=8, 8 kv heads,
G=2, D=128, a 2048-key window of a 4096-row cache, phase 6's cache
lengths), the same through block tables over phase 6's 3073-page pool,
and the flash forward at B=1, S=2000, causal (16 q / 8 kv heads of 128,
and 32 / 32 heads of 80).  Each is timed by

- ``back_to_back``: CUDA events around ``iters`` calls made one after the
  other, after a warm-up.  For a kernel shorter than its wrapper's host
  cost this reads the host's call rate, not the device;
- ``queued``: the same events, with the calls queued behind a sleep
  kernel long enough for the host to enqueue them all, so the device runs
  them back to back (phase 6's method, ``time_ms``);
- ``queued_cold``: ``queued`` over a ring of ``RING`` input sets that each
  call steps through, so the inputs of a call were last read
  ``RING - 1`` calls (more than the 50 MB L2 of an H100) earlier and come
  from device memory, as on the serving path, where every call reads
  another layer's cache.

``--src`` puts another checkout's ``src/`` first on the import path, so
one call can time two versions of the port by the same methods (the
wrapper names and signatures are the port's since these kernels came).
Prints the card's name and power limit, then one JSON line.  Needs a CUDA
card.  ``chip_smoke.py`` takes ``time_ms`` from here; SDPA is a yardstick
only, which is why this script lives outside the port's package.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, HKV, G, D = 8, 8, 2, 128          # phase 6's serving shape (qwen3-0.6b)
S_MAX, PAGE, Q, W = 4096, 16, 8, 2048
RING = 4                             # input sets per cold ring


@functools.cache
def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, iters: int, warm: int = 3) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls that
    wait in the stream behind a sleep kernel long enough for the host to
    enqueue them all, so a kernel shorter than its wrapper's host cost
    (checks, allocation and the ctypes call) is timed back to back on the
    device, not at the host's call rate."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3    # the call's host cost alone
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * (1.5 * iters * host_ms + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_back_to_back_ms(fn, iters: int, warm: int = 3) -> float:
    """CUDA events around ``iters`` calls issued one after the other: the
    device's time per call only where a call's kernel outlasts its host cost."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rand(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)


def _sdpa(q4, k, v, mask):
    """(B, Q, Hq, D) query vs (B, S, Hkv, D) cache through one SDPA call."""
    F = torch.nn.functional
    return F.scaled_dot_product_attention(q4.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=mask, enable_gqa=True)


def _table(lens_np) -> tuple:
    """Phase 6's pool size and (B, nb) table: shuffled pages, rows 5 and 6
    sharing row 4's first 768 tokens, the trash page (0) past each length."""
    nb = S_MAX // PAGE
    P = 1 + -(-3 * B * nb // 2)
    tbl = np.random.default_rng(PAGE).permutation(np.arange(1, P))[: B * nb].reshape(B, nb)
    tbl[5:7, : 768 // PAGE] = tbl[4, : 768 // PAGE]
    used = -(-np.asarray(lens_np) // PAGE)
    tbl[np.arange(nb)[None, :] >= used[:, None]] = 0
    return P, torch.as_tensor(tbl, dtype=torch.int32, device="cuda")


def _three_ways(calls, iters: int) -> dict:
    """``calls``: one zero-argument call per input set of the ring."""
    ring = itertools.cycle(calls)
    return dict(back_to_back=time_back_to_back_ms(calls[0], iters),
                queued=time_ms(calls[0], iters),
                queued_cold=time_ms(lambda: next(ring)(), iters))


def measure() -> dict:
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    gen = torch.Generator("cuda").manual_seed(2)
    # phase 6's draws, in its order: decode lengths, split-K lengths, cache lengths
    rng = np.random.default_rng(2)
    rng.integers(16, 1024 + 1, B)
    lens_np = rng.integers(16, 2033, B)
    cl_np = rng.integers(0, W - Q + 1, B)
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")
    out = {"cache_lens": cl_np.tolist()}

    qm = _rand(gen, (B, Q, HKV * G, D))
    caches = [(_rand(gen, (B, S_MAX, HKV, D))[:, :W], _rand(gen, (B, S_MAX, HKV, D))[:, :W])
              for _ in range(RING)]
    qpos = cl[:, None] + torch.arange(Q, device="cuda")[None, :]
    mmask = (torch.arange(W, device="cuda")[None, None, :] <= qpos[:, :, None])[:, None]
    out["mixed_attention"] = _three_ways(
        [functools.partial(kernel.mixed_attention_cuda, qm, kw, vw, cl) for kw, vw in caches], 200)
    out["mixed_attention_sdpa"] = _three_ways(
        [functools.partial(_sdpa, qm, kw, vw, mmask) for kw, vw in caches], 50)
    del caches

    P, tbl = _table(lens_np)
    view = tbl[:, :W // PAGE]
    pools = [(_rand(gen, (P, PAGE, HKV, D)), _rand(gen, (P, PAGE, HKV, D))) for _ in range(RING)]
    out["mixed_attention_paged"] = _three_ways(
        [functools.partial(kernel.mixed_attention_paged_cuda, qm, kp, vp, view, cl)
         for kp, vp in pools], 200)
    del pools

    S = 2000
    F = torch.nn.functional
    for name, hq, hk, d in (("flash_attention", HKV * G, HKV, D),
                            ("flash_attention_d80", 32, 32, 80)):
        sets = [(_rand(gen, (1, S, hq, d)), _rand(gen, (1, S, hk, d)), _rand(gen, (1, S, hk, d)))
                for _ in range(RING)]
        out[name] = _three_ways(
            [functools.partial(flash_kernel.flash_attention_cuda, q, k, v, causal=True)
             for q, k, v in sets], 50)
        out[name + "_sdpa"] = _three_ways(
            [functools.partial(F.scaled_dot_product_attention, q.transpose(1, 2),
                               k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                               enable_gqa=hq != hk) for q, k, v in sets], 50)
        del sets
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=Path(__file__).resolve().parent / "src",
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name for this run in the JSON line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_timing: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"label": args.label, "src": str(args.src), "ms": measure()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
