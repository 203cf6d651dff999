#!/usr/bin/env python3
"""Time the bf16 attention kernels of ``chip_smoke.py`` phase 6, and their
SDPA yardsticks, and the bf16 WKV6 and SSD kernels, by three methods on one
card.

    python3 attention_timing.py [--src DIR] [--label NAME]

The rows are phase 6's: the mixed q-chunk step (B=8, Q=8, 8 kv heads,
G=2, D=128, a 2048-key window of a 4096-row cache, phase 6's cache
lengths), the same through block tables over phase 6's 3073-page pool,
the flash forward at B=1, S=2000, causal (16 q / 8 kv heads of 128,
and 32 / 32 heads of 80), and the split-K decode (one launch whose last
CTA per sequence and kv head merges the chunk states; in a tree before
that, the partial and combine pair) and its partial alone at K=8 over a
4096-row cache at phase 6's lengths (8 kv heads, G=2, D=128; 32 kv heads
of 80, G=1; and D=128 through the pool), each beside the one SDPA call
with its result; the WKV6
recurrence at phase 6's shape (rwkv6-7b's prefill: B=1, S=2000, 64 heads
of 64, bf16 r/k/v/u, fp32 logw, zero state) and at phase 4g's (B=8,
S=512); and the SSD scan at phase 6's shape (zamba2-2.7b's prefill: B=1,
S=2000, 80 heads of P=N=64, bf16 x/B/C, fp32 dt and A, zero state) and at
phase 4i's (B=8, S=512); no one PyTorch call computes either scan; and
the single-stage decode (one query per sequence, B=8, 8 kv heads, G=2,
D=128, a 1024-row cache at phase 6's single-stage lengths) in bf16 and
fp32, contiguous (beside SDPA in bf16) and through block tables over a
769-page pool of 16-token pages, and in fp32 at the recovery tier's
shape (qwen3-0.6b reduced as the JAX fleet serves it: 2 kv heads of 32,
G=2; B=3, a 205-page pool, 34-column tables: max_len 544, lengths
512-544); the split-K decode and its partial in fp32 at D=128; and the
fp32 mixed step at phase 6's shape (contiguous, beside SDPA, and through
the pool) and at the recovery tier's (Q=8 over the tier's pool, cache
lengths 512-536).  Each is timed by

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


def _table(lens_np, max_len: int = S_MAX, pages: int = 0) -> tuple:
    """Phase 6's pool size (or ``pages``) and (len(lens_np), nb) table:
    shuffled pages, rows 5 and 6 sharing row 4's first 768 tokens where
    there are such rows, the trash page (0) past each length."""
    b, nb = len(lens_np), max_len // PAGE
    P = pages or 1 + -(-3 * b * nb // 2)
    tbl = np.random.default_rng(PAGE).permutation(np.arange(1, P))[: b * nb].reshape(b, nb)
    if b > 6:
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
    # phase 6's draws, in its order: decode lengths, split-K lengths, cache
    # lengths, split-K lengths at head_dim 80
    rng = np.random.default_rng(2)
    single_np = rng.integers(16, 1024 + 1, B)
    lens_np = rng.integers(16, 2033, B)
    cl_np = rng.integers(0, W - Q + 1, B)
    lens80_np = rng.integers(16, 2033, B)
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")
    lens80 = torch.as_tensor(lens80_np, dtype=torch.int32, device="cuda")
    out = {"cache_lens": cl_np.tolist(), "lengths": lens_np.tolist(),
           "lengths_d80": lens80_np.tolist(), "single_stage_lengths": single_np.tolist()}

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

    # split-K decode at K=8 over the 4096-row cache, phase 6's lengths
    K = 8
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    for tag, hkv, g, d, ln in (("", HKV, G, D, lens), ("_d80", 32, 1, 80, lens80)):
        q = _rand(gen, (B, hkv * g, d))
        caches = [(_rand(gen, (B, S_MAX, hkv, d)), _rand(gen, (B, S_MAX, hkv, d)))
                  for _ in range(RING)]
        mask = (torch.arange(S_MAX, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
        out["splitk_partial" + tag] = _three_ways(
            [functools.partial(kernel.splitk_partial_cuda, q, k, v, ln, k_splits=K)
             for k, v in caches], 200)
        out["splitk" + tag] = _three_ways(
            [functools.partial(kernel.decode_attention_splitk_cuda, q, k, v, ln, k_splits=K)
             for k, v in caches], 200)
        out["splitk_sdpa" + tag] = _three_ways(
            [functools.partial(_sdpa, q[:, None], k, v, mask) for k, v in caches], 50)
        del caches
    q = _rand(gen, (B, HKV * G, D))
    pools = [(_rand(gen, (P, PAGE, HKV, D)), _rand(gen, (P, PAGE, HKV, D))) for _ in range(RING)]
    out["paged_splitk_partial"] = _three_ways(
        [functools.partial(kernel.paged_splitk_partial_cuda, q, kp, vp, tbl, lens, k_splits=K)
         for kp, vp in pools], 200)
    out["paged_splitk"] = _three_ways(
        [functools.partial(kernel.decode_attention_paged_splitk_cuda, q, kp, vp, tbl, lens,
                           k_splits=K) for kp, vp in pools], 200)
    del pools

    # WKV6 at rwkv6-7b's prefill (phase 6) and at generate's (phase 4g),
    # from a zero state as Model.prefill calls it; logw as the model makes
    # it, -exp of a log-decay near w0 = -2
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel

    for name, b, s in (("wkv6", 1, 2000), ("wkv6_b8", 8, 512)):
        h, n = 64, 64
        sets = [(_rand(gen, (b, s, h, n)), _rand(gen, (b, s, h, n)), _rand(gen, (b, s, h, n)),
                 -torch.exp(-2.0 + 0.5 * torch.randn((b, s, h, n), generator=gen,
                                                     device="cuda")),
                 (0.5 * torch.randn((h, n), generator=gen, device="cuda")).to(torch.bfloat16))
                for _ in range(RING)]
        out[name] = _three_ways(
            [functools.partial(wkv_kernel.wkv6_cuda, *args) for args in sets], 50)
        del sets

    # SSD at zamba2-2.7b's prefill (phase 6) and at generate's (phase 4i),
    # from a zero state; dt as the model makes it (softplus), A = -exp(0.3 z)
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    for name, b, s in (("ssd", 1, 2000), ("ssd_b8", 8, 512)):
        h, p, n = 80, 64, 64
        sets = [(_rand(gen, (b, s, h, p)),
                 torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen,
                                                          device="cuda")),
                 -torch.exp(0.3 * torch.randn((h,), generator=gen, device="cuda")),
                 _rand(gen, (b, s, n)), _rand(gen, (b, s, n)))
                for _ in range(RING)]
        out[name] = _three_ways(
            [functools.partial(ssd_kernel.ssd_cuda, *args) for args in sets], 50)
        del sets

    # the single-stage decode at phase 6's shape (a 1024-row cache, or 64
    # columns of 16 over a 769-page pool) in both dtypes, and at the
    # recovery tier's (B=3, 2 kv heads of 32, 34 columns over a 205-page
    # pool) in fp32
    out.update(_single_stage(gen, kernel, single_np))
    # the split-K decode and its partial alone in fp32 (flash_rows_kernel)
    # at phase 6's D=128 shape and lengths
    q = torch.randn((B, HKV * G, D), generator=gen, device="cuda")
    caches = [(torch.randn((B, S_MAX, HKV, D), generator=gen, device="cuda"),
               torch.randn((B, S_MAX, HKV, D), generator=gen, device="cuda"))
              for _ in range(RING)]
    out["splitk_partial_fp32"] = _three_ways(
        [functools.partial(kernel.splitk_partial_cuda, q, k, v, lens, k_splits=K)
         for k, v in caches], 100)
    out["splitk_fp32"] = _three_ways(
        [functools.partial(kernel.decode_attention_splitk_cuda, q, k, v, lens, k_splits=K)
         for k, v in caches], 100)
    del caches
    out.update(_mixed_fp32(gen, kernel, cl_np, lens_np))
    return out


def _mixed_fp32(gen, kernel, cl_np, lens_np) -> dict:
    """The fp32 mixed step at phase 6's shape (contiguous, beside SDPA, and
    through phase 6's pool) and at the recovery tier's (B=3, 2 kv heads of
    32, G=2, Q=8, a 205-page pool, 34-column tables, cache lengths
    512-536)."""
    out = {}
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")

    def rand32(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    qm = rand32((B, Q, HKV * G, D))
    caches = [(rand32((B, S_MAX, HKV, D))[:, :W], rand32((B, S_MAX, HKV, D))[:, :W])
              for _ in range(RING)]
    qpos = cl[:, None] + torch.arange(Q, device="cuda")[None, :]
    mmask = (torch.arange(W, device="cuda")[None, None, :] <= qpos[:, :, None])[:, None]
    out["mixed_fp32"] = _three_ways(
        [functools.partial(kernel.mixed_attention_cuda, qm, kw, vw, cl) for kw, vw in caches],
        100)
    out["mixed_fp32_sdpa"] = _three_ways(
        [functools.partial(_sdpa, qm, kw, vw, mmask) for kw, vw in caches], 50)
    del caches
    P, tbl = _table(lens_np)
    view = tbl[:, :W // PAGE]
    pools = [(rand32((P, PAGE, HKV, D)), rand32((P, PAGE, HKV, D))) for _ in range(RING)]
    out["mixed_paged_fp32"] = _three_ways(
        [functools.partial(kernel.mixed_attention_paged_cuda, qm, kp, vp, view, cl)
         for kp, vp in pools], 100)
    del pools
    Bt, St, Ht, Dt = 3, 544, 2, 32
    tcl_np = np.random.default_rng(25).integers(512, St - Q + 1, Bt)
    Pt = 1 + 2 * Bt * (St // PAGE)
    _, ttbl = _table(tcl_np + Q, St, Pt)
    tcl = torch.as_tensor(tcl_np, dtype=torch.int32, device="cuda")
    q = rand32((Bt, Q, Ht * G, Dt))
    pools = [(rand32((Pt, PAGE, Ht, Dt)), rand32((Pt, PAGE, Ht, Dt))) for _ in range(RING)]
    out["mixed_paged_tier_fp32"] = _three_ways(
        [functools.partial(kernel.mixed_attention_paged_cuda, q, kp, vp, ttbl, tcl)
         for kp, vp in pools], 200)
    out["tier_cache_lens"] = tcl_np.tolist()
    return out


def _single_stage(gen, kernel, lens_np) -> dict:
    out = {}
    S = 1024
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    _, tbl = _table(lens_np, S)
    P = 1 + -(-3 * B * (S // PAGE) // 2)
    for dt, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        def rand(shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q = rand((B, HKV * G, D))
        caches = [(rand((B, S, HKV, D)), rand((B, S, HKV, D))) for _ in range(RING)]
        out["decode" + tag] = _three_ways(
            [functools.partial(kernel.decode_attention_cuda, q, k, v, lens) for k, v in caches],
            200)
        if dt == torch.bfloat16:
            mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
            out["decode_sdpa"] = _three_ways(
                [functools.partial(_sdpa, q[:, None], k, v, mask) for k, v in caches], 50)
        del caches
        pools = [(rand((P, PAGE, HKV, D)), rand((P, PAGE, HKV, D))) for _ in range(RING)]
        out["decode_paged" + tag] = _three_ways(
            [functools.partial(kernel.decode_attention_paged_cuda, q, kp, vp, tbl, lens)
             for kp, vp in pools], 200)
        del pools
    Bt, St = 3, 544
    tier_np = np.random.default_rng(21).integers(512, St + 1, Bt)
    Pt = 1 + 2 * Bt * (St // PAGE)
    _, ttbl = _table(tier_np, St, Pt)
    tlens = torch.as_tensor(tier_np, dtype=torch.int32, device="cuda")
    Ht, Dt = 2, 32

    def rand32(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = rand32((Bt, Ht * G, Dt))
    pools = [(rand32((Pt, PAGE, Ht, Dt)), rand32((Pt, PAGE, Ht, Dt))) for _ in range(RING)]
    out["decode_paged_tier_fp32"] = _three_ways(
        [functools.partial(kernel.decode_attention_paged_cuda, q, kp, vp, ttbl, tlens)
         for kp, vp in pools], 200)
    out["tier_lengths"] = tier_np.tolist()
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
