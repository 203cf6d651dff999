#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: serve qwen3-0.6b, rwkv6-7b and
zamba2-2.7b on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. card: name and power limit from nvidia-smi;
2. build: nvcc builds every kernel source of the path, one process per
   source, all at once (printing ptxas -v); the bf16 tensor-core attention
   kernels' registers, spills and static shared memory on a line of their
   own, and no instantiation may spill;
3. kernels: each CUDA kernel against its plain PyTorch version at the
   serving shapes, in bf16 (atol 2e-2, and each output row's largest error
   within a tenth of that row's RMS) and fp32 (atol 2e-5, rtol 1e-3); the
   paged kernels over the auto-sized pool (3073 pages of 16) with shuffled,
   shared and trash table entries, in fp32 at page sizes 8 and 64, and the
   single-stage paged decode and paged mixed step at phase 5b's fp32
   max_len 1024 (769 pages), and the paged mixed step at phase 4d's
   prefill_paged call (B=1, suffixes of 21 and 500 after a 1024-token
   prefix, one table row of batch stride 0) in bf16 and fp32; the
   flash-attention forward at the prefill
   shape (B=1, 16 q / 8 kv heads, D 128, causal) at S 16, 700 and 2000,
   and non-causal, windowed and Sk > Sq; the WKV6 recurrence against both
   plain versions (the per-token recurrence and the chunk form) at atol
   5e-4, rtol 1e-3, at rwkv6-7b's prefill shape (B=1, S=2000, 64 heads of
   64, from a zero state), phase 4g's (B=8, S=512), lengths 1-700 at head
   sizes 16, 32 and 64 from a random state, a slow decay over 2000 tokens
   and strided views; the SSD scan against both plain versions (the
   per-step recurrence and the chunk form) at atol 5e-4, rtol 1e-3, at
   zamba2-2.7b's prefill shape (B=1, S=2000, 80 heads of P=64, N=64, zero
   state), phase 4i's (B=8, S=512), lengths 1-700 from a random state, a
   slow decay (A about -1e-3) over 2000 tokens and strided views; the
   RMSNorm in both forms at the hybrid widths (2560, 5120) over 1, 8 and
   2000 rows (bf16 within one bf16 ulp, fp32 atol 2e-5); the decode,
   split-K and flash kernels at zamba2's head_dim 80 and G=1; poison
   checks, both dtypes: NaN in the cache past every length (phase 4's mixed
   step), in the trash page and every pool row a sequence does not hold
   (phase 4d's prefill_paged call), past Sq and Sk (the flash prefill at
   S=2000) leave the output finite and bit-equal to the clean run's;
4. serve: EngineClient serves full-width qwen3-0.6b (28 layers, bf16,
   seeded random weights) at the default EngineConfig: 16 requests,
   prompts 16..2000 tokens, 32 new tokens each; launch counters are
   zeroed just before and read just after;
4b. serve, paged: the same model at EngineConfig(paged_kv=True): 16
   requests of 32 new tokens -- two groups of 4 sharing a 1024-token
   system prompt, 4 cold prompts, and 4 exact repeats each submitted right
   after its original (full hits with copy-on-write); every page must be
   released after the drain;
4c. serve, legacy: phase 4's model and traffic at
   EngineConfig(mixed_step=False): one Model.prefill (28 flash-attention
   launches) per admission, then decode chunks;
4d. serve, legacy paged: phase 4b's traffic at
   EngineConfig(mixed_step=False, paged_kv=True): misses prefill, prefix
   hits run Model.prefill_paged, repeats hit with copy-on-write; every page
   released after the drain;
4e. generate: ServingEngine.generate at B=8, prompt 512, 32 steps;
4f. serve rwkv6-7b: EngineClient serves full-width rwkv6-7b (32 layers,
   d 4096, 64 heads of 64, d_ff 14336, vocab 65536, bf16, seeded random
   weights, 15.2 GB) at the default EngineConfig, which falls to legacy
   admission (no mixed step for the family): phase 4's traffic, one
   Model.prefill (32 WKV6 launches) per admission, then decode chunks; no
   attention kernel may launch;
4g. generate on rwkv6-7b: B=8, prompt 512, 32 steps (32 WKV6 launches);
4h. serve zamba2-2.7b: EngineClient serves full-width zamba2-2.7b (54
   Mamba-2 layers, d 2560, 80 SSM heads of 64, state 64, a shared
   attention block of 32 heads of 80 every 6 layers, d_ff 10240, vocab
   32000, bf16, seeded random weights, 4.84 GB) at the default
   EngineConfig (legacy admission, as rwkv6): phase 4's traffic; each
   admission is one Model.prefill (54 SSD and 9 flash launches), each
   decode step 9 split-K pairs at head_dim 80; every norm of the hybrid
   path through the RMSNorm kernel; no mixed, paged or WKV6 kernel may
   launch. The rwkv6 model is freed first;
4i. generate on zamba2-2.7b: B=8, prompt 512, 32 steps;
5. card vs CPU: the same kind of traffic at fp32 (full width, 4 layers,
   max_len 1024, prompts up to 900) on the card and on the CPU (plain
   versions); greedy streams must agree token for token, or each first
   divergence must be a near-tie, printed with its logit margin;
5b. card vs CPU, paged: the same check over paged_kv=True with
   shared-prefix traffic (single-stage paged decode: 64 pages of 16);
5c. legacy vs mixed on the card: phases 5 and 5b's traffic at fp32 through
   the legacy admission must give the card's mixed streams (or near-ties),
   and generate must agree on the card and the CPU (B=4);
5d. card vs CPU on rwkv6-7b: full width cut to 2 layers at fp32, 6
   requests (prompts 16..300, 8 new tokens) through a 2-slot session, so
   slots are reused; streams must agree (or near-ties), and on the card
   decode after prefill(300) must equal prefill(301) within 2e-4;
5e. card vs CPU on zamba2-2.7b: full width cut to 12 layers (two shared
   applications) at fp32, the same 6 requests through 2 slots and the same
   decode-after-prefill check;
6. timing: every kernel, its plain version and the one PyTorch call with
   the same result (scaled_dot_product_attention, used only as a
   yardstick; no one call reads a block table or computes the WKV6 or SSD
   recurrence; ``F.rms_norm`` for the plain RMSNorm) timed with CUDA
   events over calls queued behind a sleep kernel (device time, not the
   host's call rate), the attention kernels also at head_dim 80; bounds
   from the bytes and operations of the inputs timed.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from attention_timing import time_ms  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-3), torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
# An output element at length L is about sqrt(e / L) in size (0.026 at
# L=4096), so the flat bf16 atol alone would let a long-length fault pass;
# each output row's largest bf16 error is also held to this share of the
# row's RMS.  Where the kernel and the plain version round one p to
# different bf16 values, an output element moves by at most 2^-7 * p * |v|.
BF16_ROW_FRAC = 0.1
ROW_FRAC = {}              # check -> worst bf16 row error as a share of its RMS
NEAR_TIE = 1e-3            # logit margin below which an argmax flip is a near-tie

# main-path shapes of qwen3-0.6b at the default EngineConfig
B, HKV, G, D = 8, 8, 2, 128
S_MAX = 4096
PAGE = 16


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _kernel_modules() -> tuple:
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rmsnorm import kernel as norm_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    return kernel, flash_kernel, wkv_kernel, ssd_kernel, norm_kernel


def reset_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def read_launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def mma_build_report(logs: dict) -> list:
    """The tensor-core attention kernels' ptxas -v lines, per instantiation:
    registers, spill stores and loads, static shared memory (their K/V ring
    is dynamic shared memory, sized in each source's header note)."""
    import re

    rows, cur = [], None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '.*?\d+([a-z_]+_mma_kernel)ILi(\d+)E", line)
            if m:
                cur = dict(kernel=f"{m.group(1)}<{m.group(2)}>")
                rows.append(cur)
                continue
            if "Compiling entry" in line:
                cur = None
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _close(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    err = _err(got, want)
    tol = TOL[dtype]
    bad = ((got.float() - want.float()).abs() > tol["atol"] + tol["rtol"] * want.float().abs())
    check(not bool(bad.any()) and bool(torch.isfinite(got).all()),
          f"{name} {dtype}: max abs err {err:.3e} outside atol {tol['atol']} rtol {tol['rtol']}")
    if dtype == torch.bfloat16:
        diff = (got.float() - want.float()).abs().amax(-1)
        rms = want.float().pow(2).mean(-1).sqrt()
        worst = float((diff / rms.clamp(min=1e-6)).max())
        ROW_FRAC[name] = max(ROW_FRAC.get(name, 0.0), worst)
        check(bool((diff <= BF16_ROW_FRAC * rms + 1e-6).all()),
              f"{name} bf16: a row's max error is {worst:.3f} of its RMS (limit {BF16_ROW_FRAC})")
    return err


def phase_kernels() -> dict:
    """Every kernel vs its plain version; returns max abs err per kernel and
    dtype (the paged kernels' at the default page size)."""
    from repro_torch.kernels.decode_attention import kernel, ops, ref

    gen = torch.Generator("cuda").manual_seed(1)
    errs = {name: {} for name in kernel.LAUNCHES}
    lens_list = [1, 17, 511, 512, 2049, 4096, 1000, 3000]
    for dtype in (torch.bfloat16, torch.float32):
        k = _rand(gen, (B, S_MAX, HKV, D), dtype)
        v = _rand(gen, (B, S_MAX, HKV, D), dtype)
        q = _rand(gen, (B, HKV * G, D), dtype)
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")

        def note(name, err):
            errs[name][str(dtype)] = max(errs[name].get(str(dtype), 0.0), err)

        note("decode_attention", _close("decode_attention", kernel.decode_attention_cuda(
            q, k, v, lens), ref.decode_attention(q, k, v, lens), dtype))

        # split-K at K=8: lengths 1 and 17 leave chunks 1..7 wholly empty
        m, l, acc = kernel.splitk_partial_cuda(q, k, v, lens, k_splits=8)
        m_r, l_r, acc_r = ref.decode_attention_splitk_partial(q, k, v, lens, k_splits=8)
        empty = m_r <= -1e29
        check(bool(empty.any()), "split-K case has no empty chunk")
        check(bool((m[empty] <= -1e29).all() and (l[empty] == 0).all()
                   and (acc[empty] == 0).all()), "empty split chunk is not the identity state")
        check(_err(m[~empty], m_r[~empty]) < 1e-4, "split-K partial m differs")
        check(bool(torch.allclose(l, l_r, rtol=1e-3, atol=1e-4)), "split-K partial l differs")
        norm = lambda a, ll: a / ll.clamp(min=1e-30)[..., None]  # noqa: E731
        note("decode_attention_splitk_partial", _close(
            "splitk_partial (acc/l)", norm(acc, l), norm(acc_r, l_r), dtype))
        note("decode_attention_splitk_combine", _close(
            "splitk_combine", kernel.splitk_combine_cuda(m_r, l_r, acc_r, dtype),
            ref.splitk_combine(m_r, l_r, acc_r, dtype), dtype))
        _close("splitk pair", kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=8),
               ref.decode_attention(q, k, v, lens), dtype)

        for Q in (1, 8, 32):
            qm = _rand(gen, (B, Q, HKV * G, D), dtype)
            # a strided attention-window view, read in place
            W = 2048
            cl = torch.tensor([0, 1, 17, 511, 512, 1000, 1500, W - Q], dtype=torch.int32,
                              device="cuda")
            note("mixed_attention", _close(f"mixed Q={Q} window", kernel.mixed_attention_cuda(
                qm, k[:, :W], v[:, :W], cl), ref.mixed_attention(qm, k[:, :W], v[:, :W], cl),
                dtype))
            cl = torch.tensor([l_ - Q if l_ >= Q else 0 for l_ in lens_list], dtype=torch.int32,
                              device="cuda")
            note("mixed_attention", _close(f"mixed Q={Q}", kernel.mixed_attention_cuda(
                qm, k, v, cl), ref.mixed_attention(qm, k, v, cl), dtype))
        del k, v

    # paged kernels: the default page size in both dtypes, 8 and 64 in fp32
    for dtype, ps in ((torch.bfloat16, PAGE), (torch.float32, PAGE), (torch.float32, 8),
                      (torch.float32, 64)):
        def note(name, err):
            if ps == PAGE:
                errs[name][str(dtype)] = max(errs[name].get(str(dtype), 0.0), err)

        lens_np = np.array([1, 15, 16, 17, 1024, 999, 1001, S_MAX])
        kp, vp, tbl = paged_inputs(gen, lens_np, ps, dtype)
        lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
        q = _rand(gen, (B, HKV * G, D), dtype)
        tag = f"ps={ps}"
        note("decode_attention_paged", _close(
            f"decode_attention_paged {tag}", kernel.decode_attention_paged_cuda(
                q, kp, vp, tbl, lens), ref.decode_attention_paged(q, kp, vp, tbl, lens), dtype))

        K = ops.auto_paged_k_splits(tbl.shape[1], ps)
        check(K == 8, f"paged split at nb={tbl.shape[1]}, ps={ps} is {K}, not 8")
        m, l, acc = kernel.paged_splitk_partial_cuda(q, kp, vp, tbl, lens, k_splits=K)
        m_r, l_r, acc_r = ref.decode_attention_paged_splitk_partial(q, kp, vp, tbl, lens,
                                                                    k_splits=K)
        empty = m_r <= -1e29
        check(bool(empty.any()), "paged split-K case has no empty chunk")
        check(bool((m[empty] <= -1e29).all() and (l[empty] == 0).all()
                   and (acc[empty] == 0).all()),
              "empty paged split chunk is not the identity state")
        check(_err(m[~empty], m_r[~empty]) < 1e-4, f"paged split-K partial m differs ({tag})")
        check(bool(torch.allclose(l, l_r, rtol=1e-3, atol=1e-4)),
              f"paged split-K partial l differs ({tag})")
        norm = lambda a, ll: a / ll.clamp(min=1e-30)[..., None]  # noqa: E731
        note("decode_attention_paged_splitk_partial", _close(
            f"paged splitk_partial (acc/l) {tag}", norm(acc, l), norm(acc_r, l_r), dtype))
        _close(f"paged splitk pair {tag}", kernel.decode_attention_paged_splitk_cuda(
            q, kp, vp, tbl, lens, k_splits=K), ref.decode_attention_paged(q, kp, vp, tbl, lens),
            dtype)

        # Q=8 through the table cut to its first 2048 keys (a column slice)
        Q, W = 8, 2048
        cl_np = np.array([0, 1, 15, 16, 17, 999, 1500, W - Q])
        kp, vp, tbl = paged_inputs(gen, cl_np + Q, ps, dtype)
        cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")
        qm = _rand(gen, (B, Q, HKV * G, D), dtype)
        view = tbl[:, :W // ps]
        note("mixed_attention_paged", _close(
            f"mixed_attention_paged Q={Q} {tag}", kernel.mixed_attention_paged_cuda(
                qm, kp, vp, view, cl), ref.mixed_attention_paged(qm, kp, vp, view, cl), dtype))
        del kp, vp

    # the single-stage paged decode and the paged mixed step at their phase
    # 5b shape: fp32, max_len 1024 (64 columns of 16) over a 769-page pool
    dtype, S5 = torch.float32, 1024
    lens_np = np.array([1, 15, 16, 17, 512, 999, 1001, S5])
    kp, vp, tbl = paged_inputs(gen, lens_np, PAGE, dtype, S5)
    check(ops.auto_paged_k_splits(tbl.shape[1], PAGE) == 1,
          f"paged decode at nb={tbl.shape[1]} is split")
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    q = _rand(gen, (B, HKV * G, D), dtype)
    err = _close(f"decode_attention_paged max_len={S5}", kernel.decode_attention_paged_cuda(
        q, kp, vp, tbl, lens), ref.decode_attention_paged(q, kp, vp, tbl, lens), dtype)
    errs["decode_attention_paged"][str(dtype)] = max(
        errs["decode_attention_paged"][str(dtype)], err)
    Q, W = 8, 512
    cl = torch.as_tensor([0, 1, 15, 16, 17, 300, 495, W - Q], dtype=torch.int32, device="cuda")
    qm = _rand(gen, (B, Q, HKV * G, D), dtype)
    view = tbl[:, :W // PAGE]
    err = _close(f"mixed_attention_paged Q={Q} max_len={S5}", kernel.mixed_attention_paged_cuda(
        qm, kp, vp, view, cl), ref.mixed_attention_paged(qm, kp, vp, view, cl), dtype)
    errs["mixed_attention_paged"][str(dtype)] = max(
        errs["mixed_attention_paged"][str(dtype)], err)

    # Model.prefill_paged's call in phase 4d: B=1, a suffix of Q queries
    # after a 1024-token cached prefix, through one table row of batch
    # stride 0 over the auto-sized pool of max_len S_MAX
    start = 1024
    cl = torch.tensor([start], dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        for Q in (21, 500):
            kp, vp, tbl = paged_inputs(gen, np.full(B, start + Q), PAGE, dtype)
            row = tbl[0].as_strided((1, tbl.shape[1]), (0, 1))
            qm = _rand(gen, (1, Q, HKV * G, D), dtype)
            err = _close(f"mixed_attention_paged prefill_paged Q={Q} start={start} "
                         f"pool={kp.shape[0]}", kernel.mixed_attention_paged_cuda(
                             qm, kp, vp, row, cl), ref.mixed_attention_paged(qm, kp, vp, row, cl),
                         dtype)
            errs["mixed_attention_paged"][str(dtype)] = max(
                errs["mixed_attention_paged"][str(dtype)], err)
            del kp, vp
    errs["flash_attention"] = flash_kernel_checks(gen)
    # a generator of their own, so the checks after them see the same inputs as before
    done = poison_checks(torch.Generator("cuda").manual_seed(3))
    print(f"  poison checks passed: {json.dumps(done)}", flush=True)
    errs["wkv6"] = wkv6_kernel_checks(gen)
    for name, e in head_dim_80_checks(gen).items():
        for dt, err in e.items():
            errs[name][dt] = max(errs[name].get(dt, 0.0), err)
    errs["ssd"] = ssd_kernel_checks(gen)
    errs.update(rmsnorm_kernel_checks(gen))
    torch.cuda.synchronize()
    return errs


def flash_kernel_checks(gen) -> dict:
    """The flash-attention forward vs its plain version: the prefill shape
    (B=1, Hq 16, Hkv 8, D 128, causal) at S 16, 700 and 2000, then
    non-causal, windowed and right-aligned (Sk > Sq) cases."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref as flash_ref

    errs = {}
    cases = [(1, S, S, True, 0) for S in (16, 700, 2000)]
    cases += [(2, 256, 256, False, 0), (2, 300, 300, True, 96), (2, 256, 256, False, 96),
              (2, 100, 700, True, 0), (1, 37, 2000, True, 512)]
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, sk, causal, window in cases:
            q = _rand(gen, (b, sq, HKV * G, D), dtype)
            k, v = _rand(gen, (b, sk, HKV, D), dtype), _rand(gen, (b, sk, HKV, D), dtype)
            got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = flash_ref.flash_attention(q, k, v, causal=causal, window=window)
            err = _close(f"flash_attention B={b} Sq={sq} Sk={sk} causal={causal} "
                         f"window={window}", got, want, dtype)
            errs[str(dtype)] = max(errs.get(str(dtype), 0.0), err)
    return errs


SCAN_TOL = dict(atol=5e-4, rtol=1e-3)


def wkv_inputs(gen, B_, S, H, N, dtype, *, state=True, slow=False):
    """r, k, v in ``dtype``; logw fp32 as the model makes it (-exp of a
    log-decay near w0 = -2), or with ``slow`` near -5 (a state that keeps
    thousands of tokens); u in ``dtype``; state0 fp32 or None."""
    r, k, v = (_rand(gen, (B_, S, H, N), dtype) for _ in range(3))
    mu = -5.0 if slow else -2.0
    logw = -torch.exp(mu + 0.5 * _rand(gen, (B_, S, H, N), torch.float32))
    u = (0.5 * _rand(gen, (H, N), torch.float32)).to(dtype)
    s0 = _rand(gen, (B_, H, N, N), torch.float32) if state else None
    return r, k, v, logw, u, s0


def wkv6_kernel_checks(gen) -> dict:
    """The WKV6 kernel vs both plain versions (y and the final state):
    phase 4f's prefill call (B=1, S=2000, 64 heads of 64, zero state),
    phase 4g's (B=8, S=512), lengths 1-700 at N 16/32/64 from a random
    state, a slow decay over 2000 tokens, and strided views."""
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    errs = {}
    cases = [(1, 2000, 64, 64, False, False), (8, 512, 64, 64, False, False)]
    cases += [(2, S, 4, N, True, False) for S in (1, 17, 100, 700) for N in (16, 32, 64)]
    cases += [(2, 2000, 4, 64, True, True)]
    for dtype in (torch.bfloat16, torch.float32):
        def run(name, r, k, v, logw, u, s0):
            y, st = wkv_kernel.wkv6_cuda(r, k, v, logw, u, s0)
            zeros = torch.zeros((r.shape[0], *st.shape[1:]), device="cuda")
            for plain in (wkv_ref.wkv6_ref, wkv_ref.wkv6_chunked):
                y_p, st_p = plain(r, k, v, logw, u, zeros if s0 is None else s0)
                for what, got, want in (("y", y, y_p), ("state", st, st_p)):
                    err = _err(got, want)
                    bad = (got - want).abs() > SCAN_TOL["atol"] + SCAN_TOL["rtol"] * want.abs()
                    check(not bool(bad.any()) and bool(torch.isfinite(got).all()),
                          f"wkv6 {name} {dtype} {what} vs {plain.__name__}: max abs err "
                          f"{err:.3e} outside atol 5e-4 rtol 1e-3")
                    errs[str(dtype)] = max(errs.get(str(dtype), 0.0), err)

        for B_, S, H, N, state, slow in cases:
            run(f"B={B_} S={S} H={H} N={N} state={state} slow={slow}",
                *wkv_inputs(gen, B_, S, H, N, dtype, state=state, slow=slow))
        # slices of a wider buffer, read in place
        fused = _rand(gen, (2, 333, 3, 4, 64), dtype)
        *_, logw, u, s0 = wkv_inputs(gen, 2, 666, 4, 64, dtype)
        run("strided views", fused[:, :, 0], fused[:, :, 1], fused[:, :, 2], logw[:, ::2], u, s0)
    return errs


# zamba2-2.7b's shared attention: 32 q and 32 kv heads of 80 (G=1)
Z_H, Z_D = 32, 80


def head_dim_80_checks(gen) -> dict:
    """The attention kernels at zamba2's head_dim 80, G=1: the single-stage
    decode at phase 5e's max_len 512, the split-K pair at the default
    max_len 4096 (K=8) over 8 slots, and the flash forward at the prefill
    shape (B=1, causal, q/k/v slices of one fused projection) at S 16, 700
    and 2000."""
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref as flash_ref

    errs = {name: {} for name in ("decode_attention", "decode_attention_splitk_partial",
                                  "decode_attention_splitk_combine", "flash_attention")}

    def note(name, dtype, err):
        errs[name][str(dtype)] = max(errs[name].get(str(dtype), 0.0), err)

    for dtype in (torch.bfloat16, torch.float32):
        k, v = _rand(gen, (2, 512, Z_H, Z_D), dtype), _rand(gen, (2, 512, Z_H, Z_D), dtype)
        q = _rand(gen, (2, Z_H, Z_D), dtype)
        lens = torch.tensor([300, 512], dtype=torch.int32, device="cuda")
        note("decode_attention", dtype, _close("decode_attention D=80", kernel.decode_attention_cuda(
            q, k, v, lens), ref.decode_attention(q, k, v, lens), dtype))
        K = ops.auto_k_splits(S_MAX)
        k, v = _rand(gen, (B, S_MAX, Z_H, Z_D), dtype), _rand(gen, (B, S_MAX, Z_H, Z_D), dtype)
        q = _rand(gen, (B, Z_H, Z_D), dtype)
        lens = torch.tensor([1, 17, 511, 512, 2049, 4096, 1000, 3000], dtype=torch.int32,
                            device="cuda")
        m, l, acc = kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K)
        m_r, l_r, acc_r = ref.decode_attention_splitk_partial(q, k, v, lens, k_splits=K)
        empty = m_r <= -1e29
        check(bool((m[empty] <= -1e29).all() and (l[empty] == 0).all()
                   and (acc[empty] == 0).all()), "D=80: empty split chunk is not the identity")
        check(_err(m[~empty], m_r[~empty]) < 1e-4, "D=80 split-K partial m differs")
        check(bool(torch.allclose(l, l_r, rtol=1e-3, atol=1e-4)), "D=80 split-K partial l differs")
        norm = lambda a, ll: a / ll.clamp(min=1e-30)[..., None]  # noqa: E731
        note("decode_attention_splitk_partial", dtype, _close(
            "splitk_partial D=80 (acc/l)", norm(acc, l), norm(acc_r, l_r), dtype))
        note("decode_attention_splitk_combine", dtype, _close(
            "splitk_combine D=80", kernel.splitk_combine_cuda(m_r, l_r, acc_r, dtype),
            ref.splitk_combine(m_r, l_r, acc_r, dtype), dtype))
        _close("splitk pair D=80", kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K),
               ref.decode_attention(q, k, v, lens), dtype)
        del k, v
        for S in (16, 700, 2000):
            fused = _rand(gen, (1, S, 3 * Z_H, Z_D), dtype)
            q, k, v = fused[:, :, :Z_H], fused[:, :, Z_H:2 * Z_H], fused[:, :, 2 * Z_H:]
            note("flash_attention", dtype, _close(
                f"flash_attention D=80 S={S}", flash_kernel.flash_attention_cuda(q, k, v),
                flash_ref.flash_attention(q.contiguous(), k.contiguous(), v.contiguous()), dtype))
    return errs


def ssd_inputs(gen, B_, S, H, P, N, dtype, *, state=True, slow=False):
    """x, B, C in ``dtype``; dt = softplus(N(0, 1)) fp32, as the model makes
    it from its projection; A = -exp(0.3 N(0, 1)), or with ``slow`` -1e-3
    times that (a state that keeps thousands of tokens) and x scaled by
    1/16, so y keeps the scale the scan tolerance is set for (at unit x the
    two plain versions alone differ by up to 2.9e-3 over 2000 steps);
    state0 fp32 or None."""
    x = (_rand(gen, (B_, S, H, P), torch.float32) / (16.0 if slow else 1.0)).to(dtype)
    dt = torch.nn.functional.softplus(_rand(gen, (B_, S, H), torch.float32))
    A = -(1e-3 if slow else 1.0) * torch.exp(0.3 * _rand(gen, (H,), torch.float32))
    Bm, Cm = _rand(gen, (B_, S, N), dtype), _rand(gen, (B_, S, N), dtype)
    s0 = _rand(gen, (B_, H, P, N), torch.float32) if state else None
    return x, dt, A, Bm, Cm, s0


def ssd_kernel_checks(gen) -> dict:
    """The SSD kernel vs both plain versions (y and the final state):
    phase 4h's prefill call (B=1, S=2000, 80 heads of 64, N=64, zero
    state), phase 4i's (B=8, S=512), lengths 1-700 at N 16 and 64 from a
    random state, a slow decay over 2000 tokens, and strided views (x, B, C
    slices of one conv output, as mamba2_layer passes them)."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    errs = {}
    cases = [(1, 2000, 80, 64, 64, False, False), (8, 512, 80, 64, 64, False, False)]
    cases += [(2, S, 4, 64, N, True, False) for S in (1, 17, 100, 700) for N in (16, 64)]
    cases += [(2, 2000, 4, 64, 64, True, True)]
    for dtype in (torch.bfloat16, torch.float32):
        def run(name, x, dt, A, Bm, Cm, s0):
            y, st = ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, s0)
            zeros = torch.zeros_like(st)
            for plain in (ssd_ref.ssd_ref, ssd_ref.ssd_chunked):
                y_p, st_p = plain(x, dt, A, Bm, Cm, zeros if s0 is None else s0)
                for what, got, want in (("y", y, y_p), ("state", st, st_p)):
                    err = _err(got, want)
                    bad = (got - want).abs() > SCAN_TOL["atol"] + SCAN_TOL["rtol"] * want.abs()
                    check(not bool(bad.any()) and bool(torch.isfinite(got).all()),
                          f"ssd {name} {dtype} {what} vs {plain.__name__}: max abs err "
                          f"{err:.3e} outside atol 5e-4 rtol 1e-3")
                    errs[str(dtype)] = max(errs.get(str(dtype), 0.0), err)

        for B_, S, H, P, N, state, slow in cases:
            run(f"B={B_} S={S} H={H} P={P} N={N} state={state} slow={slow}",
                *ssd_inputs(gen, B_, S, H, P, N, dtype, state=state, slow=slow))
        H, P, N = 4, 64, 64
        conv = _rand(gen, (2, 333, H * P + 2 * N), dtype)
        _, dt, A, _, _, s0 = ssd_inputs(gen, 2, 666, H, P, N, dtype)
        run("strided views", conv[..., :H * P].reshape(2, 333, H, P), dt[:, ::2], A,
            conv[..., H * P:H * P + N], conv[..., H * P + N:], s0)
    return errs


def rmsnorm_kernel_checks(gen) -> dict:
    """The RMSNorm kernel in both forms vs its plain version at the hybrid
    widths (d_model 2560, d_inner 5120) over 1, 8 and 2000 rows: bf16
    outputs within one bf16 ulp (rtol 2^-7; the two round the same fp32
    value), fp32 at atol 2e-5 / rtol 1e-3, the fused form's sum bit for bit."""
    from repro_torch.kernels.rmsnorm import kernel as norm_kernel
    from repro_torch.kernels.rmsnorm import ref as norm_ref

    errs = {"rmsnorm": {}, "rmsnorm_fused": {}}
    for dtype in (torch.bfloat16, torch.float32):
        tol = dict(atol=1e-5, rtol=2 ** -7) if dtype == torch.bfloat16 else TOL[dtype]
        for d in (2560, 5120):
            w = _rand(gen, (d,), dtype)
            for M in (1, 8, 2000):
                x = (3.0 * _rand(gen, (M, d), torch.float32)).to(dtype)
                for name, r in (("rmsnorm", None), ("rmsnorm_fused", _rand(gen, (M, d), dtype))):
                    out, summed = norm_kernel.rmsnorm_cuda(x, w, r)
                    want, want_sum = norm_ref.rmsnorm_ref(x, w, r)
                    err = _err(out, want)
                    bad = (out.float() - want.float()).abs() > (
                        tol["atol"] + tol["rtol"] * want.float().abs())
                    check(not bool(bad.any()) and bool(torch.isfinite(out).all()),
                          f"{name} M={M} d={d} {dtype}: max abs err {err:.3e} outside "
                          f"atol {tol['atol']} rtol {tol['rtol']}")
                    check(bool(torch.equal(summed, want_sum)), f"{name} M={M} d={d}: sum differs")
                    errs[name][str(dtype)] = max(errs[name].get(str(dtype), 0.0), err)
    return errs


def _nan_rows(t: torch.Tensor, dead: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with NaN in the rows ``dead`` of its first two axes, flattened."""
    out = t.clone()
    out.view(-1, *t.shape[2:])[dead] = float("nan")
    return out


def poison_checks(gen) -> list:
    """Each attention kernel of the tensor-core redesign, in both dtypes, at
    its main-path shape with NaN wherever the kernel must not look: the
    contiguous cache past every cache_len + Q (phase 4's mixed step, read
    through the 2048-key window view), every pool row that is not the
    sequence's own below its length, the trash page included (phase 4d's
    prefill_paged call), and the rows past Sq and Sk of the buffers q, k
    and v are cut from (the flash prefill at B=1, S=2000).  The output must
    be finite and equal to the clean run's, bit for bit."""
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    done = []

    def same(name, got, want):
        check(bool(torch.isfinite(got).all()), f"poison {name}: non-finite output")
        check(bool(torch.equal(got, want)), f"poison {name}: output differs from the clean run "
                                            f"by {_err(got, want):.3e}")
        done.append(name)

    for dtype in (torch.bfloat16, torch.float32):
        Q, W = 8, 2048
        k, v = _rand(gen, (B, S_MAX, HKV, D), dtype), _rand(gen, (B, S_MAX, HKV, D), dtype)
        qm = _rand(gen, (B, Q, HKV * G, D), dtype)
        cl = torch.tensor([0, 1, 17, 511, 512, 1000, 1500, W - Q], dtype=torch.int32,
                          device="cuda")
        dead = (torch.arange(S_MAX, device="cuda")[None, :] >= (cl[:, None] + Q)).reshape(-1)
        kn, vn = _nan_rows(k, dead), _nan_rows(v, dead)
        same(f"mixed_attention B={B} Q={Q} window={W} {dtype}",
             kernel.mixed_attention_cuda(qm, kn[:, :W], vn[:, :W], cl),
             kernel.mixed_attention_cuda(qm, k[:, :W], v[:, :W], cl))
        del k, v, kn, vn

        start = 1024
        for Q in (21, 500):
            kp, vp, tbl = paged_inputs(gen, np.full(B, start + Q), PAGE, dtype)
            row = tbl[0].as_strided((1, tbl.shape[1]), (0, 1))
            pos = torch.arange(start + Q, device="cuda")
            live = torch.zeros(kp.shape[0] * PAGE, dtype=torch.bool, device="cuda")
            live[row[0, pos // PAGE].long() * PAGE + pos % PAGE] = True
            check(not bool(live[:PAGE].any()), "poison: the trash page holds live keys")
            kn, vn = _nan_rows(kp, ~live), _nan_rows(vp, ~live)
            qm = _rand(gen, (1, Q, HKV * G, D), dtype)
            cl = torch.tensor([start], dtype=torch.int32, device="cuda")
            same(f"mixed_attention_paged prefill_paged Q={Q} start={start} {dtype}",
                 kernel.mixed_attention_paged_cuda(qm, kn, vn, row, cl),
                 kernel.mixed_attention_paged_cuda(qm, kp, vp, row, cl))
            del kp, vp, kn, vn

        S, extra = 2000, 64
        q = _rand(gen, (1, S + extra, HKV * G, D), dtype)
        k, v = (_rand(gen, (1, S + extra, HKV, D), dtype) for _ in range(2))
        clean = flash_kernel.flash_attention_cuda(q[:, :S].contiguous(), k[:, :S].contiguous(),
                                                  v[:, :S].contiguous(), causal=True)
        for t in (q, k, v):
            t[:, S:] = float("nan")
        same(f"flash_attention B=1 S={S} {dtype}",
             flash_kernel.flash_attention_cuda(q[:, :S], k[:, :S], v[:, :S], causal=True), clean)
        del q, k, v
    return done


def paged_inputs(gen, lens_np, ps, dtype, max_len=S_MAX):
    """The auto-sized pool of an engine at ``max_len`` (1 + ceil(1.5·B·nb)
    pages) and (B, nb) tables over it: shuffled pages, rows 5 and 6 sharing
    row 4's first 768 tokens of pages (prefix reuse), TRASH_PAGE (0) past
    each length."""
    nb = max_len // ps
    P = 1 + math.ceil(1.5 * B * nb)
    kp = _rand(gen, (P, ps, HKV, D), dtype)
    vp = _rand(gen, (P, ps, HKV, D), dtype)
    rng = np.random.default_rng(ps)
    tbl = rng.permutation(np.arange(1, P))[: B * nb].reshape(B, nb)
    tbl[5:7, : 768 // ps] = tbl[4, : 768 // ps]
    used = -(-np.asarray(lens_np) // ps)
    tbl[np.arange(nb)[None, :] >= used[:, None]] = 0
    return kp, vp, torch.as_tensor(tbl, dtype=torch.int32, device="cuda")


# --------------------------------------------------------------------------
# phases 4-5: serving through EngineClient
# --------------------------------------------------------------------------


def make_engine_class():
    from repro_torch.serving import ServingEngine

    class CheckedEngine(ServingEngine):
        """Counts non-finite logits on the device, with no host sync."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)

        def _sample(self, logits, generator=None):
            self.nonfinite += (~torch.isfinite(logits)).sum()
            return super()._sample(logits, generator)

    return CheckedEngine


def serve(model, ecfg, prompts, max_new, device):
    """Serve ``prompts`` through EngineClient; returns (handles, wall_s, engine)."""
    from repro_torch.serving import EngineClient, InferenceRequest

    engine = make_engine_class()(model, ecfg, device=device)
    client = EngineClient(engine, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [client.submit(InferenceRequest(prompt=p, max_new=max_new)) for p in prompts]
    client.drain()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, engine


def check_handles(handles, engine, max_new, vocab, label):
    from repro_torch.serving import RequestStatus

    for h in handles:
        toks = h.result()
        check(h.status is RequestStatus.COMPLETED, f"{label}: request {h.rid} {h.status}")
        check(len(toks) == max_new, f"{label}: request {h.rid} got {len(toks)} tokens")
        check(bool(((toks >= 0) & (toks < vocab)).all()), f"{label}: out-of-vocab token")
    check(int(engine.nonfinite) == 0, f"{label}: {int(engine.nonfinite)} non-finite logits")


def prompts_for(rng, n, lo, hi, vocab):
    return [rng.integers(0, vocab, int(L)) for L in np.linspace(lo, hi, n).round()]


def shared_prefix_prompts(rng, vocab, sys_len, suffixes, cold, repeat):
    """Two groups sharing a ``sys_len``-token system prompt each (distinct
    suffixes of the lengths in ``suffixes``), then ``cold`` prompts; the
    prompts whose index is in ``repeat`` are followed at once by an exact
    repeat (a full-prompt hit while the original still decodes)."""
    base = []
    for g in range(2):
        system = rng.integers(0, vocab, sys_len)
        base += [np.concatenate([system, rng.integers(0, vocab, n)]) for n in suffixes[g]]
    base += [rng.integers(0, vocab, n) for n in cold]
    prompts = []
    for i, p in enumerate(base):
        prompts.append(p)
        if i in repeat:
            prompts.append(p.copy())
    return prompts


def free_memory() -> None:
    """Return the caches of finished runs to the card (handles and their
    client form reference cycles, so they go with gc)."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(name_line: str, model, *, paged: bool, legacy: bool = False) -> dict:
    """Phase 4 (contiguous) or 4b (paged) over the full-width model, or
    with ``legacy`` 4c / 4d through the legacy (mixed_step=False) admission."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    dev = model.device
    ecfg = EngineConfig(paged_kv=paged, mixed_step=not legacy)
    label = ("serve legacy" if legacy else "serve") + (" paged" if paged else "")
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator) outside the counted run
    serve(model, ecfg, prompts_for(rng, 2, 16, 64, cfg.vocab_size), 4, dev)
    free_memory()

    if paged:
        # suffix and cold lengths make every repeated prompt end mid-page
        # (1045, 1047, 677, 1339 tokens), so its full hit copies a page
        prompts = shared_prefix_prompts(
            rng, cfg.vocab_size, 1024, ([21, 177, 339, 500], [23, 180, 340, 497]),
            [16, 677, 1339, 2000], repeat={0, 4, 9, 10})
        check(len(prompts) == 16, f"paged traffic has {len(prompts)} requests")
    else:
        prompts = prompts_for(rng, 16, 16, 2000, cfg.vocab_size)
    max_new = 32
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    handles, wall, engine = serve(model, ecfg, prompts, max_new, dev)
    launches = read_launches()
    check_handles(handles, engine, max_new, cfg.vocab_size, label)
    tel = engine.telemetry
    if paged:
        path = ("mixed_attention_paged", "decode_attention_paged_splitk_partial",
                "decode_attention_splitk_combine")
        for k_ in ("decode_attention", "decode_attention_splitk_partial", "mixed_attention"):
            check(launches[k_] == 0, f"{label}: contiguous kernel {k_} launched")
    else:
        path = ("decode_attention_splitk_partial", "decode_attention_splitk_combine")
        path += () if legacy else ("mixed_attention",)
    if legacy:
        # one Model.prefill (a flash launch per layer) per prefill dispatch;
        # a paged prefix hit's prefill_paged runs the paged q-chunk kernel
        path += ("flash_attention",)
        st = handles[0]._client.session.allocator.stats if paged else None
        full = tel.prefills - (st.prefix_hits if paged else 0)
        check(launches["flash_attention"] == cfg.n_layers * full,
              f"{label}: {launches['flash_attention']} flash launches for {full} full "
              f"prefills of {cfg.n_layers} layers")
        check(launches["mixed_attention"] == 0, f"{label}: mixed kernel launched")
        if paged:
            check(launches["mixed_attention_paged"] == cfg.n_layers * st.prefix_hits,
                  f"{label}: {launches['mixed_attention_paged']} paged q-chunk launches for "
                  f"{st.prefix_hits} prefix hits")
    else:
        check(launches["flash_attention"] == 0, f"{label}: flash kernel launched")
    for k_ in path:
        check(launches[k_] > 0, f"{label}: kernel {k_} never launched on the main path")
    ttft = np.array([h.record.ttft_s for h in handles])
    out = dict(
        requests=len(handles), layers=cfg.n_layers, dtype=cfg.dtype, max_new=max_new,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        generated_tokens=int(sum(len(h.result()) for h in handles)),
        wall_s=wall, tokens_per_s=sum(len(h.result()) for h in handles) / wall,
        ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p99_s=float(np.percentile(ttft, 99)),
        mixed_steps=tel.mixed_steps, decode_chunks=tel.chunks, prefills=tel.prefills,
        launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        card=name_line,
    )
    if legacy and not paged:
        # the prefills alone, each timed to its end: their share of the wall
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            model.prefill(torch.as_tensor(p[None], device=dev))
        torch.cuda.synchronize()
        alone = time.perf_counter() - t0
        out.update(prefill_alone_s=alone, prefill_share_of_wall=alone / wall)
    if paged:
        session = handles[0]._client.session
        al = session.allocator
        st = al.stats
        check(st.full_hits >= 1 and st.prefix_hits >= 1 and st.cow_copies >= 1,
              f"{label}: full_hits {st.full_hits}, prefix_hits {st.prefix_hits}, "
              f"cow_copies {st.cow_copies}: each must be >= 1")
        check(al.live_pages == 0, f"{label}: {al.live_pages} pages still live after the drain")
        out.update(num_pages=engine.num_pages, page_size=ecfg.page_size,
                   pool_gb=2 * session.cache.k.numel() * session.cache.k.element_size() / 1e9,
                   full_hits=st.full_hits, prefix_hits=st.prefix_hits, misses=st.misses,
                   cow_copies=st.cow_copies, evictions=st.evictions,
                   reused_tokens=st.reused_tokens, prefilled_tokens=st.prefilled_tokens,
                   cache_hit_rate=tel.cache_hit_rate, live_pages=al.live_pages,
                   cached_pages=al.cached_pages)
    return out


def phase_generate(name_line: str, model) -> dict:
    """Phase 4e: ServingEngine.generate at B=8, prompt 512, 32 steps."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    B_, plen, steps = 8, 512, 32
    engine = make_engine_class()(model, EngineConfig(), device=model.device)
    rng = np.random.default_rng(4)
    engine.generate({"inputs": rng.integers(0, cfg.vocab_size, (2, 16))}, 2, 16)   # warm-up
    toks = rng.integers(0, cfg.vocab_size, (B_, plen))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = engine.generate({"inputs": toks}, steps, plen)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(out.shape == (B_, steps), f"generate: shape {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "generate: out-of-vocab token")
    check(int(engine.nonfinite) == 0, f"generate: {int(engine.nonfinite)} non-finite logits")
    check(launches["flash_attention"] == cfg.n_layers,
          f"generate: {launches['flash_attention']} flash launches, not {cfg.n_layers}")
    for k_ in ("decode_attention_splitk_partial", "decode_attention_splitk_combine"):
        check(launches[k_] == cfg.n_layers * steps, f"generate: {k_} {launches[k_]} launches")
    return dict(batch=B_, prompt_len=plen, steps=steps, layers=cfg.n_layers, dtype=cfg.dtype,
                wall_s=wall, tokens_per_s=B_ * steps / wall, launches=launches, card=name_line)


def _margin(model, tokens, a: int, b: int) -> float:
    """|logit(a) - logit(b)| after ``tokens`` (one B=1 mixed step, or a B=1
    prefill for a model without a mixed step)."""
    t = torch.as_tensor(np.asarray(tokens)[None], device=model.device)
    if model.supports_mixed_step:
        cache = model.empty_cache(1, len(tokens) + 1)
        logits = model.step_mixed(t, cache, np.array([0]), np.array([len(tokens)]))[0]
    else:
        logits = model.prefill(t)[0][0]
    return float((logits[a] - logits[b]).abs())


def phase_card_vs_cpu(cpu_model, card_model, *, paged: bool) -> tuple:
    """Phase 5 (contiguous) or 5b (paged): fp32 card streams vs the CPU's.
    Returns the summary, the prompts and the card's streams."""
    from repro_torch.serving import EngineConfig

    cfg = cpu_model.cfg
    ecfg = EngineConfig(max_len=1024, paged_kv=paged)
    label = "card-vs-cpu paged" if paged else "card-vs-cpu"
    rng = np.random.default_rng(1)
    if paged:
        # 64 pages of 16 per slot: 1024 logical keys, so decode is single-stage
        prompts = shared_prefix_prompts(rng, cfg.vocab_size, 256, ([5, 60, 150], [7, 90, 200]),
                                        [16, 333, 700], repeat={0, 3, 7})
    else:
        prompts = prompts_for(rng, 16, 16, 900, cfg.vocab_size)
    max_new = 32
    reset_launches()
    card_h, card_wall, card_eng = serve(card_model, ecfg, prompts, max_new, torch.device("cuda"))
    launches = read_launches()
    for k_ in (("decode_attention_paged", "mixed_attention_paged") if paged
               else ("decode_attention", "mixed_attention")):
        check(launches[k_] > 0, f"{label}: kernel {k_} never launched")
    cpu_h, cpu_wall, cpu_eng = serve(cpu_model, ecfg, prompts, max_new, torch.device("cpu"))
    check_handles(card_h, card_eng, max_new, cfg.vocab_size, f"{label} card fp32")
    check_handles(cpu_h, cpu_eng, max_new, cfg.vocab_size, f"{label} cpu fp32")
    exact, ties = compare_streams(prompts, [h.result() for h in card_h],
                                  [h.result() for h in cpu_h], card_model, cpu_model,
                                  ("card", "cpu"))
    out = dict(requests=len(prompts), exact_streams=exact, near_ties=ties, layers=cfg.n_layers,
               dtype=cfg.dtype, max_len=ecfg.max_len, launches=launches,
               card_wall_s=card_wall, cpu_wall_s=cpu_wall)
    if paged:
        sts = [h[0]._client.session.allocator.stats for h in (card_h, cpu_h)]
        check(sts[0] == sts[1], f"{label}: card and cpu prefix stats differ: {sts}")
        check(sts[0].full_hits >= 1 and sts[0].prefix_hits >= 1,
              f"{label}: no full or prefix hit: {sts[0]}")
        out.update(full_hits=sts[0].full_hits, prefix_hits=sts[0].prefix_hits,
                   cow_copies=sts[0].cow_copies)
    return out, prompts, [h.result() for h in card_h]


def compare_streams(prompts, streams_a, streams_b, model_a, model_b, names) -> tuple:
    """Count streams equal token for token; every first divergence must be
    a near-tie under ``model_b`` (printed with both models' margins)."""
    exact, ties = 0, []
    for rid, (p, a, b) in enumerate(zip(prompts, streams_a, streams_b)):
        if np.array_equal(a, b):
            exact += 1
            continue
        j = int(np.nonzero(a != b)[0][0])
        ctx = list(p) + list(b[:j])
        m_a = _margin(model_a, ctx, int(a[j]), int(b[j]))
        m_b = _margin(model_b, ctx, int(a[j]), int(b[j]))
        ties.append({"rid": rid, "position": j, f"{names[0]}_token": int(a[j]),
                     f"{names[1]}_token": int(b[j]), f"margin_{names[0]}": m_a,
                     f"margin_{names[1]}": m_b})
        print(f"  stream {rid} diverges at generated token {j}: {names[0]} {a[j]} vs "
              f"{names[1]} {b[j]}, logit margin {m_a:.3e} ({names[0]}) / {m_b:.3e} ({names[1]})")
        check(m_b < NEAR_TIE, f"stream {rid} diverges at a margin of {m_b:.3e} "
                              f">= {NEAR_TIE}: not a near-tie")
    return exact, ties


def phase_legacy_vs_mixed(cpu_model, card_model, streams) -> dict:
    """Phase 5c: phases 5 and 5b's traffic through the legacy admission on
    the card must give the card's mixed streams (``streams[paged]`` is
    (prompts, card streams) of phase 5 or 5b); generate (B=4) must agree
    on the card and the CPU."""
    from repro_torch.serving import EngineConfig

    cfg = card_model.cfg
    card = torch.device("cuda")
    out = {}
    for key, paged in (("contiguous", False), ("paged", True)):
        prompts, mixed_streams = streams[paged]
        ecfg = EngineConfig(max_len=1024, paged_kv=paged, mixed_step=False)
        reset_launches()
        handles, wall, engine = serve(card_model, ecfg, prompts, 32, card)
        launches = read_launches()
        check_handles(handles, engine, 32, cfg.vocab_size, f"legacy vs mixed {key}")
        check(launches["flash_attention"] > 0, f"legacy vs mixed {key}: no flash launch")
        exact, ties = compare_streams(prompts, [h.result() for h in handles], mixed_streams,
                                      card_model, card_model, ("legacy", "mixed"))
        out[key] = dict(requests=len(prompts), exact_streams=exact, near_ties=ties,
                        wall_s=wall, prefills=engine.telemetry.prefills,
                        flash_launches=launches["flash_attention"])
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 64))
    gens = []
    for model in (card_model, cpu_model):
        engine = make_engine_class()(model, EngineConfig(max_len=1024), device=model.device)
        gens.append(engine.generate({"inputs": toks}, 16, 64))
    exact, ties = compare_streams([list(t) for t in toks], gens[0], gens[1], card_model,
                                  cpu_model, ("card", "cpu"))
    out["generate"] = dict(batch=4, prompt_len=64, steps=16, exact_streams=exact,
                           near_ties=ties)
    return out


def expected_scan_launches(cfg, prefills: int, steps: int, max_len: int) -> dict:
    """Every kernel launch a scan-state model must make for ``prefills``
    B-row prefills and ``steps`` decode steps, by name (any kernel not
    named must not launch): rwkv6 one WKV6 launch per layer per prefill;
    the hybrid one SSD launch per Mamba-2 layer and one flash launch per
    shared application per prefill, one decode launch (a split-K pair at a
    max_len that splits) per application per step, and per forward pass
    two plain RMSNorms per Mamba-2 layer, the shared ln1 per application
    and one fused residual add + ln2 per application."""
    from repro_torch.kernels.decode_attention import ops

    L = cfg.n_layers
    if cfg.family == "rwkv":
        return {"wkv6": L * prefills}
    G = L // cfg.attention_every
    passes = prefills + steps
    out = {"ssd": L * prefills, "flash_attention": G * prefills,
           "rmsnorm": (2 * L + G) * passes, "rmsnorm_fused": G * passes}
    if ops.auto_k_splits(max_len) > 1:
        out["decode_attention_splitk_partial"] = G * steps
        out["decode_attention_splitk_combine"] = G * steps
    else:
        out["decode_attention"] = G * steps
    return out


def check_launches(launches: dict, expected: dict, label: str) -> None:
    for name, n in launches.items():
        check(n == expected.get(name, 0),
              f"{label}: kernel {name} launched {n} times, expected {expected.get(name, 0)}")


def scan_prefill_kernel_s(cfg, lengths) -> tuple:
    """The scan kernel of the family (WKV6 or SSD) alone at each prompt's
    length, once per layer, timed with CUDA events: (name, seconds)."""
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    gen = torch.Generator("cuda").manual_seed(5)
    total = 0.0
    for S in lengths:
        if cfg.family == "rwkv":
            H = cfg.d_model // cfg.rwkv_head_dim
            r, k, v, logw, u, _ = wkv_inputs(gen, 1, S, H, cfg.rwkv_head_dim, cfg.torch_dtype,
                                             state=False)
            ms = time_ms(lambda: wkv_kernel.wkv6_cuda(r, k, v, logw, u), cfg.n_layers, 1)
        else:
            H = 2 * cfg.d_model // cfg.ssm_head_dim
            x, dt, A, Bm, Cm, _ = ssd_inputs(gen, 1, S, H, cfg.ssm_head_dim, cfg.ssm_state,
                                             cfg.torch_dtype, state=False)
            ms = time_ms(lambda: ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm), cfg.n_layers, 1)
        total += cfg.n_layers * ms / 1e3          # one launch per layer at this length
    return ("wkv6" if cfg.family == "rwkv" else "ssd"), total


def phase_serve_scan(name_line: str, model) -> dict:
    """Phases 4f (rwkv6-7b) and 4h (zamba2-2.7b): the full-width model
    through EngineClient at the default EngineConfig, which takes legacy
    admission for a scan-state family: phase 4's traffic, one
    Model.prefill per admission, then decode chunks; every kernel launch
    counted against ``expected_scan_launches``."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    dev = model.device
    ecfg = EngineConfig()
    label = f"serve {cfg.name}"
    rng = np.random.default_rng(0)
    serve(model, ecfg, prompts_for(rng, 2, 16, 64, cfg.vocab_size), 4, dev)     # warm-up
    free_memory()
    prompts = prompts_for(rng, 16, 16, 2000, cfg.vocab_size)
    max_new = 32
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    handles, wall, engine = serve(model, ecfg, prompts, max_new, dev)
    launches = read_launches()
    check_handles(handles, engine, max_new, cfg.vocab_size, label)
    tel = engine.telemetry
    check(not engine.mixed and tel.mixed_steps == 0,
          f"{label}: mixed admission ran ({tel.mixed_steps} mixed steps)")
    check(tel.prefills == len(prompts), f"{label}: {tel.prefills} prefills")
    steps = tel.chunks * ecfg.decode_chunk
    check_launches(launches, expected_scan_launches(cfg, tel.prefills, steps, ecfg.max_len),
                   label)
    ttft = np.array([h.record.ttft_s for h in handles])
    out = dict(
        requests=len(handles), layers=cfg.n_layers, dtype=cfg.dtype, max_new=max_new,
        params_gb=sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        generated_tokens=int(sum(len(h.result()) for h in handles)),
        wall_s=wall, tokens_per_s=sum(len(h.result()) for h in handles) / wall,
        ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p99_s=float(np.percentile(ttft, 99)),
        decode_chunks=tel.chunks, decode_steps=steps, prefills=tel.prefills,
        launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        card=name_line)
    # the prefills alone, each timed to its end: their share of the wall
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        model.prefill(torch.as_tensor(p[None], device=dev))
    torch.cuda.synchronize()
    alone = time.perf_counter() - t0
    # the scan kernel alone at each prompt's length, once per layer: its share of those prefills
    kname, kernel_s = scan_prefill_kernel_s(cfg, [len(p) for p in prompts])
    reset_launches()
    out.update({"prefill_alone_s": alone, "prefill_share_of_wall": alone / wall,
                f"{kname}_in_prefills_s": kernel_s,
                f"{kname}_share_of_prefills": kernel_s / alone})
    return out


def phase_generate_scan(name_line: str, model) -> dict:
    """Phases 4g (rwkv6-7b) and 4i (zamba2-2.7b): ServingEngine.generate at
    B=8, prompt 512, 32 steps."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    label = f"generate {cfg.name}"
    B_, plen, steps = 8, 512, 32
    ecfg = EngineConfig()
    engine = make_engine_class()(model, ecfg, device=model.device)
    rng = np.random.default_rng(4)
    engine.generate({"inputs": rng.integers(0, cfg.vocab_size, (2, 16))}, 2, 16)   # warm-up
    toks = rng.integers(0, cfg.vocab_size, (B_, plen))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = engine.generate({"inputs": toks}, steps, plen)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(out.shape == (B_, steps), f"{label}: shape {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{label}: out-of-vocab token")
    check(int(engine.nonfinite) == 0, f"{label}: {int(engine.nonfinite)} non-finite logits")
    check_launches(launches, expected_scan_launches(cfg, 1, steps, ecfg.max_len), label)
    return dict(batch=B_, prompt_len=plen, steps=steps, layers=cfg.n_layers, dtype=cfg.dtype,
                wall_s=wall, tokens_per_s=B_ * steps / wall, launches=launches, card=name_line)


def phase_scan_card_vs_cpu(cfg, n_layers: int) -> dict:
    """Phases 5d (rwkv6-7b, 2 layers) and 5e (zamba2-2.7b, 12 layers: two
    shared applications): full width cut to ``n_layers``, fp32, on the card
    and on the CPU: 6 requests through a 2-slot session (slots reused);
    then decode after prefill(300) against prefill(301) on the card."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig

    small = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    label = f"{cfg.name} card-vs-cpu"
    cpu_model = Model(small, device="cpu").init_(torch.Generator().manual_seed(3))
    card_model = Model(small, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    ecfg = EngineConfig(max_len=512, decode_batch=2)
    rng = np.random.default_rng(6)
    prompts = prompts_for(rng, 6, 16, 300, small.vocab_size)
    max_new = 8
    reset_launches()
    card_h, card_wall, card_eng = serve(card_model, ecfg, prompts, max_new, torch.device("cuda"))
    launches = read_launches()
    tel = card_eng.telemetry
    check_launches(launches, expected_scan_launches(
        small, tel.prefills, tel.chunks * ecfg.decode_chunk, ecfg.max_len), label)
    cpu_h, cpu_wall, cpu_eng = serve(cpu_model, ecfg, prompts, max_new, torch.device("cpu"))
    check_handles(card_h, card_eng, max_new, small.vocab_size, f"{label} card fp32")
    check_handles(cpu_h, cpu_eng, max_new, small.vocab_size, f"{label} cpu fp32")
    exact, ties = compare_streams(prompts, [h.result() for h in card_h],
                                  [h.result() for h in cpu_h], card_model, cpu_model,
                                  ("card", "cpu"))
    # decode after prefill(S) is prefill(S + 1): the kernel's final state as
    # the decode path reads it
    S = 300
    toks = torch.as_tensor(rng.integers(0, small.vocab_size, (1, S + 1)), device="cuda")
    _, pcache = card_model.prefill(toks[:, :S])
    cache = card_model.empty_cache(1, S + 1)
    for buf, leaf in zip(cache, pcache):
        buf[tuple(slice(0, n) for n in leaf.shape)] = leaf
    step = card_model.decode(toks[:, S:], cache, torch.full((1,), S, device="cuda"))
    full, _ = card_model.prefill(toks)
    err = _err(step, full)
    check(bool(torch.allclose(step, full, atol=2e-4, rtol=1e-4)),
          f"{label}: decode after prefill({S}) vs prefill({S + 1}): max abs err {err:.3e}")
    return dict(requests=len(prompts), exact_streams=exact, near_ties=ties,
                layers=small.n_layers, dtype=small.dtype, slots=ecfg.decode_batch,
                prefills=tel.prefills, launches=launches,
                card_wall_s=card_wall, cpu_wall_s=cpu_wall,
                decode_vs_prefill_max_abs_err=err)


# --------------------------------------------------------------------------
# phase 6: timing and bounds
# --------------------------------------------------------------------------


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _sdpa(q4, k, v, mask):
    """(B, Q, Hq, D) query vs (B, S, Hkv, D) cache through one SDPA call."""
    F = torch.nn.functional
    return F.scaled_dot_product_attention(q4.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=mask, enable_gqa=True)


def phase_timing() -> dict:
    from repro_torch.kernels.decode_attention import kernel, ref

    gen = torch.Generator("cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    out = {}

    def row(name, dtype, ms, plain_ms, nbytes, ops, library_ms, shape):
        b_ms, by = bound_ms(nbytes, ops, dtype)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=library_ms, shape=shape)

    ps = PAGE
    no_call = "none (no one call reads a block table)"

    def table_bytes(lengths):
        """The int32 table entries of the pages that hold keys below each length."""
        return 4 * int((-(-np.asarray(lengths) // ps)).sum())

    # single-stage decode, contiguous and paged: their main path is the fp32
    # max_len=1024 serving run (64 columns of 16 over a 769-page pool)
    dt, S = torch.float32, 1024
    es = torch.finfo(dt).bits // 8
    k, v = _rand(gen, (B, S, HKV, D), dt), _rand(gen, (B, S, HKV, D), dt)
    q = _rand(gen, (B, HKV * G, D), dt)
    lens_np = rng.integers(16, S + 1, B)
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    keys = int(lens_np.sum())
    row("decode_attention", dt,
        time_ms(lambda: kernel.decode_attention_cuda(q, k, v, lens), 200),
        time_ms(lambda: ref.decode_attention(q, k, v, lens), 20),
        2 * keys * HKV * D * es + 2 * B * HKV * G * D * es + 4 * B,
        4 * keys * HKV * G * D,
        time_ms(lambda: _sdpa(q[:, None], k, v, mask), 50),
        f"fp32 B={B} S={S} Hkv={HKV} G={G} D={D} lengths={lens_np.tolist()}")
    kp, vp, tbl = paged_inputs(gen, lens_np, ps, dt, S)
    row("decode_attention_paged", dt,
        time_ms(lambda: kernel.decode_attention_paged_cuda(q, kp, vp, tbl, lens), 200),
        time_ms(lambda: ref.decode_attention_paged(q, kp, vp, tbl, lens), 20),
        2 * keys * HKV * D * es + 2 * B * HKV * G * D * es + 4 * B + table_bytes(lens_np),
        4 * keys * HKV * G * D, None,
        f"fp32 B={B} pool {kp.shape[0]}x{ps} tables ({B},{tbl.shape[1]}) Hkv={HKV} G={G} "
        f"D={D} lengths={lens_np.tolist()}; library: {no_call}")
    del k, v, kp, vp

    # split-K at the default max_len=4096 (K=8), bf16, lengths of a 2000-token serving run
    dt, S, K = torch.bfloat16, S_MAX, 8
    es = 2
    k, v = _rand(gen, (B, S, HKV, D), dt), _rand(gen, (B, S, HKV, D), dt)
    q = _rand(gen, (B, HKV * G, D), dt)
    lens_np = rng.integers(16, 2033, B)
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    keys = int(lens_np.sum())
    part_bytes = B * HKV * K * G * (D + 2) * 4
    m, l, acc = kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K)
    sdpa_ms = time_ms(lambda: _sdpa(q[:, None], k, v, mask), 50)
    row("decode_attention_splitk_partial", dt,
        time_ms(lambda: kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K), 200),
        time_ms(lambda: ref.decode_attention_splitk_partial(q, k, v, lens, k_splits=K), 20),
        2 * keys * HKV * D * es + B * HKV * G * D * es + 4 * B + part_bytes,
        4 * keys * HKV * G * D,
        sdpa_ms,
        f"bf16 B={B} S={S} K={K} Hkv={HKV} G={G} D={D} lengths={lens_np.tolist()}; "
        "library_ms is SDPA for the whole partial+combine pair")
    row("decode_attention_splitk_combine", torch.float32,
        time_ms(lambda: kernel.splitk_combine_cuda(m, l, acc, dt), 200),
        time_ms(lambda: ref.splitk_combine(m, l, acc, dt), 50),
        part_bytes + B * HKV * G * D * es,
        B * HKV * K * G * (3 * D + 4),
        None, f"fp32 partials B={B} Hkv={HKV} K={K} G={G} D={D} -> bf16")

    # mixed step: Q=8 (chunk_quantum(64) at 8 slots), a 2048-key window of the 4096 cache
    Q, W = 8, 2048
    qm = _rand(gen, (B, Q, HKV * G, D), dt)
    cl_np = rng.integers(0, W - Q + 1, B)
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")
    kw, vw = k[:, :W], v[:, :W]
    qpos = cl[:, None] + torch.arange(Q, device="cuda")[None, :]
    mmask = (torch.arange(W, device="cuda")[None, None, :] <= qpos[:, :, None])[:, None]
    seen = int(np.minimum(cl_np + Q, W).sum())
    pairs = int(sum((c + i + 1) for c in cl_np for i in range(Q)))
    row("mixed_attention", dt,
        time_ms(lambda: kernel.mixed_attention_cuda(qm, kw, vw, cl), 200),
        time_ms(lambda: ref.mixed_attention(qm, kw, vw, cl), 20),
        2 * seen * HKV * D * es + 2 * B * Q * HKV * G * D * es + 4 * B,
        4 * pairs * HKV * G * D,
        time_ms(lambda: _sdpa(qm, kw, vw, mmask), 50),
        f"bf16 B={B} Q={Q} window={W} of S={S} Hkv={HKV} G={G} D={D} "
        f"cache_lens={cl_np.tolist()}")

    # the paged split-K partial and mixed step over the auto-sized bf16 pool,
    # at the same lengths as their contiguous twins above.  Bytes: the keys
    # below each length, q, out, lengths and the table entries of their pages.
    kp, vp, tbl = paged_inputs(gen, lens_np, ps, dt)
    shape = (f"bf16 B={B} pool {kp.shape[0]}x{ps} tables ({B},{tbl.shape[1]}) "
             f"Hkv={HKV} G={G} D={D}")
    row("decode_attention_paged_splitk_partial", dt,
        time_ms(lambda: kernel.paged_splitk_partial_cuda(q, kp, vp, tbl, lens, k_splits=K), 200),
        time_ms(lambda: ref.decode_attention_paged_splitk_partial(q, kp, vp, tbl, lens,
                                                                  k_splits=K), 20),
        2 * keys * HKV * D * es + B * HKV * G * D * es + 4 * B + table_bytes(lens_np)
        + part_bytes,
        4 * keys * HKV * G * D, None,
        f"{shape} K={K} lengths={lens_np.tolist()}; library: {no_call}")
    view = tbl[:, :W // ps]
    row("mixed_attention_paged", dt,
        time_ms(lambda: kernel.mixed_attention_paged_cuda(qm, kp, vp, view, cl), 200),
        time_ms(lambda: ref.mixed_attention_paged(qm, kp, vp, view, cl), 20),
        2 * seen * HKV * D * es + 2 * B * Q * HKV * G * D * es + 4 * B
        + table_bytes(np.minimum(cl_np + Q, W)),
        4 * pairs * HKV * G * D, None,
        f"{shape} Q={Q} tables cut to {W // ps} columns, cache_lens={cl_np.tolist()}; "
        f"library: {no_call}")
    del k, v, kp, vp

    # flash attention at the prefill of phase 4c's longest prompt: bf16,
    # B=1, S=2000, causal; ops count the S(S+1)/2 visible (query, key) pairs
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref as flash_ref

    S = 2000
    q = _rand(gen, (1, S, HKV * G, D), dt)
    k, v = _rand(gen, (1, S, HKV, D), dt), _rand(gen, (1, S, HKV, D), dt)
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row("flash_attention", dt,
        time_ms(lambda: flash_kernel.flash_attention_cuda(q, k, v, causal=True), 50),
        time_ms(lambda: flash_ref.flash_attention(q, k, v, causal=True), 10),
        (2 * S * HKV * G * D + 2 * S * HKV * D) * es,
        4 * D * HKV * G * S * (S + 1) // 2,
        time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True), 50),
        f"bf16 B=1 Sq=Sk={S} Hq={HKV * G} Hkv={HKV} D={D} causal")

    # WKV6 at phase 4f's longest prefill: B=1, S=2000, 64 heads of 64, bf16
    # r/k/v and u, fp32 logw, from a zero state (state0 None, as
    # Model.prefill calls it).  Bytes: r, k, v, logw, u read once, y and
    # the final state written once; ops: 5 N^2 per token and head, fp32.
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    H, N = 64, 64
    r, k, v, logw, u, _ = wkv_inputs(gen, 1, S, H, N, dt, state=False)
    zeros = torch.zeros((1, H, N, N), device="cuda")
    row("wkv6", torch.float32,
        time_ms(lambda: wkv_kernel.wkv6_cuda(r, k, v, logw, u), 50),
        time_ms(lambda: wkv_ref.wkv6_chunked(r, k, v, logw, u, zeros), 5),
        3 * S * H * N * es + S * H * N * 4 + H * N * es + S * H * N * 4 + H * N * N * 4,
        5 * N * N * S * H, None,
        f"bf16 r/k/v/u, fp32 logw, B=1 S={S} H={H} N={N}, zero state; "
        "library: none (no one call computes the WKV6 recurrence)")
    del r, k, v, logw, u

    # SSD at phase 4h's longest prefill: B=1, S=2000, 80 heads of P=64, N=64,
    # bf16 x/B/C, fp32 dt and A, from a zero state (as Model.prefill calls
    # it).  Bytes: x, dt, A, B, C read once, y and the final state written
    # once; ops: 5 P N per token and head, fp32.
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    H, P, N = 80, 64, 64
    x, dt_, A, Bm, Cm, _ = ssd_inputs(gen, 1, S, H, P, N, dt, state=False)
    zeros = torch.zeros((1, H, P, N), device="cuda")
    row("ssd", torch.float32,
        time_ms(lambda: ssd_kernel.ssd_cuda(x, dt_, A, Bm, Cm), 50),
        time_ms(lambda: ssd_ref.ssd_chunked(x, dt_, A, Bm, Cm, zeros), 5),
        S * H * P * es + 2 * S * N * es + S * H * 4 + H * 4 + S * H * P * 4 + H * P * N * 4,
        5 * P * N * S * H, None,
        f"bf16 x/B/C, fp32 dt/A, B=1 S={S} H={H} P={P} N={N}, zero state; "
        "library: none (no one call computes the SSD recurrence)")
    del x, dt_, Bm, Cm

    # RMSNorm at the same prefill's rows: (2000, 2560) bf16, the plain form
    # (yardstick: F.rms_norm) and the fused residual add; ops: 4 (plain) or
    # 5 (fused) fp32 flops per element
    from repro_torch.kernels.rmsnorm import kernel as norm_kernel
    from repro_torch.kernels.rmsnorm import ref as norm_ref

    M, dm = S, 2560
    xn, res, w = _rand(gen, (M, dm), dt), _rand(gen, (M, dm), dt), _rand(gen, (dm,), dt)
    F = torch.nn.functional
    row("rmsnorm", torch.float32,
        time_ms(lambda: norm_kernel.rmsnorm_cuda(xn, w), 200),
        time_ms(lambda: norm_ref.rmsnorm_ref(xn, w), 50),
        2 * M * dm * es + dm * es, 4 * M * dm,
        time_ms(lambda: F.rms_norm(xn, (dm,), w, 1e-6), 200),
        f"bf16 M={M} d={dm}; library: F.rms_norm")
    row("rmsnorm_fused", torch.float32,
        time_ms(lambda: norm_kernel.rmsnorm_cuda(xn, w, res), 200),
        time_ms(lambda: norm_ref.rmsnorm_ref(xn, w, res), 50),
        4 * M * dm * es + dm * es, 5 * M * dm, None,
        f"bf16 M={M} d={dm}, residual add fused; library: none (no one call adds and "
        "normalises)")
    del xn, res

    # the attention kernels again at zamba2's head_dim 80 and G=1
    def row80(name, dtype, ms, plain_ms, nbytes, ops, library_ms, shape):
        b_ms, by = bound_ms(nbytes, ops, dtype)
        out[name]["d80"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                library_ms=library_ms, shape=shape)

    Hq = Hk = Z_H
    Dz = Z_D
    q = _rand(gen, (1, S, Hq, Dz), dt)
    k, v = _rand(gen, (1, S, Hk, Dz), dt), _rand(gen, (1, S, Hk, Dz), dt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row80("flash_attention", dt,
          time_ms(lambda: flash_kernel.flash_attention_cuda(q, k, v, causal=True), 50),
          time_ms(lambda: flash_ref.flash_attention(q, k, v, causal=True), 10),
          (2 * S * Hq * Dz + 2 * S * Hk * Dz) * es, 4 * Dz * Hq * S * (S + 1) // 2,
          time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 50),
          f"bf16 B=1 Sq=Sk={S} Hq={Hq} Hkv={Hk} D={Dz} causal")
    del q, k, v
    Sc = S_MAX
    k, v = _rand(gen, (B, Sc, Hk, Dz), dt), _rand(gen, (B, Sc, Hk, Dz), dt)
    q = _rand(gen, (B, Hq, Dz), dt)
    lens_np = rng.integers(16, 2033, B)
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    mask = (torch.arange(Sc, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    keys = int(lens_np.sum())
    part_bytes = B * Hk * K * (Dz + 2) * 4
    m, l, acc = kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K)
    row80("decode_attention_splitk_partial", dt,
          time_ms(lambda: kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K), 200),
          time_ms(lambda: ref.decode_attention_splitk_partial(q, k, v, lens, k_splits=K), 20),
          2 * keys * Hk * Dz * es + B * Hq * Dz * es + 4 * B + part_bytes,
          4 * keys * Hq * Dz,
          time_ms(lambda: _sdpa(q[:, None], k, v, mask), 50),
          f"bf16 B={B} S={Sc} K={K} Hkv={Hk} G=1 D={Dz} lengths={lens_np.tolist()}; "
          "library_ms is SDPA for the whole partial+combine pair")
    row80("decode_attention_splitk_combine", torch.float32,
          time_ms(lambda: kernel.splitk_combine_cuda(m, l, acc, dt), 200),
          time_ms(lambda: ref.splitk_combine(m, l, acc, dt), 50),
          part_bytes + B * Hq * Dz * es, B * Hk * K * (3 * Dz + 4),
          None, f"fp32 partials B={B} Hkv={Hk} K={K} G=1 D={Dz} -> bf16")
    return out


# --------------------------------------------------------------------------


REPLACES = {
    "ssd": "src/repro/kernels/ssd_scan/kernel.py:75",
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:55",
    "rmsnorm_fused": "src/repro/kernels/rmsnorm/kernel.py:65",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:96",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:103",
    "decode_attention_splitk_partial": "src/repro/kernels/decode_attention/kernel.py:218",
    "decode_attention_splitk_combine": "src/repro/kernels/decode_attention/kernel.py:272",
    "mixed_attention": "src/repro/kernels/decode_attention/kernel.py:599",
    "decode_attention_paged": "src/repro/kernels/decode_attention/kernel.py:342",
    "decode_attention_paged_splitk_partial": "src/repro/kernels/decode_attention/kernel.py:444",
    "mixed_attention_paged": "src/repro/kernels/decode_attention/kernel.py:692",
    "wkv6": "src/repro/kernels/rwkv6_scan/kernel.py:75",
}
# the main-path runs whose launches each kernel reports (the combine serves both layouts)
ZAMBA2_PHASES = ("serve_zamba2", "generate_zamba2")
LAUNCH_PHASES = {
    "flash_attention": ("serve_legacy", "serve_legacy_paged", "generate") + ZAMBA2_PHASES,
    "decode_attention": ("card_vs_cpu",),
    "decode_attention_splitk_partial": ("serve",) + ZAMBA2_PHASES,
    "decode_attention_splitk_combine": ("serve", "serve_paged") + ZAMBA2_PHASES,
    "mixed_attention": ("serve",),
    "decode_attention_paged": ("card_vs_cpu_paged",),
    "decode_attention_paged_splitk_partial": ("serve_paged",),
    "mixed_attention_paged": ("serve_paged", "serve_legacy_paged"),
    "wkv6": ("serve_rwkv", "generate_rwkv"),
    "ssd": ZAMBA2_PHASES,
    "rmsnorm": ZAMBA2_PHASES,
    "rmsnorm_fused": ZAMBA2_PHASES,
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rmsnorm import kernel as norm_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models import Model

    kernel_mods = (kernel, flash_kernel, wkv_kernel, ssd_kernel, norm_kernel)
    t_start = time.perf_counter()
    name_line = card_line()
    print(f"[1/6] card: {name_line}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build([m.SOURCE for m in kernel_mods])
    print(f"[2/6] built {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        print(f"  {src.relative_to(ROOT)}:")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("    " + line.strip())
    mma = mma_build_report(logs)
    print("  tensor-core attention kernels (ptxas -v): " + json.dumps(mma), flush=True)
    check(len(mma) == 7, f"expected 7 tensor-core kernel instantiations, found {len(mma)}")
    for r in mma:
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0, f"ptxas spills: {r}")

    t0 = time.perf_counter()
    errs = phase_kernels()
    print(f"[3/6] kernels vs plain in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(errs), flush=True)
    print("  worst bf16 row error / row RMS: " + json.dumps(ROW_FRAC), flush=True)

    cfg = get_config("qwen3-0.6b")
    model = Model(cfg, device="cuda").init_(torch.Generator("cuda").manual_seed(0))
    runs = {}
    for key, tag, paged, legacy in (("serve", "4", False, False),
                                    ("serve_paged", "4b", True, False),
                                    ("serve_legacy", "4c", False, True),
                                    ("serve_legacy_paged", "4d", True, True)):
        t0 = time.perf_counter()
        runs[key] = phase_serve(name_line, model, paged=paged, legacy=legacy)
        free_memory()
        what = ("legacy " if legacy else "") + ("paged " if paged else "")
        print(f"[{tag}/6] served full-width qwen3-0.6b ({what or 'mixed '}admission) in "
              f"{time.perf_counter() - t0:.1f} s on {name_line}: " + json.dumps(runs[key]),
              flush=True)
    t0 = time.perf_counter()
    runs["generate"] = phase_generate(name_line, model)
    free_memory()
    print(f"[4e/6] generate at full width in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(runs["generate"]), flush=True)
    del model
    free_memory()

    rcfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    model = Model(rcfg, device="cuda").init_(torch.Generator("cuda").manual_seed(0))
    print(f"[4f/6] rwkv6-7b: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} G "
          f"parameters initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs["serve_rwkv"] = phase_serve_scan(name_line, model)
    free_memory()
    print(f"[4f/6] served full-width rwkv6-7b (legacy admission) in "
          f"{time.perf_counter() - t0:.1f} s on {name_line}: " + json.dumps(runs["serve_rwkv"]),
          flush=True)
    t0 = time.perf_counter()
    runs["generate_rwkv"] = phase_generate_scan(name_line, model)
    print(f"[4g/6] generate on rwkv6-7b in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(runs["generate_rwkv"]), flush=True)
    del model
    free_memory()

    zcfg = get_config("zamba2-2.7b")
    t0 = time.perf_counter()
    model = Model(zcfg, device="cuda").init_(torch.Generator("cuda").manual_seed(0))
    print(f"[4h/6] zamba2-2.7b: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} G "
          f"parameters initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs["serve_zamba2"] = phase_serve_scan(name_line, model)
    free_memory()
    print(f"[4h/6] served full-width zamba2-2.7b (legacy admission) in "
          f"{time.perf_counter() - t0:.1f} s on {name_line}: "
          + json.dumps(runs["serve_zamba2"]), flush=True)
    t0 = time.perf_counter()
    runs["generate_zamba2"] = phase_generate_scan(name_line, model)
    print(f"[4i/6] generate on zamba2-2.7b in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(runs["generate_zamba2"]), flush=True)
    del model
    free_memory()

    small = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    cpu_model = Model(small, device="cpu").init_(torch.Generator().manual_seed(1))
    card_model = Model(small, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    streams = {}
    for key, tag, paged in (("card_vs_cpu", "5", False), ("card_vs_cpu_paged", "5b", True)):
        t0 = time.perf_counter()
        runs[key], prompts, card_streams = phase_card_vs_cpu(cpu_model, card_model, paged=paged)
        streams[paged] = (prompts, card_streams)
        free_memory()
        print(f"[{tag}/6] card vs cpu{' (paged)' if paged else ''} in "
              f"{time.perf_counter() - t0:.1f} s: " + json.dumps(runs[key]), flush=True)
    t0 = time.perf_counter()
    runs["legacy_vs_mixed"] = phase_legacy_vs_mixed(cpu_model, card_model, streams)
    free_memory()
    print(f"[5c/6] legacy vs mixed on the card, generate card vs cpu in "
          f"{time.perf_counter() - t0:.1f} s: " + json.dumps(runs["legacy_vs_mixed"]), flush=True)
    del cpu_model, card_model
    free_memory()
    t0 = time.perf_counter()
    runs["rwkv_card_vs_cpu"] = phase_scan_card_vs_cpu(rcfg, 2)
    free_memory()
    print(f"[5d/6] rwkv6-7b card vs cpu (2 layers, fp32, 2 slots) in "
          f"{time.perf_counter() - t0:.1f} s: " + json.dumps(runs["rwkv_card_vs_cpu"]), flush=True)
    t0 = time.perf_counter()
    runs["zamba2_card_vs_cpu"] = phase_scan_card_vs_cpu(zcfg, 12)
    free_memory()
    print(f"[5e/6] zamba2-2.7b card vs cpu (12 layers, fp32, 2 slots) in "
          f"{time.perf_counter() - t0:.1f} s: " + json.dumps(runs["zamba2_card_vs_cpu"]),
          flush=True)

    t0 = time.perf_counter()
    tim = phase_timing()
    print(f"[6/6] timing in {time.perf_counter() - t0:.1f} s on {name_line}: "
          + json.dumps(tim), flush=True)

    rows = []
    for name, t in tim.items():
        by_phase = {ph: runs[ph]["launches"][name] for ph in LAUNCH_PHASES[name]}
        e = errs[name]
        src = next(m.SOURCE for m in kernel_mods if name in m.LAUNCHES)
        rows.append(dict(
            name=name, route="cuda", source=str(src.relative_to(ROOT)),
            replaces=REPLACES[name], launches=sum(by_phase.values()),
            launches_by_phase=by_phase,
            max_abs_err=e[str(torch.bfloat16)], max_abs_err_fp32=e[str(torch.float32)],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"],
            **({"head_dim_80": t["d80"]} if "d80" in t else {})))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(name_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
