#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: serve qwen3-0.6b, rwkv6-7b and
zamba2-2.7b on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. card: name and power limit from nvidia-smi;
2. build: nvcc builds every kernel source of the path, one process per
   source, all at once (printing ptxas -v); the redesigned kernels'
   registers, spills and static shared memory on a line of their own
   (flash, mixed step and split-K partial: 11 instantiations; the WKV6
   chunk kernel: 6; the SSD chunk kernel: 9; the single-stage decode's
   cluster kernels: 4 bf16, 8 fp32; the fp32 mixed step's cluster kernel:
   4), and no instantiation may spill; the single-stage decode's and the
   fp32 mixed step's dynamic shared memory and how many of their clusters
   the card holds at once (cudaOccupancyMaxActiveClusters), for each
   dtype, head dim and cluster size C the choosers can return (at least
   one each; at C = 1, the SMs times the CTAs an SM holds that
   ``kernel.CLUSTER_CTAS_PER_SM`` and ``kernel.MIXED_CTAS_PER_SM`` give
   the choosers);
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
   sizes 16, 32 and 64 from a random state, 128 heads of 32, a slow decay
   over 2000 tokens, a strong one (log-decays of -7 to -20 a token) over
   100 and 2000, and strided views, y and the state finite; the SSD scan against both plain versions (the
   per-step recurrence and the chunk form) at atol 5e-4, rtol 1e-3, at
   zamba2-2.7b's prefill shape (B=1, S=2000, 80 heads of P=64, N=64, zero
   state), phase 4i's (B=8, S=512), lengths 1-700 from a random state, a
   slow decay (A about -1e-3) over 2000 tokens, a strong one (A = -exp(3 +
   0.5 N(0, 1))) over 100 and 2000, the bf16 chunk kernel's edges (15, 16,
   63, 64, 65 tokens) and strided views; the
   RMSNorm in both forms at the hybrid widths (2560, 5120) over 1, 8 and
   2000 rows (bf16 within one bf16 ulp, fp32 atol 2e-5); the decode,
   split-K and flash kernels at zamba2's head_dim 80 and G=1; poison
   checks, both dtypes: NaN in the cache past every length (phase 4's mixed
   step), in the trash page and every pool row a sequence does not hold
   (phase 4d's prefill_paged call), past Sq and Sk (the flash prefill at
   S=2000), and in bf16 past every length and in every pool row not held
   for the split-K partial and decode (qwen3's and zamba2's heads, phase
   4b's pool) leave the output finite and bit-equal to the clean run's;
   the bf16 paged split-K also at page sizes 5 and 12 (the kernel's
   division path); every empty split chunk is the identity state exactly;
   the split-K decode, one launch whose last CTA of each sequence and kv
   head merges the chunk states, in both layouts and dtypes against the
   plain merge of the partial kernel's own states, its plain version and
   the plain decode, also with a zero-length row (exactly 0), its counters
   0 after it and repeated launches bit-equal;
   the single-stage decode (one launch split over a thread-block cluster)
   at the recovery tier's shape (B=3, max_len 544, qwen3-0.6b reduced as
   the JAX fleet serves it: 2 kv heads of 32, G 2; paged and contiguous,
   lengths at its chunk edges) in both dtypes, and with NaN past every
   length (qwen3's and zamba2's heads) and in every pool row of the
   tier's pool not held; the fp32 mixed step's cluster kernel at Q 13 x
   G 2 = 26 rows (a full and a partial 16-row block) with cache lengths
   putting row limits on each side of every chunk edge, at every cluster
   size, through phase 6's window and tables cut to it, and at the
   recovery tier's shape (Q 8), and with NaN past every cache_len + Q and
   in every row of the tier's pool not held;
4. serve: EngineClient serves full-width qwen3-0.6b (28 layers, bf16,
   seeded random weights) at the default EngineConfig: 16 requests,
   prompts 16..2000 tokens, 32 new tokens each; the engine's steps run as
   CUDA graphs, in every served phase (4-4m, 5-5h): the mixed-step grid
   (10 (Q, window) buckets) and the decode chunk are captured before the
   clock starts (``warm_mixed_traces``, ``warm_decode``; the capture time,
   the graph count and the graph pool's memory on a line of their own),
   ``generate``'s loop by a call of the same batch and steps; launch
   counters are zeroed just before and read just after (a replay adds its
   graph's launches); 4-4d launch the split-K
   decode exactly once per layer per decode step, the partial alone never;
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
4j. serve below the split-K threshold: phase 4's model at
   EngineConfig(max_len=1536), mixed admission, 8 requests (prompts
   16..1400, 32 new tokens): every decode step runs the bf16 single-stage
   cluster kernel, its launches held to layers x decode steps exactly, and
   no kernel but it and the mixed step may launch;
4k. the same over the paged pool (the paged single-stage decode);
4l. serve with speculative decoding: phase 4's model at the default
   EngineConfig with spec_k=4, mixed admission, contiguous: 16 requests of
   64 new tokens, 8 random prompts (16..2000 tokens) interleaved with 8
   periodic ones (a random 24-token motif repeated to 64..1024 tokens);
   the 10 verify-step buckets (Q 8, windows 8..4096) are captured with
   the mixed grid and the decode chunk before the clock
   (``warm_spec_traces``); every request gets its 64 tokens,
   ``useful_tokens`` is their sum, accepted <= drafted, the mixed-step
   kernel launches exactly layers x (mixed steps + verify steps) and no
   decode kernel launches; the drafted and accepted tokens per request,
   read from the drafter's calls and the greedy streams, must add up to
   the telemetry's; prints the acceptance rate of each half and how a
   round's wall splits (drafting, issuing the replay, the wait for the
   verdict and its walk; CUDA events give the verify step's device time);
   then serves the same traffic with spec_k=0 (``spec_off``) beside it;
4m. the same over the paged pool, every page released after the drain;
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
   decode step 9 split-K launches at head_dim 80; every norm of the hybrid
   path through the RMSNorm kernel; no mixed, paged or WKV6 kernel may
   launch. The rwkv6 model is freed first;
4i. generate on zamba2-2.7b: B=8, prompt 512, 32 steps;
4n. durable KV: phase 4's model, paged, mixed admission at a prefill
   budget of 1024 (a q-chunk of 128 a slot, so that all 8 requests decode
   at once): 8 requests, prompts 16..2000, 32 new tokens; after the pump
   in which every slot decodes, ``extract_frontiers()`` (each frontier's
   bytes, its extract timed whole and as the gather, the copy to the
   host and the host cast), the longest injected into a second pool
   (bit-equal below its frontier), the session killed; a fresh session
   of the same engine (graphs captured first, none after) restores them
   (each ``_admit_restored`` timed) and drains: every request its 32
   tokens, starting with its frontier's, zero recomputed and zero
   prefilled tokens, the recovered tokens the frontiers', zero live
   pages, and only the paged split-K decode launched (layers x decode
   steps); then each prompt's re-prefill on the same engine (a fresh
   admission's pump: its mixed steps and one decode chunk), printed
   beside its frontier;
4o. durable state: 4n's checks for rwkv6-7b (after 4g) and zamba2-2.7b
   (after 4i) on the model loaded, legacy admission: 2 requests (prompts
   64 and 512, 32 new), their ``StateFrontier``s taken after one pump,
   restored in a fresh session with no prefill kernel, every launch held
   to ``expected_scan_launches`` of the restored decode steps; bytes,
   extract, restore and re-prefill times printed;
4p. fleet drill: ``FleetRuntime`` (``repro_torch.fleet``) over
   ``build_demo_fleet``'s two tiers and economics, cheap (4 slots) and
   premium (8 slots), at qwen3-0.6b's full widths in bf16 (the tiers'
   ``model_overrides``), max_len 1024, mixed admission: 32 requests of its
   Poisson trace at 2 req/s of control-loop time (prompts 16..512, 16..32
   new tokens), the cheap pool at zero from 6 to 16 s.  Every request
   completes, none is dropped, at least one is retried; capacity mode on
   more than 60% of the outage's ticks from 8 s, cost mode first and on
   more than half of the ticks from 20 s; nothing completes on the dead tier in the outage;
   every decision ``explains()`` itself; the mixed step and the
   single-stage decode launch once a layer per step of the tiers'
   engines, and nothing else; a reduced fp32 twin of the fleet on the
   CPU takes the same decisions and placements (the loop runs on its own
   clock).  Prints the mode trace, ticks and wall, each replica's graph
   captures on its first pumps (count, seconds), the cost and goodput,
   the policy step's host time on the card and the CPU.  Each request's
   bf16 stream is held against a bare engine of the tier it completed on
   (that tier's engine config): equal, or a near-tie at its first
   divergence (the two tokens' margin under an fp32 copy of the weights
   below ``BF16_TIE_SIGMAS`` times the bf16 logits' RMS error there),
   printed with the count of equal streams;
4q. durable-KV fleet drill: ``build_recovery_fleet``'s tier (paged, 3
   slots, 8 requests of 512-token prompts, kills at 2 and 4 s, a
   preemption notice at 3 s, the fleet KV store on) at full width in bf16:
   none dropped, at least one retry, zero recomputed prefill tokens,
   recovered tokens > 0, store puts and hits > 0; the paged mixed step
   and the paged single-stage decode launch once a layer per step, and
   nothing else;
5. card vs CPU: the same kind of traffic at fp32 (full width, 4 layers,
   max_len 1024, prompts up to 900) on the card and on the CPU (plain
   versions); greedy streams must agree token for token, or each first
   divergence must be a near-tie, printed with its logit margin; the
   single-stage decode's launches are held to layers x decode steps;
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
5f. captured vs eager: the card runs of 5, 5b, 5c (both layouts' legacy
   traffic and ``generate``), 5d and 5e again with ``graphs=False``: the
   streams must be token-exact with the captured runs' and every launch
   count equal;
5g. stale buffers: on phase 5's model, a captured and an eager engine
   (both layouts) run one mixed-step bucket and the decode chunk at one
   set of lengths, flags, chunk tokens and block tables, then at another
   (the captured engine's replays): every output bit-equal to eager's;
5h. speculative exactness in fp32: phase 5's 4-layer model at a 16-token
   vocabulary (greedy streams loop, so drafts are accepted), 6 requests
   (3 random, 3 periodic prompts of 16..300 tokens, 32 new), contiguous and
   paged, at spec_k 1, 4 and 8 (verify steps of 2, 8 and 16 columns): the
   card's streams must equal spec off on the card and the CPU's speculating
   streams (or near-ties), accepted > 0, the launches held as in 4l, and
   each captured run token-exact with its graphs=False twin with equal
   launch counts;
5i. durable exactness in fp32: phase 5's 4-layer model (max_len 1024,
   paged; mixed and legacy admission: 10 requests, prompts 16..120, 24 new
   tokens, 8 slots) and 5d's and 5e's models (4 requests through 2 slots,
   prompts 16..300, 16 new): frontiers taken after the first pump, the
   session killed, every request resubmitted to a fresh session (with its
   frontier where it has one); each restored card stream must equal the
   uninterrupted card stream and the CPU's, which resumes the card's
   frontiers alone (or near-ties under ``NEAR_TIE``, printed with their
   margins); the kill and restore again with graphs=False must be
   token-exact with equal launch counts; paged, every frontier injected
   into a second pool is bit-equal below its frontier;
5j. fleet exactness in fp32: ``build_demo_fleet`` (the cheap pool out from
   6 to 16 s, 40 requests of 8-token prompts, 4..12 new) with phase 5's
   model shape (full width cut to 4 layers, fp32, through the tiers'
   ``model_overrides``), once with ``device="cuda"`` and once on the CPU:
   the same mode trace, ``DecisionRecord``s and per-request records
   (tier, replica, retries, timestamps), the outage checks of 4p, and
   streams equal token for token or near-ties under ``NEAR_TIE``;
6. timing: every kernel, its plain version and the one PyTorch call with
   the same result (scaled_dot_product_attention, used only as a
   yardstick; no one call reads a block table or computes the WKV6 or SSD
   recurrence; ``F.rms_norm`` for the plain RMSNorm) timed with CUDA
   events over calls queued behind a sleep kernel (device time, not the
   host's call rate), the attention kernels also at head_dim 80, WKV6
   also at phase 4g's shape (B=8, S=512) and SSD at phase 4i's (B=8,
   S=512), the bf16 WKV6 and SSD kernels at each slice width
   (``ms_by_cols``, ``ms_by_rows``), the single-stage decode also in
   bf16 (beside SDPA) and in fp32 at the recovery tier's shape (B=3, 2
   kv heads of 32, paged, max_len 544), each at every cluster size
   (``ms_by_cluster``); the split-K decode also as its partial alone
   (``partial_ms``); the bf16 mixed step also at Q 16 (``q16``, the
   verify step of spec_k 8); the fp32 routes (``cluster_mixed_f32_kernel`` as the
   mixed step, contiguous and paged, also at the recovery tier's shape,
   each at every cluster size; ``flash_rows_kernel<float>`` as the
   split-K decode, ``flash_fwd_kernel``, ``wkv6_kernel``, ``ssd_kernel``)
   at phase 6's shapes as an ``fp32`` sub-row with their launches in
   phases 5-5e; bounds
   from the bytes and operations of the inputs timed (the bf16 scans'
   flops at the 3xTF32 rate).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
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
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  # fp32 products on the tensor cores as 3xTF32: three TF32
                  # products (495 TFLOP/s dense) per fp32 product
                  "3xtf32": 495e12 / 3,
                  # fp32 products with one operand exact in TF32 (a widened
                  # bf16): the other split in two, two TF32 products each
                  "2xtf32": 495e12 / 2}
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-3), torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
# An output element at length L is about sqrt(e / L) in size (0.026 at
# L=4096), so the flat bf16 atol alone would let a long-length fault pass;
# each output row's largest bf16 error is also held to this share of the
# row's RMS.  Where the kernel and the plain version round one p to
# different bf16 values, an output element moves by at most 2^-7 * p * |v|.
BF16_ROW_FRAC = 0.1
ROW_FRAC = {}              # check -> worst bf16 row error as a share of its RMS
NEAR_TIE = 1e-3            # logit margin below which an argmax flip is a near-tie
# A bf16 flip between tokens a and b is a near-tie when their fp32 margin
# (the same weights in fp32) is under this many times bf16's own logit
# error at that context (its RMS over the vocabulary): each of two runs
# picked its token by its own rounding noise, whose difference at a and b
# has sqrt(2) times that RMS, so 6 is 4.2 of its standard deviations.
BF16_TIE_SIGMAS = 6.0

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
    """The redesigned kernels' ptxas -v lines, per instantiation (the
    tensor-core kernels, the fp32 single-stage cluster kernel and the fp32
    mixed step's cluster kernel):
    registers, spill stores and loads, static shared memory (their rings
    are dynamic shared memory, sized in each source's header note)."""
    import re

    rows, cur = [], None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '.*?\d+((?:[a-z_]|wkv6)+_(?:mma|chunk)_kernel"
                          r"|cluster_f32_kernel|cluster_mixed_f32_kernel)ILi(\d+)E(?:Li(\d+)E)?",
                          line)
            if m:
                args = ", ".join(a for a in m.group(2, 3) if a)
                cur = dict(kernel=f"{m.group(1)}<{args}>")
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
        check(torch.equal(m[empty], m_r[empty]), "empty split chunk's m is not exactly -1e30")
        check(_err(m[~empty], m_r[~empty]) < 1e-4, "split-K partial m differs")
        check(bool(torch.allclose(l, l_r, rtol=1e-3, atol=1e-4)), "split-K partial l differs")
        norm = lambda a, ll: a / ll.clamp(min=1e-30)[..., None]  # noqa: E731
        note("decode_attention_splitk_partial", _close(
            "splitk_partial (acc/l)", norm(acc, l), norm(acc_r, l_r), dtype))
        # the one-launch split-K decode, also with a zero-length row and
        # lengths at each side of the 512-key chunk edges
        for ls in (lens_list, [0, 1, 17, 511, 512, 513, 2049, 4096]):
            lz = torch.tensor(ls, dtype=torch.int32, device="cuda")
            note("decode_attention_splitk",
                 fused_splitk_check(f"splitk lengths={ls}", q, k, v, lz, dtype, 8))

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

        part, fused = paged_splitk_check(tag, q, kp, vp, tbl, lens, dtype)
        note("decode_attention_paged_splitk_partial", part)
        note("decode_attention_paged_splitk", fused)

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

    # the bf16 paged split-K at page sizes that are not powers of two (the
    # kernel's division path), at max_len 4000 and 4032 (tables of 800 and
    # 336 columns, so K=8); a generator of its own, so the checks after it
    # see the same inputs as before
    sgen = torch.Generator("cuda").manual_seed(4)
    for ps, max_len in ((5, 4000), (12, 4032)):
        dtype, ck = torch.bfloat16, max_len // 8
        lens_np = np.array([1, ps, ck // 2, ck, ck + 1, 999, 2049, max_len])
        kp, vp, tbl = paged_inputs(sgen, lens_np, ps, dtype, max_len)
        lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
        q = _rand(sgen, (B, HKV * G, D), dtype)
        paged_splitk_check(f"ps={ps} max_len={max_len}", q, kp, vp, tbl, lens, dtype)
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
    # a generator of its own, so the checks before it keep their inputs
    for name, e in single_stage_checks(torch.Generator("cuda").manual_seed(7)).items():
        for dt, err in e.items():
            errs[name][dt] = max(errs[name].get(dt, 0.0), err)
    for name, err in mixed_cluster_checks(torch.Generator("cuda").manual_seed(11)).items():
        errs[name]["torch.float32"] = max(errs[name]["torch.float32"], err)
    torch.cuda.synchronize()
    return errs


def _edge_cache_lens(S: int, Q: int, C: int) -> list:
    """Cache lengths whose rows' limits (cache_len + i + 1, i < Q) lie all
    below, on both sides of, and all above each chunk edge of a cluster of
    C over S keys, and S - Q."""
    from repro_torch.kernels.decode_attention import kernel

    out = {S - Q}
    for lo, end in kernel.cluster_chunks(S, C):
        for e in (lo, end):
            out |= {e - Q - 1, e - (Q + 1) // 2, e}
    return sorted(n for n in out if 0 <= n <= S - Q)


def mixed_cluster_checks(gen) -> dict:
    """The fp32 mixed step's cluster kernel with rows that are not a
    multiple of its 16-row blocks (Q 13 x G 2 = 26 rows: a full and a
    partial block) and cache lengths that put row limits on each side of
    every cluster-chunk edge, at every cluster size and the chooser's: at
    qwen3-0.6b's heads through phase 6's 2048-key window of the 4096-row
    cache and through tables cut to it (16-token pages), and at the
    recovery tier's shape (2 kv heads of 32, G 2, B=3, Q 8, 34-column
    tables over its 205-page pool; clusters of 4)."""
    from repro_torch.kernels.decode_attention import kernel, ref

    dt = torch.float32
    errs = {"mixed_attention": 0.0, "mixed_attention_paged": 0.0}
    Q, W = 13, 2048
    # phase 6's Q = 8 is one block a (sequence, kv head): clusters of 2; the
    # two blocks of Q = 13 take 1
    check(kernel.mixed_cluster(W, B, HKV, 8, G, D) == 2 and kernel.mixed_cluster(
        W, B, HKV, Q, G, D) == 1, "the chooser's fp32 mixed clusters at phase 6's window")
    k, v = _rand(gen, (B, S_MAX, HKV, D), dt), _rand(gen, (B, S_MAX, HKV, D), dt)
    for C in (1, 2, 4, 8):
        lens = _edge_cache_lens(W, Q, C)
        for i in range(0, len(lens), B):
            cl_np = np.array((lens[i:i + B] + [W - Q] * B)[:B])
            cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")
            qm = _rand(gen, (B, Q, HKV * G, D), dt)
            tag = f"Q={Q} C={C} cache_lens={cl_np.tolist()}"
            want = ref.mixed_attention(qm, k[:, :W], v[:, :W], cl)
            for c in (C, None):
                errs["mixed_attention"] = max(errs["mixed_attention"], _close(
                    f"fp32 mixed window {tag} cluster={c}",
                    kernel._mixed(qm, k[:, :W], v[:, :W], cl, "mixed_attention", cluster=c),
                    want, dt))
            kp, vp, tbl = paged_inputs(gen, cl_np + Q, PAGE, dt)
            view = tbl[:, :W // PAGE]
            want = ref.mixed_attention_paged(qm, kp, vp, view, cl)
            errs["mixed_attention_paged"] = max(errs["mixed_attention_paged"], _close(
                f"fp32 mixed paged {tag}",
                kernel._mixed(qm, kp, vp, cl, "mixed_attention_paged", view, cluster=C),
                want, dt))
            del kp, vp
    del k, v
    tq = 8
    check(kernel.mixed_cluster(TIER_S, TIER_B, TIER_HKV, tq, TIER_G, TIER_D) == 4,
          "the tier's fp32 mixed cluster is not 4 CTAs")
    lens = _edge_cache_lens(TIER_S, tq, 4)
    for i in range(0, len(lens), TIER_B):
        cl_np = np.array((lens[i:i + TIER_B] + [TIER_S - tq] * TIER_B)[:TIER_B])
        cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")
        kp, vp, tbl = tier_inputs(gen, cl_np + tq, dt)
        q = _rand(gen, (TIER_B, tq, TIER_HKV * TIER_G, TIER_D), dt)
        errs["mixed_attention_paged"] = max(errs["mixed_attention_paged"], _close(
            f"fp32 mixed paged tier cache_lens={cl_np.tolist()}",
            kernel.mixed_attention_paged_cuda(q, kp, vp, tbl, cl),
            ref.mixed_attention_paged(q, kp, vp, tbl, cl), dt))
    return errs


# the recovery fleet's tier (the JAX package's fleet/runtime.py:
# build_recovery_fleet, whose engines serve get_config(arch).reduce(),
# :578; the port has no fleet): 3 slots, max_len 544, paged, qwen3-0.6b
# reduced to fp32 with 2 kv heads of 32 and G 2: clusters of 4 CTAs
TIER_B, TIER_S = 3, 544
TIER_HKV, TIER_G, TIER_D = 2, 2, 32


def tier_inputs(gen, lens_np, dtype):
    """The tier's pool (1 + 2·B·nb pages of 16, as the recovery fleet sizes
    it) and (B, nb) tables of shuffled pages, the trash page past each length."""
    nb = TIER_S // PAGE
    P = 1 + 2 * TIER_B * nb
    kp, vp = (_rand(gen, (P, PAGE, TIER_HKV, TIER_D), dtype) for _ in range(2))
    tbl = np.random.default_rng(TIER_S).permutation(np.arange(1, P))[: TIER_B * nb]
    tbl = tbl.reshape(TIER_B, nb)
    tbl[np.arange(nb)[None, :] >= -(-np.asarray(lens_np) // PAGE)[:, None]] = 0
    return kp, vp, torch.as_tensor(tbl, dtype=torch.int32, device="cuda")


def single_stage_checks(gen) -> dict:
    """The single-stage decode at the recovery tier's shape (B=3, 2 kv
    heads of 32, G 2, max_len 544: clusters of 4 CTAs over 128, 128, 128
    and 160 keys), paged and contiguous, in its fp32 and in bf16, at
    lengths on each side of every chunk edge; its poison checks are in
    poison_checks."""
    from repro_torch.kernels.decode_attention import kernel, ref

    errs = {"decode_attention": {}, "decode_attention_paged": {}}
    for dt in (torch.bfloat16, torch.float32):
        C = kernel.cluster_split(TIER_S, TIER_B * TIER_HKV,
                                 kernel.CLUSTER_CTAS_PER_SM[dt][TIER_D])
        check(C == 4, f"the tier's cluster is {C} CTAs, not 4 ({dt})")
    edges = [1, 127, 128, 129, 255, 256, 257, 383, 384, 385, 543, 544]
    for dtype in (torch.bfloat16, torch.float32):
        for i in range(0, len(edges), TIER_B):
            lens_np = np.array(edges[i:i + TIER_B])
            lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
            q = _rand(gen, (TIER_B, TIER_HKV * TIER_G, TIER_D), dtype)
            kp, vp, tbl = tier_inputs(gen, lens_np, dtype)
            err = _close(f"decode_attention_paged tier lengths={lens_np.tolist()}",
                         kernel.decode_attention_paged_cuda(q, kp, vp, tbl, lens),
                         ref.decode_attention_paged(q, kp, vp, tbl, lens), dtype)
            errs["decode_attention_paged"][str(dtype)] = max(
                errs["decode_attention_paged"].get(str(dtype), 0.0), err)
            k, v = (_rand(gen, (TIER_B, TIER_S, TIER_HKV, TIER_D), dtype) for _ in range(2))
            err = _close(f"decode_attention tier lengths={lens_np.tolist()}",
                         kernel.decode_attention_cuda(q, k, v, lens),
                         ref.decode_attention(q, k, v, lens), dtype)
            errs["decode_attention"][str(dtype)] = max(
                errs["decode_attention"].get(str(dtype), 0.0), err)
    return errs


def fused_splitk_check(tag, q, k, v, lens, dtype, K, tbl=None) -> float:
    """The one-launch split-K decode over K/V (or, with ``tbl``, the pool
    through the tables) against the plain merge of the partial kernel's
    own chunk states, against its plain version (every row: 0 at length 0,
    as the TPU kernels give) and against the plain single-stage decode
    (rows of nonzero length); the split-K counters all 0 after it, and
    three more launches bit-equal to it.  Returns the error against the
    plain version."""
    from repro_torch.kernels.decode_attention import kernel, ref

    if tbl is None:
        def fused():
            return kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K)
        m, l, acc = kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K)
        plain = ref.decode_attention_splitk(q, k, v, lens, k_splits=K)
        plain_decode = ref.decode_attention(q, k, v, lens)
    else:
        def fused():
            return kernel.decode_attention_paged_splitk_cuda(q, k, v, tbl, lens, k_splits=K)
        m, l, acc = kernel.paged_splitk_partial_cuda(q, k, v, tbl, lens, k_splits=K)
        plain = ref.decode_attention_paged_splitk(q, k, v, tbl, lens, k_splits=K)
        plain_decode = ref.decode_attention_paged(q, k, v, tbl, lens)
    got = fused()
    _close(f"{tag} vs the plain merge of its partials", got, ref.splitk_combine(m, l, acc, dtype),
           dtype)
    err = _close(f"{tag} vs plain", got, plain, dtype)
    live = lens > 0
    _close(f"{tag} vs plain decode", got[live], plain_decode[live], dtype)
    check(bool((got[~live] == 0).all()), f"{tag}: a zero-length row is not 0")
    for _ in range(3):
        check(torch.equal(fused(), got), f"{tag}: a repeated launch differs")
    torch.cuda.synchronize()
    check(not bool(kernel.split_counters(q, 0).any()), f"{tag}: split-K counters not 0 after it")
    return err


def paged_splitk_check(tag, q, kp, vp, tbl, lens, dtype) -> tuple:
    """The paged split-K partial (at the engine's split of this table) and
    the one-launch paged split-K decode against their plain versions, the
    latter also with row 0 at length 0; returns both errors."""
    from repro_torch.kernels.decode_attention import kernel, ops, ref

    ps = kp.shape[1]
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
    check(torch.equal(m[empty], m_r[empty]), "empty paged split chunk's m is not exactly -1e30")
    check(_err(m[~empty], m_r[~empty]) < 1e-4, f"paged split-K partial m differs ({tag})")
    check(bool(torch.allclose(l, l_r, rtol=1e-3, atol=1e-4)),
          f"paged split-K partial l differs ({tag})")
    norm = lambda a, ll: a / ll.clamp(min=1e-30)[..., None]  # noqa: E731
    err = _close(f"paged splitk_partial (acc/l) {tag}", norm(acc, l), norm(acc_r, l_r), dtype)
    fused = 0.0
    for lz in (lens, torch.cat([lens.new_zeros(1), lens[1:]])):
        fused = max(fused, fused_splitk_check(f"paged splitk {tag} lengths={lz.tolist()}",
                                              q, kp, vp, lz, dtype, K, tbl))
    return err, fused


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


def wkv_inputs(gen, B_, S, H, N, dtype, *, state=True, mu=-2.0):
    """r, k, v in ``dtype``; logw = -exp(mu + 0.5 N(0,1)) fp32: mu = -2 as
    the model makes it (a log-decay near w0 = -2), -5 a slow decay (a state
    that keeps thousands of tokens), 2 or 3 a strong one (log-decays of -7
    to -20 a token); u in ``dtype``; state0 fp32 or None."""
    r, k, v = (_rand(gen, (B_, S, H, N), dtype) for _ in range(3))
    logw = -torch.exp(mu + 0.5 * _rand(gen, (B_, S, H, N), torch.float32))
    u = (0.5 * _rand(gen, (H, N), torch.float32)).to(dtype)
    s0 = _rand(gen, (B_, H, N, N), torch.float32) if state else None
    return r, k, v, logw, u, s0


def wkv6_kernel_checks(gen) -> dict:
    """The WKV6 kernel vs both plain versions (y and the final state):
    phase 4f's prefill call (B=1, S=2000, 64 heads of 64, zero state),
    phase 4g's (B=8, S=512), lengths 1-700 at N 16/32/64 from a random
    state, 128 heads of 32 (the bf16 chunk kernel's 32-column slices at
    N=32), a slow decay over 2000 tokens, a strong one (mu 2 and 3) over
    100 and 2000, and strided views."""
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    errs = {}
    cases = [(1, 2000, 64, 64, False, -2.0), (8, 512, 64, 64, False, -2.0)]
    cases += [(2, S, 4, N, True, -2.0) for S in (1, 17, 100, 700) for N in (16, 32, 64)]
    cases += [(1, 150, 128, 32, True, -2.0), (2, 2000, 4, 64, True, -5.0)]
    cases += [(2, S, 4, 64, True, mu) for mu in (2.0, 3.0) for S in (100, 2000)]
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

        for B_, S, H, N, state, mu in cases:
            run(f"B={B_} S={S} H={H} N={N} state={state} mu={mu}",
                *wkv_inputs(gen, B_, S, H, N, dtype, state=state, mu=mu))
        # slices of a wider buffer, read in place
        fused = _rand(gen, (2, 333, 3, 4, 64), dtype)
        *_, logw, u, s0 = wkv_inputs(gen, 2, 666, 4, 64, dtype)
        run("strided views", fused[:, :, 0], fused[:, :, 1], fused[:, :, 2], logw[:, ::2], u, s0)
    return errs


# zamba2-2.7b's shared attention: 32 q and 32 kv heads of 80 (G=1)
Z_H, Z_D = 32, 80


def head_dim_80_checks(gen) -> dict:
    """The attention kernels at zamba2's head_dim 80, G=1: the single-stage
    decode at phase 5e's max_len 512, the one-launch split-K decode at the default
    max_len 4096 (K=8) over 8 slots, and the flash forward at the prefill
    shape (B=1, causal, q/k/v slices of one fused projection) at S 16, 700
    and 2000."""
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref as flash_ref

    errs = {name: {} for name in ("decode_attention", "decode_attention_splitk_partial",
                                  "decode_attention_splitk", "flash_attention")}

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
        check(torch.equal(m[empty], m_r[empty]), "D=80: empty split chunk's m is not exactly -1e30")
        check(_err(m[~empty], m_r[~empty]) < 1e-4, "D=80 split-K partial m differs")
        check(bool(torch.allclose(l, l_r, rtol=1e-3, atol=1e-4)), "D=80 split-K partial l differs")
        norm = lambda a, ll: a / ll.clamp(min=1e-30)[..., None]  # noqa: E731
        note("decode_attention_splitk_partial", dtype, _close(
            "splitk_partial D=80 (acc/l)", norm(acc, l), norm(acc_r, l_r), dtype))
        for lz in (lens, torch.cat([lens.new_zeros(1), lens[1:]])):
            note("decode_attention_splitk", dtype, fused_splitk_check(
                f"splitk D=80 lengths={lz.tolist()}", q, k, v, lz, dtype, K))
        del k, v
        for S in (16, 700, 2000):
            fused = _rand(gen, (1, S, 3 * Z_H, Z_D), dtype)
            q, k, v = fused[:, :, :Z_H], fused[:, :, Z_H:2 * Z_H], fused[:, :, 2 * Z_H:]
            note("flash_attention", dtype, _close(
                f"flash_attention D=80 S={S}", flash_kernel.flash_attention_cuda(q, k, v),
                flash_ref.flash_attention(q.contiguous(), k.contiguous(), v.contiguous()), dtype))
    return errs


def ssd_inputs(gen, B_, S, H, P, N, dtype, *, state=True, slow=False, mu=None):
    """x, B, C in ``dtype``; dt = softplus(N(0, 1)) fp32, as the model makes
    it from its projection; A = -exp(0.3 N(0, 1)), or with ``slow`` -1e-3
    times that (a state that keeps thousands of tokens) and x scaled by
    1/16, so y keeps the scale the scan tolerance is set for (at unit x the
    two plain versions alone differ by up to 2.9e-3 over 2000 steps), or
    with ``mu`` -exp(mu + 0.5 N(0, 1)) from the same draw; state0 fp32 or
    None."""
    x = (_rand(gen, (B_, S, H, P), torch.float32) / (16.0 if slow else 1.0)).to(dtype)
    dt = torch.nn.functional.softplus(_rand(gen, (B_, S, H), torch.float32))
    z = _rand(gen, (H,), torch.float32)
    A = -torch.exp(mu + 0.5 * z) if mu is not None else (
        -(1e-3 if slow else 1.0) * torch.exp(0.3 * z))
    Bm, Cm = _rand(gen, (B_, S, N), dtype), _rand(gen, (B_, S, N), dtype)
    s0 = _rand(gen, (B_, H, P, N), torch.float32) if state else None
    return x, dt, A, Bm, Cm, s0


def ssd_kernel_checks(gen) -> dict:
    """The SSD kernel vs both plain versions (y and the final state):
    phase 4h's prefill call (B=1, S=2000, 80 heads of 64, N=64, zero
    state), phase 4i's (B=8, S=512), lengths 1-700 at N 16 and 64 from a
    random state, a slow decay over 2000 tokens, strided views (x, B, C
    slices of one conv output, as mamba2_layer passes them); then, on a
    generator of their own (so the checks after them see the same inputs
    as before), a strong decay (A = -exp(3 + 0.5 N(0, 1)), unit x) over 100
    and 2000 tokens and the bf16 chunk kernel's edges (15, 16, 63, 64, 65
    tokens: its 16-token sub-chunks and 64-token chunks)."""
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
    sgen = torch.Generator("cuda").manual_seed(6)
    more = [(2, S, 4, 64, 64, True, 3.0) for S in (100, 2000)]
    more += [(2, S, 3, 64, 64, True, None) for S in (15, 16, 63, 64, 65)]
    for dtype in (torch.bfloat16, torch.float32):
        for B_, S, H, P, N, state, mu in more:
            run(f"B={B_} S={S} H={H} P={P} N={N} state={state} mu={mu}",
                *ssd_inputs(sgen, B_, S, H, P, N, dtype, state=state, mu=mu))
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
    and v are cut from (the flash prefill at B=1, S=2000); then the bf16
    split-K partial and decode, with NaN past every length (qwen3's and
    zamba2's heads) and in every pool row not held (phase 4b's pool).  The
    output must be finite and equal to the clean run's, bit for bit."""
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

    # the bf16 split-K partial (m, l, acc) and decode, K=8 over 4096 keys:
    # NaN in the cache past every length at qwen3's heads and at zamba2's
    # (32 kv heads of 80), then in every row of phase 4b's pool that no
    # sequence holds below its length, the trash page included
    dtype, K = torch.bfloat16, 8
    lens_np = np.array([1, 17, 511, 512, 513, 2049, 3000, S_MAX - 5])
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")

    def same_split(tag, partial, fused, *kv):
        for what, got, want in zip(("m", "l", "acc"), partial(*kv[:2]), partial(*kv[2:])):
            same(f"splitk_partial {what} {tag}", got, want)
        same(f"splitk {tag}", fused(*kv[:2]), fused(*kv[2:]))

    dead = (torch.arange(S_MAX, device="cuda")[None, :] >= lens[:, None]).reshape(-1)
    for hkv, g, d in ((HKV, G, D), (Z_H, 1, Z_D)):
        k, v = _rand(gen, (B, S_MAX, hkv, d), dtype), _rand(gen, (B, S_MAX, hkv, d), dtype)
        q = _rand(gen, (B, hkv * g, d), dtype)
        same_split(f"B={B} S={S_MAX} Hkv={hkv} G={g} D={d} K={K} {dtype}",
                   lambda k_, v_: kernel.splitk_partial_cuda(q, k_, v_, lens, k_splits=K),
                   lambda k_, v_: kernel.decode_attention_splitk_cuda(q, k_, v_, lens,
                                                                      k_splits=K),
                   _nan_rows(k, dead), _nan_rows(v, dead), k, v)
        del k, v
    kp, vp, tbl = paged_inputs(gen, lens_np, PAGE, dtype)
    live = torch.zeros(kp.shape[0] * PAGE, dtype=torch.bool, device="cuda")
    for b, n in enumerate(lens_np):
        pos = torch.arange(int(n), device="cuda")
        live[tbl[b, pos // PAGE].long() * PAGE + pos % PAGE] = True
    check(not bool(live[:PAGE].any()), "poison: the trash page holds live keys")
    q = _rand(gen, (B, HKV * G, D), dtype)
    same_split(f"paged pool={kp.shape[0]}x{PAGE} K={K} {dtype}",
               lambda k_, v_: kernel.paged_splitk_partial_cuda(q, k_, v_, tbl, lens, k_splits=K),
               lambda k_, v_: kernel.decode_attention_paged_splitk_cuda(q, k_, v_, tbl, lens,
                                                                        k_splits=K),
               _nan_rows(kp, ~live), _nan_rows(vp, ~live), kp, vp)

    # the single-stage decode, both dtypes: NaN past every length of the
    # cache (qwen3's heads over 1024 keys, zamba2's over 512) and in every
    # row of the recovery tier's pool not held below a length
    for dtype in (torch.bfloat16, torch.float32):
        for hkv, g, d, s_ in ((HKV, G, D, 1024), (Z_H, 1, Z_D, 512)):
            lens1 = torch.as_tensor([1, 127, 128, 129, 300, 511, 512, s_][:B], dtype=torch.int32,
                                    device="cuda")
            k, v = _rand(gen, (B, s_, hkv, d), dtype), _rand(gen, (B, s_, hkv, d), dtype)
            q = _rand(gen, (B, hkv * g, d), dtype)
            dead1 = (torch.arange(s_, device="cuda")[None, :] >= lens1[:, None]).reshape(-1)
            same(f"decode_attention B={B} S={s_} Hkv={hkv} G={g} D={d} {dtype}",
                 kernel.decode_attention_cuda(q, _nan_rows(k, dead1), _nan_rows(v, dead1), lens1),
                 kernel.decode_attention_cuda(q, k, v, lens1))
            del k, v
        tier_np = np.array([129, 384, 543])
        kp, vp, tbl = tier_inputs(gen, tier_np, dtype)
        live = torch.zeros(kp.shape[0] * PAGE, dtype=torch.bool, device="cuda")
        for b, n in enumerate(tier_np):
            pos = torch.arange(int(n), device="cuda")
            live[tbl[b, pos // PAGE].long() * PAGE + pos % PAGE] = True
        check(not bool(live[:PAGE].any()), "poison: the trash page holds live keys")
        q = _rand(gen, (TIER_B, TIER_HKV * TIER_G, TIER_D), dtype)
        lens1 = torch.as_tensor(tier_np, dtype=torch.int32, device="cuda")
        same(f"decode_attention_paged tier pool={kp.shape[0]}x{PAGE} {dtype}",
             kernel.decode_attention_paged_cuda(q, _nan_rows(kp, ~live), _nan_rows(vp, ~live),
                                                tbl, lens1),
             kernel.decode_attention_paged_cuda(q, kp, vp, tbl, lens1))

    # the fp32 mixed step's cluster kernel at Q 13 x G 2 = 26 rows (a full
    # and a partial 16-row block), cache lengths on its chunk edges: NaN past
    # every cache_len + Q of the cache read through the 2048-key window, and
    # in every row of the recovery tier's pool not held below cache_len + Q
    dtype, Q, W = torch.float32, 13, 2048
    k, v = _rand(gen, (B, S_MAX, HKV, D), dtype), _rand(gen, (B, S_MAX, HKV, D), dtype)
    qm = _rand(gen, (B, Q, HKV * G, D), dtype)
    cl = torch.tensor([0, 1024 - Q - 1, 1024 - 7, 1024, 1500, 2047 - Q, 1023, W - Q],
                      dtype=torch.int32, device="cuda")
    dead = (torch.arange(S_MAX, device="cuda")[None, :] >= (cl[:, None] + Q)).reshape(-1)
    kn, vn = _nan_rows(k, dead), _nan_rows(v, dead)
    clean = kernel.mixed_attention_cuda(qm, k[:, :W], v[:, :W], cl)
    same(f"mixed_attention fp32 B={B} Q={Q} window={W} repeat",
         kernel.mixed_attention_cuda(qm, k[:, :W], v[:, :W], cl), clean)
    same(f"mixed_attention fp32 B={B} Q={Q} window={W}",
         kernel.mixed_attention_cuda(qm, kn[:, :W], vn[:, :W], cl), clean)
    del k, v, kn, vn
    tq, tier_np = 8, np.array([120, 255 - 8, 536])
    kp, vp, tbl = tier_inputs(gen, tier_np + tq, dtype)
    live = torch.zeros(kp.shape[0] * PAGE, dtype=torch.bool, device="cuda")
    for b, n in enumerate(tier_np + tq):
        pos = torch.arange(int(n), device="cuda")
        live[tbl[b, pos // PAGE].long() * PAGE + pos % PAGE] = True
    check(not bool(live[:PAGE].any()), "poison: the trash page holds live keys")
    q = _rand(gen, (TIER_B, tq, TIER_HKV * TIER_G, TIER_D), dtype)
    cl = torch.as_tensor(tier_np, dtype=torch.int32, device="cuda")
    same(f"mixed_attention_paged fp32 tier pool={kp.shape[0]}x{PAGE}",
         kernel.mixed_attention_paged_cuda(q, _nan_rows(kp, ~live), _nan_rows(vp, ~live), tbl, cl),
         kernel.mixed_attention_paged_cuda(q, kp, vp, tbl, cl))
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


class RecordingDrafter:
    """The engine's drafter, recording every call's history length, the
    history's first 8 tokens and the drafts: after a greedy run, a request's
    stream says how many of each call's drafts were accepted (the verifier
    accepts a draft iff it is the token the stream goes on with)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def propose(self, context, k):
        out = self.inner.propose(context, k)
        self.calls.append((len(context), tuple(context[:8]), out))
        return out


def make_engine_class():
    from repro_torch.serving import ServingEngine

    class CheckedEngine(ServingEngine):
        """Counts non-finite logits on the device, with no host sync; records
        the drafter's calls and, per verify step, the host seconds issuing
        it and a pair of CUDA events around it (``verify_steps``)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)
            self.drafter = RecordingDrafter(self.drafter)
            self.verify_steps = []

        def _sample(self, logits, generator=None):
            self.nonfinite += (~torch.isfinite(logits)).sum()
            return super()._sample(logits, generator)

        def _verify(self, logits, drafts, generator):
            self.nonfinite += (~torch.isfinite(logits)).sum()
            return super()._verify(logits, drafts, generator)

        def _spec_call(self, st, Qs, aw):
            cuda = self.device.type == "cuda"
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
            t0 = time.perf_counter()
            if cuda:
                ev[0].record()
            out = super()._spec_call(st, Qs, aw)
            if cuda:
                ev[1].record()
            self.verify_steps.append((time.perf_counter() - t0, ev))
            return out

    return CheckedEngine


def warm_graphs(engine, label: str) -> dict:
    """Capture the engine's mixed-step grid, its verify-step grid (at
    ``spec_k`` > 0) and the decode chunk ahead of the clock, into the state
    its next session takes; prints the capture time,
    the graph count and the graph pool's memory on a line of their own."""
    t0 = time.perf_counter()
    buckets = engine.warm_mixed_traces([engine.cfg.prefill_chunk])
    spec = engine.warm_spec_traces([engine.cfg.spec_k])
    engine.warm_decode()
    torch.cuda.synchronize()
    g = engine._graphs
    out = dict(capture_s=time.perf_counter() - t0, graphs=g.captured, mixed_buckets=buckets,
               spec_buckets=spec, graph_pool_gb=g.pool_bytes() / 1e9)
    print(f"  {label}: captured {g.captured} graphs ({buckets} mixed, {spec} verify buckets) "
          f"in {out['capture_s']:.2f} s, graph pool {out['graph_pool_gb']:.3f} GB", flush=True)
    return out


def serve(model, ecfg, prompts, max_new, device, *, graphs=None, label="serve"):
    """Serve ``prompts`` through EngineClient; returns (handles, wall_s,
    engine).  On the card the steps run as CUDA graphs unless ``graphs`` is
    False, captured before the clock starts (``engine.capture`` holds what
    ``warm_graphs`` measured); launch counters are zeroed after the capture."""
    from repro_torch.serving import EngineClient, InferenceRequest

    engine = make_engine_class()(model, ecfg, device=device, graphs=graphs)
    engine.capture = warm_graphs(engine, label) if engine.graphs else None
    engine.verify_steps = []
    reset_launches()
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


def phase_serve(name_line: str, model, *, paged: bool, legacy: bool = False,
                graphs=None) -> dict:
    """Phase 4 (contiguous) or 4b (paged) over the full-width model, or
    with ``legacy`` 4c / 4d through the legacy (mixed_step=False) admission;
    with ``graphs=False`` its steps run eagerly (``serve_ab.py``)."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    dev = model.device
    ecfg = EngineConfig(paged_kv=paged, mixed_step=not legacy)
    label = ("serve legacy" if legacy else "serve") + (" paged" if paged else "")
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator, the eager prefill) outside the counted run
    serve(model, ecfg, prompts_for(rng, 2, 16, 64, cfg.vocab_size), 4, dev, graphs=False)
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
    handles, wall, engine = serve(model, ecfg, prompts, max_new, dev, graphs=graphs, label=label)
    launches = read_launches()
    check_handles(handles, engine, max_new, cfg.vocab_size, label)
    tel = engine.telemetry
    split = "decode_attention_paged_splitk" if paged else "decode_attention_splitk"
    if paged:
        path = ("mixed_attention_paged", split)
        for k_ in ("decode_attention", "decode_attention_splitk", "mixed_attention"):
            check(launches[k_] == 0, f"{label}: contiguous kernel {k_} launched")
    else:
        path = (split,) if legacy else (split, "mixed_attention")
    # one split-K launch per layer per decode step, and the chunk states
    # alone never
    check_decode_launches(launches, engine, cfg.n_layers, split, label)
    for k_ in ("decode_attention_splitk_partial", "decode_attention_paged_splitk_partial"):
        check(launches[k_] == 0, f"{label}: {k_} launched on its own")
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
        capture=engine.capture, card=name_line,
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


# a served max_len below ops' split-K threshold (2048 keys): every decode
# step of every layer runs the single-stage cluster kernel
SINGLE_MAX_LEN = 1536


def check_decode_launches(launches: dict, engine, layers: int, name: str, label: str) -> None:
    """One ``name`` launch per layer per decode step: the engine's decode
    chunks times ``decode_chunk`` steps each."""
    steps = engine.telemetry.chunks * max(1, engine.cfg.decode_chunk)
    check(launches[name] == layers * steps,
          f"{label}: {launches[name]} {name} launches for {steps} decode steps of "
          f"{layers} layers")


def phase_serve_single(name_line: str, model, *, paged: bool, graphs=None) -> dict:
    """Phase 4j (contiguous) or 4k (paged): the full-width bf16 model at
    EngineConfig(max_len=1536), mixed admission: 8 requests, prompts
    16..1400 tokens, 32 new tokens each.  Prefill runs the mixed step;
    every decode step of every layer runs the single-stage decode, whose
    launches are held to their exact number; no other kernel may launch.
    With ``graphs=False`` its steps run eagerly (``serve_ab.py``)."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    dev = model.device
    ecfg = EngineConfig(max_len=SINGLE_MAX_LEN, paged_kv=paged)
    label = "serve single-stage" + (" paged" if paged else "")
    rng = np.random.default_rng(2)
    serve(model, ecfg, prompts_for(rng, 2, 16, 64, cfg.vocab_size), 4, dev,   # warm-up
          graphs=False)
    free_memory()
    prompts = prompts_for(rng, 8, 16, 1400, cfg.vocab_size)
    max_new = 32
    handles, wall, engine = serve(model, ecfg, prompts, max_new, dev, graphs=graphs, label=label)
    launches = read_launches()
    check_handles(handles, engine, max_new, cfg.vocab_size, label)
    ttft = np.array([h.record.ttft_s for h in handles])
    decode, mixed = (("decode_attention_paged", "mixed_attention_paged") if paged
                     else ("decode_attention", "mixed_attention"))
    check_decode_launches(launches, engine, cfg.n_layers, decode, label)
    check(launches[mixed] > 0, f"{label}: kernel {mixed} never launched on the main path")
    for k_, n in launches.items():
        check(k_ in (decode, mixed) or n == 0, f"{label}: kernel {k_} launched {n} times")
    tel = engine.telemetry
    if paged:
        al = handles[0]._client.session.allocator
        check(al.live_pages == 0, f"{label}: {al.live_pages} pages still live after the drain")
    return dict(requests=len(handles), layers=cfg.n_layers, dtype=cfg.dtype,
                max_len=ecfg.max_len, max_new=max_new,
                prompt_tokens=int(sum(len(p) for p in prompts)),
                generated_tokens=int(sum(len(h.result()) for h in handles)),
                wall_s=wall, tokens_per_s=sum(len(h.result()) for h in handles) / wall,
                ttft_p50_s=float(np.percentile(ttft, 50)),
                ttft_p99_s=float(np.percentile(ttft, 99)),
                mixed_steps=tel.mixed_steps, decode_chunks=tel.chunks,
                decode_chunk=ecfg.decode_chunk, launches=launches, capture=engine.capture,
                card=name_line)


SPEC_K = 4
DECODE_KERNELS = ("decode_attention", "decode_attention_splitk", "decode_attention_paged",
                  "decode_attention_paged_splitk", "decode_attention_splitk_partial",
                  "decode_attention_paged_splitk_partial")


def periodic_prompts(rng, n, lo, hi, vocab, period=24):
    """``n`` prompts of ``lo``..``hi`` tokens, each a random ``period``-token
    motif repeated: prompt lookup finds a match in every one."""
    out = []
    for L in np.linspace(lo, hi, n).round().astype(int):
        motif = rng.integers(0, vocab, period)
        out.append(np.tile(motif, -(-L // period))[:L])
    return out


def interleave(a, b):
    return [p for pair in zip(a, b) for p in pair]


def acceptance_by_request(engine, prompts, streams) -> tuple:
    """Drafted and accepted tokens per request, from the recorded drafter
    calls and the greedy streams: a call at history length L for a prompt
    of length P drafted after stream position L - P - 1 (its carry), and
    its accepted drafts are the longest prefix the stream goes on with."""
    index = {tuple(int(t) for t in p[:8]): i for i, p in enumerate(prompts)}
    check(len(index) == len(prompts), "two prompts share their first 8 tokens")
    drafted, accepted = np.zeros(len(prompts), int), np.zeros(len(prompts), int)
    for L, head, drafts in engine.drafter.calls:
        i = index[head]
        pos = L - len(prompts[i]) - 1
        nxt = list(streams[i][pos + 1:pos + 1 + len(drafts)])
        a = 0
        while a < len(nxt) and drafts[a] == nxt[a]:
            a += 1
        drafted[i] += len(drafts)
        accepted[i] += a
    tel = engine.telemetry
    check(int(drafted.sum()) == tel.drafted_tokens and int(accepted.sum()) == tel.accepted_tokens,
          f"drafter calls give {drafted.sum()} drafted / {accepted.sum()} accepted, telemetry "
          f"{tel.drafted_tokens} / {tel.accepted_tokens}")
    return drafted, accepted


def check_spec_launches(launches: dict, engine, layers: int, label: str, *, paged: bool) -> int:
    """A speculating session launches the mixed-step kernel once a layer
    for every mixed step and every verify step, and no decode kernel (the
    rounds replace the decode chunk).  Returns the verify steps."""
    mixed = "mixed_attention_paged" if paged else "mixed_attention"
    steps = len(engine.verify_steps)
    tel = engine.telemetry
    check(steps > 0 and tel.spec_rounds > 0, f"{label}: {steps} verify steps, "
                                             f"{tel.spec_rounds} spec rounds")
    check(tel.spec_rounds <= steps, f"{label}: {tel.spec_rounds} spec rounds > {steps} steps")
    check(launches[mixed] == layers * (tel.mixed_steps + steps),
          f"{label}: {launches[mixed]} {mixed} launches for {tel.mixed_steps} mixed and "
          f"{steps} verify steps of {layers} layers")
    for k_, n in launches.items():
        check(k_ == mixed or n == 0, f"{label}: kernel {k_} launched {n} times")
    check(tel.accepted_tokens <= tel.drafted_tokens,
          f"{label}: {tel.accepted_tokens} accepted of {tel.drafted_tokens} drafted")
    return steps


def phase_serve_spec(name_line: str, model, *, paged: bool) -> dict:
    """Phase 4l (contiguous) or 4m (paged): the full-width bf16 model at the
    default EngineConfig with ``spec_k`` = 4 (verify steps of 8 columns),
    mixed admission: 16 requests of 64 new tokens, 8 random prompts of
    16..2000 tokens interleaved with 8 periodic ones (a 24-token motif
    repeated to 64..1024 tokens).  The mixed, verify and decode-chunk
    graphs are captured before the clock.  A round's wall splits into the
    drafter's host time, the host's time issuing the verify step (a graph
    replay) and the rest (the wait for the step and its verdict, and the
    host's walk of it); CUDA events around each verify step give its
    device time.  The same traffic is then served with speculation off
    (``spec_off``: the decode chunk in place of the rounds)."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    dev = model.device
    ecfg = EngineConfig(paged_kv=paged, spec_k=SPEC_K)
    label = "serve spec" + (" paged" if paged else "")
    rng = np.random.default_rng(9)
    serve(model, ecfg, prompts_for(rng, 2, 16, 64, cfg.vocab_size), 4, dev,   # warm-up
          graphs=False)
    free_memory()
    random_half = prompts_for(rng, 8, 16, 2000, cfg.vocab_size)
    periodic_half = periodic_prompts(rng, 8, 64, 1024, cfg.vocab_size)
    prompts = interleave(random_half, periodic_half)
    periodic = np.arange(len(prompts)) % 2 == 1
    max_new = 64
    handles, wall, engine = serve(model, ecfg, prompts, max_new, dev, label=label)
    launches = read_launches()
    check_handles(handles, engine, max_new, cfg.vocab_size, label)
    tel = engine.telemetry
    check(tel.useful_tokens == max_new * len(prompts),
          f"{label}: useful_tokens {tel.useful_tokens}, not {max_new * len(prompts)}")
    steps = check_spec_launches(launches, engine, cfg.n_layers, label, paged=paged)
    streams = [h.result() for h in handles]
    drafted, accepted = acceptance_by_request(engine, prompts, streams)
    host_launch_s = sum(h for h, _ in engine.verify_steps)
    device_s = sum(ev[0].elapsed_time(ev[1]) for _, ev in engine.verify_steps) / 1e3
    rest_s = tel.spec_s - tel.draft_s - host_launch_s
    ttft = np.array([h.record.ttft_s for h in handles])
    out = dict(
        requests=len(handles), layers=cfg.n_layers, dtype=cfg.dtype, spec_k=SPEC_K,
        max_new=max_new, prompt_tokens=int(sum(len(p) for p in prompts)),
        generated_tokens=int(sum(len(t) for t in streams)), wall_s=wall,
        tokens_per_s=sum(len(t) for t in streams) / wall,
        ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p99_s=float(np.percentile(ttft, 99)),
        mixed_steps=tel.mixed_steps, verify_steps=steps, spec_rounds=tel.spec_rounds,
        drafted_tokens=tel.drafted_tokens, accepted_tokens=tel.accepted_tokens,
        accept_rate=tel.spec_accept_rate,
        accept_rate_periodic=float(accepted[periodic].sum() / max(1, drafted[periodic].sum())),
        accept_rate_random=float(accepted[~periodic].sum() / max(1, drafted[~periodic].sum())),
        drafted_periodic=int(drafted[periodic].sum()), drafted_random=int(drafted[~periodic].sum()),
        spec_s=tel.spec_s, draft_s=tel.draft_s, verify_launch_s=host_launch_s,
        verify_device_s=device_s, verify_wait_and_walk_s=rest_s,
        round_ms=1e3 * tel.spec_s / steps,
        round_share=dict(draft=tel.draft_s / tel.spec_s, launch=host_launch_s / tel.spec_s,
                         wait_and_walk=rest_s / tel.spec_s, device=device_s / tel.spec_s),
        launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        capture=engine.capture, card=name_line)
    if paged:
        al = handles[0]._client.session.allocator
        check(al.live_pages == 0, f"{label}: {al.live_pages} pages still live after the drain")
        out.update(live_pages=al.live_pages, misses=al.stats.misses)
    del handles
    free_memory()
    off_h, off_wall, off_eng = serve(model, dataclasses.replace(ecfg, spec_k=0), prompts,
                                     max_new, dev, label=label + " off")
    check_handles(off_h, off_eng, max_new, cfg.vocab_size, label + " off")
    off_ttft = np.array([h.record.ttft_s for h in off_h])
    out["spec_off"] = dict(
        wall_s=off_wall, tokens_per_s=sum(len(h.result()) for h in off_h) / off_wall,
        ttft_p50_s=float(np.percentile(off_ttft, 50)),
        ttft_p99_s=float(np.percentile(off_ttft, 99)),
        mixed_steps=off_eng.telemetry.mixed_steps, decode_chunks=off_eng.telemetry.chunks,
        streams_equal_to_spec=int(sum(np.array_equal(a, h.result())
                                      for a, h in zip(streams, off_h))))
    return out


def phase_generate(name_line: str, model) -> dict:
    """Phase 4e: ServingEngine.generate at B=8, prompt 512, 32 steps."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    B_, plen, steps = 8, 512, 32
    engine = make_engine_class()(model, EngineConfig(), device=model.device)
    rng = np.random.default_rng(4)
    capture = warm_generate(engine, B_, steps, "generate")
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
    check(launches["decode_attention_splitk"] == cfg.n_layers * steps,
          f"generate: {launches['decode_attention_splitk']} split-K launches for {steps} steps "
          f"of {cfg.n_layers} layers")
    check(launches["decode_attention_splitk_partial"] == 0, "generate: a partial-only launch")
    return dict(batch=B_, prompt_len=plen, steps=steps, layers=cfg.n_layers, dtype=cfg.dtype,
                wall_s=wall, tokens_per_s=B_ * steps / wall, launches=launches,
                capture=capture, card=name_line)


def warm_generate(engine, B_: int, steps: int, label: str) -> dict:
    """A ``generate`` call of the timed call's batch and steps on a short
    prompt: it captures the decode loop's graph, which the timed call
    replays (the graph does not depend on the prompt's length)."""
    t0 = time.perf_counter()
    engine.generate({"inputs": np.zeros((B_, 16), np.int64)}, steps, 16)
    torch.cuda.synchronize()
    g = engine._graphs
    out = dict(capture_s=time.perf_counter() - t0, graphs=g.captured,
               graph_pool_gb=g.pool_bytes() / 1e9)
    print(f"  {label}: captured {g.captured} graph in {out['capture_s']:.2f} s (with its "
          f"prefill), graph pool {out['graph_pool_gb']:.3f} GB", flush=True)
    return out


def _logits_at(model, tokens) -> torch.Tensor:
    """The (V,) logits after ``tokens`` (one B=1 mixed step, or a B=1
    prefill for a model without a mixed step)."""
    t = torch.as_tensor(np.asarray(tokens)[None], device=model.device)
    if model.supports_mixed_step:
        cache = model.empty_cache(1, len(tokens) + 1)
        return model.step_mixed(t, cache, np.array([0]), np.array([len(tokens)]))[0]
    return model.prefill(t)[0][0]


def _margin(model, tokens, a: int, b: int) -> float:
    """|logit(a) - logit(b)| after ``tokens``."""
    logits = _logits_at(model, tokens)
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
    card_h, card_wall, card_eng = serve(card_model, ecfg, prompts, max_new, torch.device("cuda"),
                                        label=label)
    launches = read_launches()
    for k_ in (("decode_attention_paged", "mixed_attention_paged") if paged
               else ("decode_attention", "mixed_attention")):
        check(launches[k_] > 0, f"{label}: kernel {k_} never launched")
    check_decode_launches(launches, card_eng, cfg.n_layers,
                          "decode_attention_paged" if paged else "decode_attention", label)
    eager = captured_vs_eager(label, card_model, ecfg, prompts, max_new, card_h, launches)
    cpu_h, cpu_wall, cpu_eng = serve(cpu_model, ecfg, prompts, max_new, torch.device("cpu"))
    check_handles(card_h, card_eng, max_new, cfg.vocab_size, f"{label} card fp32")
    check_handles(cpu_h, cpu_eng, max_new, cfg.vocab_size, f"{label} cpu fp32")
    exact, ties = compare_streams(prompts, [h.result() for h in card_h],
                                  [h.result() for h in cpu_h], card_model, cpu_model,
                                  ("card", "cpu"))
    out = dict(requests=len(prompts), exact_streams=exact, near_ties=ties, layers=cfg.n_layers,
               dtype=cfg.dtype, max_len=ecfg.max_len, launches=launches,
               card_wall_s=card_wall, cpu_wall_s=cpu_wall, eager=eager)
    if paged:
        sts = [h[0]._client.session.allocator.stats for h in (card_h, cpu_h)]
        check(sts[0] == sts[1], f"{label}: card and cpu prefix stats differ: {sts}")
        check(sts[0].full_hits >= 1 and sts[0].prefix_hits >= 1,
              f"{label}: no full or prefix hit: {sts[0]}")
        out.update(full_hits=sts[0].full_hits, prefix_hits=sts[0].prefix_hits,
                   cow_copies=sts[0].cow_copies)
    return out, prompts, [h.result() for h in card_h]


def captured_vs_eager(label, model, ecfg, prompts, max_new, handles, launches) -> dict:
    """Phase 5f's check of one run through captured steps (``handles``,
    ``launches``): the same traffic on the card with ``graphs=False`` must
    give the same streams token for token and the same launch counts."""
    eh, wall, engine = serve(model, ecfg, prompts, max_new, torch.device("cuda"), graphs=False)
    eager_launches = read_launches()
    check_handles(eh, engine, max_new, model.cfg.vocab_size, f"{label} eager")
    exact = sum(np.array_equal(a.result(), b.result()) for a, b in zip(handles, eh))
    check(exact == len(prompts),
          f"{label}: {len(prompts) - exact} of {len(prompts)} captured streams differ from eager")
    check(eager_launches == launches,
          f"{label}: launches captured {launches} differ from eager {eager_launches}")
    return dict(requests=len(prompts), exact_streams=exact, launches_equal=True,
                eager_wall_s=wall)


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
        handles, wall, engine = serve(card_model, ecfg, prompts, 32, card,
                                      label=f"legacy vs mixed {key}")
        launches = read_launches()
        check_handles(handles, engine, 32, cfg.vocab_size, f"legacy vs mixed {key}")
        check(launches["flash_attention"] > 0, f"legacy vs mixed {key}: no flash launch")
        exact, ties = compare_streams(prompts, [h.result() for h in handles], mixed_streams,
                                      card_model, card_model, ("legacy", "mixed"))
        out[key] = dict(requests=len(prompts), exact_streams=exact, near_ties=ties,
                        wall_s=wall, prefills=engine.telemetry.prefills, launches=launches,
                        eager=captured_vs_eager(f"legacy {key}", card_model, ecfg, prompts, 32,
                                                handles, launches))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 64))
    gens, runs = [], {}
    for model, graphs in ((card_model, True), (card_model, False), (cpu_model, False)):
        engine = make_engine_class()(model, EngineConfig(max_len=1024), device=model.device,
                                     graphs=graphs)
        reset_launches()
        gens.append(engine.generate({"inputs": toks}, 16, 64))
        if model is card_model:
            runs[graphs] = read_launches()
    exact, ties = compare_streams([list(t) for t in toks], gens[0], gens[2], card_model,
                                  cpu_model, ("card", "cpu"))
    check(np.array_equal(gens[0], gens[1]), "generate: captured and eager streams differ")
    check(runs[True] == runs[False],
          f"generate: launches captured {runs[True]} differ from eager {runs[False]}")
    out["generate"] = dict(batch=4, prompt_len=64, steps=16, exact_streams=exact,
                           near_ties=ties, launches=runs[True],
                           eager=dict(requests=4, exact_streams=4, launches_equal=True))
    return out


def phase_stale_buffers(card_model) -> dict:
    """Phase 5g: a replay reads its step buffers as they stand.  On one
    captured and one eager (``graphs=False``) engine over the same fp32
    model, both layouts: a mixed step of one (Q, window) bucket at one set
    of lengths, flags, chunk tokens and block tables (the captured engine's
    first call, then its capture), then the same bucket at another set (a
    replay); then the decode chunk likewise.  Every replay must give the
    eager engine's result at the new values, bit for bit."""
    from repro_torch.serving import EngineConfig

    card = torch.device("cuda")
    cfg = card_model.cfg
    rng = np.random.default_rng(7)
    B, out = 4, {}
    for paged in (False, True):
        ecfg = EngineConfig(max_len=1024, decode_batch=B, paged_kv=paged, prefill_chunk=32)
        engines = [make_engine_class()(card_model, ecfg, device=card, graphs=g)
                   for g in (True, False)]
        Q, nb = engines[0].chunk_quantum(ecfg.prefill_chunk), engines[0].max_blocks
        calls = []
        for _ in range(2):
            lens = rng.integers(0, 600, B)
            dec = rng.integers(0, 2, B)
            new = np.where(dec == 1, 1, rng.integers(0, Q + 1, B))
            pages = rng.permutation(np.arange(1, engines[0].num_pages))[:B * nb]
            calls.append(dict(lens=lens, new=new, dec=dec, upd=dec | (new > 0),
                              chunks=rng.integers(0, cfg.vocab_size, (B, Q)),
                              tables=pages.reshape(B, nb)))
        results = []
        for eng in engines:
            st, got = eng._session_state(), []
            for c in calls:
                st.stage(c["lens"], c["new"], c["dec"], c["upd"], c["tables"])
                st.chunk(Q).fill(c["chunks"])
                logits, nxt = eng._mixed_call(st, Q, ecfg.max_len)
                got += [logits.clone(), nxt.clone()]
            for c in calls:
                zero = np.zeros(B)
                st.stage(c["lens"], zero, c["dec"], zero, c["tables"])
                got += [eng._decode_call(st, ecfg.decode_chunk).clone(), st.tok.clone()]
            results.append(got)
        key = "paged" if paged else "contiguous"
        errs = [_err(a.float(), b.float()) for a, b in zip(*results)]
        for i, (a, b) in enumerate(zip(*results)):
            check(torch.equal(a, b), f"stale buffers {key}: output {i} of the captured engine "
                                     f"differs from eager (max abs err {errs[i]:.3e})")
        check(not torch.equal(results[0][0], results[0][2]),
              f"stale buffers {key}: the two mixed steps' inputs gave one result")
        out[key] = dict(outputs=len(errs), max_abs_err=max(errs),
                        graphs=engines[0]._graphs.captured)
    return out


def phase_spec_card_vs_cpu(small_cfg) -> dict:
    """Phase 5h: phase 5's 4-layer fp32 qwen3 (max_len 1024) at a 16-token
    vocabulary, so that greedy streams loop and drafts are accepted: 3
    random prompts (16..300 tokens) and 3 periodic ones (48..300), 32 new
    tokens each, contiguous and paged, at ``spec_k`` 1, 4 and 8 (verify
    steps of 2, 8 and 16 columns).  On the card every speculating stream
    must equal spec off, and the CPU's speculating stream (near-ties under
    ``NEAR_TIE`` printed with their margins); accepted > 0; each captured
    run is held to its ``graphs=False`` twin (streams and launches)."""
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig

    cfg = dataclasses.replace(small_cfg, vocab_size=16)
    cpu_model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(3))
    card_model = Model(cfg, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    card, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng(8)
    prompts = interleave(prompts_for(rng, 3, 16, 300, cfg.vocab_size),
                         periodic_prompts(rng, 3, 48, 300, cfg.vocab_size))
    max_new = 32
    out = {}
    for paged in (False, True):
        layout = "paged" if paged else "contiguous"
        base = EngineConfig(max_len=1024, paged_kv=paged)
        off_h, _, off_eng = serve(card_model, base, prompts, max_new, card,
                                  label=f"spec 5h {layout} off")
        check_handles(off_h, off_eng, max_new, cfg.vocab_size, f"spec 5h {layout} off")
        plain = [h.result() for h in off_h]
        for k in (1, 4, 8):
            label = f"spec 5h {layout} k={k}"
            ecfg = dataclasses.replace(base, spec_k=k)
            handles, wall, engine = serve(card_model, ecfg, prompts, max_new, card, label=label)
            launches = read_launches()
            check_handles(handles, engine, max_new, cfg.vocab_size, label)
            steps = check_spec_launches(launches, engine, cfg.n_layers, label, paged=paged)
            tel = engine.telemetry
            check(tel.accepted_tokens > 0, f"{label}: no draft accepted")
            streams = [h.result() for h in handles]
            exact_off, ties_off = compare_streams(prompts, streams, plain, card_model, card_model,
                                                  ("spec", "plain"))
            eager = captured_vs_eager(label, card_model, ecfg, prompts, max_new, handles,
                                      launches)
            cpu_h, cpu_wall, cpu_eng = serve(cpu_model, ecfg, prompts, max_new, cpu)
            check_handles(cpu_h, cpu_eng, max_new, cfg.vocab_size, f"{label} cpu")
            exact_cpu, ties_cpu = compare_streams(prompts, streams, [h.result() for h in cpu_h],
                                                  card_model, cpu_model, ("card", "cpu"))
            if paged:
                al = handles[0]._client.session.allocator
                check(al.live_pages == 0, f"{label}: {al.live_pages} pages live after the drain")
            out[f"{layout}_k{k}"] = dict(
                requests=len(prompts), spec_k=k, exact_vs_spec_off=exact_off,
                near_ties_vs_spec_off=ties_off, exact_vs_cpu=exact_cpu,
                near_ties_vs_cpu=ties_cpu, verify_steps=steps, spec_rounds=tel.spec_rounds,
                drafted_tokens=tel.drafted_tokens, accepted_tokens=tel.accepted_tokens,
                cpu_accepted_tokens=cpu_eng.telemetry.accepted_tokens, launches=launches,
                card_wall_s=wall, cpu_wall_s=cpu_wall, eager=eager)
            free_memory()
    return out


def expected_scan_launches(cfg, prefills: int, steps: int, max_len: int) -> dict:
    """Every kernel launch a scan-state model must make for ``prefills``
    B-row prefills and ``steps`` decode steps, by name (any kernel not
    named must not launch): rwkv6 one WKV6 launch per layer per prefill;
    the hybrid one SSD launch per Mamba-2 layer and one flash launch per
    shared application per prefill, one decode launch (the one-launch
    split-K decode at a max_len that splits) per application per step, and per forward pass
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
        out["decode_attention_splitk"] = G * steps
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
    serve(model, ecfg, prompts_for(rng, 2, 16, 64, cfg.vocab_size), 4, dev,     # warm-up
          graphs=False)
    free_memory()
    prompts = prompts_for(rng, 16, 16, 2000, cfg.vocab_size)
    max_new = 32
    torch.cuda.reset_peak_memory_stats()
    handles, wall, engine = serve(model, ecfg, prompts, max_new, dev, label=label)
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
        capture=engine.capture, card=name_line)
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
    capture = warm_generate(engine, B_, steps, label)
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
                wall_s=wall, tokens_per_s=B_ * steps / wall, launches=launches,
                capture=capture, card=name_line)


def phase_scan_card_vs_cpu(cfg, n_layers: int) -> tuple:
    """Phases 5d (rwkv6-7b, 2 layers) and 5e (zamba2-2.7b, 12 layers: two
    shared applications): full width cut to ``n_layers``, fp32, on the card
    and on the CPU: 6 requests through a 2-slot session (slots reused);
    then decode after prefill(300) against prefill(301) on the card.
    Returns the summary and the CPU and card models (phase 5i's)."""
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
    card_h, card_wall, card_eng = serve(card_model, ecfg, prompts, max_new, torch.device("cuda"),
                                        label=label)
    launches = read_launches()
    tel = card_eng.telemetry
    check_launches(launches, expected_scan_launches(
        small, tel.prefills, tel.chunks * ecfg.decode_chunk, ecfg.max_len), label)
    eager = captured_vs_eager(label, card_model, ecfg, prompts, max_new, card_h, launches)
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
                decode_vs_prefill_max_abs_err=err, eager=eager), cpu_model, card_model


# --------------------------------------------------------------------------
# phases 4n, 4o, 5i: durable KV (frontiers out of a session and back)
# --------------------------------------------------------------------------

# 4n's prefill budget: a q-chunk of 128 tokens a slot, so the 2000-token
# prompt is ingested in 16 mixed steps, before the shortest request's 32
# tokens are out, and all 8 requests decode at once when the session dies
DURABLE_BUDGET = 1024


def _sync_s(fn):
    """(fn()'s result, its seconds on the host clock, the card drained
    before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _timed_restores(session) -> dict:
    """Time every ``_admit_restored`` call of ``session`` (the card drained
    before and after): rid -> ms."""
    admit, times = session._admit_restored, {}

    def timed(s, rid, fr, max_new):
        ok, sec = _sync_s(lambda: admit(s, rid, fr, max_new))
        if ok:
            times[rid] = sec * 1e3
        return ok

    session._admit_restored = timed
    return times


def extract_timed(session, rid: int) -> tuple:
    """``extract_frontier(rid)`` timed whole, then its parts again on the
    same pages or slot: the gather on the card, the copy to the host, the
    host cast (bf16 to float32), each drained; the parts' result must equal
    the frontier's payload bit for bit.  Returns (frontier, a row)."""
    from repro_torch.serving import engine as engine_mod

    fr, total = _sync_s(lambda: session.extract_frontier(rid))
    if session.paged:
        pages = session._slot_pages[session._slot_of[rid]][
            :session.allocator.blocks_for(fr.tokens)]
        payload = fr.pages_kv
        gathered, gather = _sync_s(lambda: session.eng.gather_pages(session.cache, pages))
    else:
        s = int(np.nonzero(session.slots.request_id == rid)[0][0])
        payload = fr.state
        gathered, gather = _sync_s(lambda: [leaf[:, s:s + 1] for leaf in session.cache])
    host, copy = _sync_s(lambda: engine_mod.to_host(gathered))
    cast, host_cast = _sync_s(lambda: engine_mod.host_cast(host))
    check(all(np.array_equal(a, b) for a, b in zip(cast, payload)),
          f"extract {rid}: the timed parts differ from the frontier's payload")
    row = dict(rid=rid, tokens=fr.tokens, generated=len(fr.generated),
               device_bytes=sum(t.numel() * t.element_size() for t in gathered),
               host_bytes=sum(a.nbytes for a in payload), extract_ms=total * 1e3,
               gather_ms=gather * 1e3, copy_ms=copy * 1e3, host_cast_ms=host_cast * 1e3)
    return fr, row


def inject_roundtrip(session, fr, rid: int) -> int:
    """A paged frontier injected into a second pool: its pages there must
    be bit-equal to the session's below the frontier.  Returns the
    positions compared."""
    pages = session._slot_pages[session._slot_of[rid]][:session.allocator.blocks_for(fr.tokens)]
    pool = session.eng.model.empty_page_pool(len(pages) + 1, fr.page_size)
    session.eng._inject_pages(pool, fr.pages_kv, range(1, len(pages) + 1))
    n = fr.tokens
    for a, b in zip(session.cache, pool):
        a = a[:, pages].flatten(1, 2)[:, :n]
        b = b[:, 1:].flatten(1, 2)[:, :n]
        check(torch.equal(a, b), f"inject round trip of request {rid} ({a.dtype}): not bit-equal "
                                 f"below its frontier (max abs err {_err(a.float(), b.float()):.3e})")
    return n


def restore_checks(label, results, frontiers, max_new, reports, vocab) -> dict:
    """Every restored request has its ``max_new`` tokens, starting with its
    frontier's; no prefill was recomputed; the recovered tokens are the
    frontiers' tokens (summed over the restored session's reports)."""
    for rid, fr in frontiers.items():
        toks = results[rid]
        check(len(toks) == max_new, f"{label}: request {rid} got {len(toks)} tokens")
        check(list(toks[:len(fr.generated)]) == list(fr.generated),
              f"{label}: request {rid}'s stream does not start with its frontier's tokens")
        check(bool(((toks >= 0) & (toks < vocab)).all()), f"{label}: out-of-vocab token")
    recovered = sum(r.recovered_tokens for r in reports)
    recomputed = sum(r.recomputed_prefill_tokens for r in reports)
    want = sum(fr.tokens for fr in frontiers.values())
    check(recomputed == 0, f"{label}: {recomputed} prefill tokens recomputed")
    check(recovered == want, f"{label}: {recovered} tokens recovered, the frontiers hold {want}")
    return dict(restored=len(frontiers), recovered_tokens=recovered,
                recomputed_prefill_tokens=recomputed)


def _pump_all(session) -> list:
    reports = []
    while not session.idle:
        reports.append(session.pump())
    return reports


def _rewarm(engine) -> None:
    """Capture the next session's graphs before it admits anything."""
    if engine.graphs:
        engine.warm_mixed_traces([engine.cfg.prefill_chunk])
        engine.warm_decode()


def phase_durable_kv(name_line: str, model) -> dict:
    """Phase 4n: durable KV on full-width bf16 qwen3-0.6b, paged, mixed
    admission (``EngineConfig(paged_kv=True, prefill_chunk=1024)``): 8
    requests, prompts 16..2000, 32 new tokens; after the pump in which
    every slot decodes, ``extract_frontiers()`` (each timed: the gather,
    the copy, the host cast), one frontier injected into a second pool
    (bit-equal below its frontier), the session killed (every request
    cancelled); a fresh session of the same engine, its graphs captured
    first, takes them with ``frontier=`` (each ``_admit_restored`` timed)
    and drains: every request its 32 tokens starting with its frontier's,
    zero prefill, the recovered tokens the frontiers', zero live pages, and
    only the paged split-K decode launched (layers x decode steps).  Then
    each prompt alone on the drained session: its re-prefill (the mixed
    steps and one decode chunk, to the first token)."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    ecfg = EngineConfig(paged_kv=True, prefill_chunk=DURABLE_BUDGET)
    label = "durable kv"
    engine = make_engine_class()(model, ecfg, device=model.device)
    capture = warm_graphs(engine, label)
    prompts = prompts_for(np.random.default_rng(9), 8, 16, 2000, cfg.vocab_size)
    max_new = 32
    reset_launches()
    first = engine.new_session()
    for rid, p in enumerate(prompts):
        first.submit(rid, p[None], max_new)
    pumps = 0
    while not (first.slots.request_id >= 0).all():
        first.pump()
        pumps += 1
        check(not first.results and pumps <= 4, f"{label}: {len(first.results)} requests "
              f"completed, {pumps} pumps, before every slot decoded")
    frontiers, rows = {}, []
    for rid in sorted(first.decoding_lens()):
        frontiers[rid], row = extract_timed(first, rid)
        rows.append(row)
    check(sorted(frontiers) == list(range(len(prompts))), f"{label}: frontiers {sorted(frontiers)}")
    longest = max(frontiers, key=lambda r: frontiers[r].tokens)
    compared = inject_roundtrip(first, frontiers[longest], longest)
    for rid in frontiers:
        first.cancel(rid)
    check(first.allocator.live_pages == 0, f"{label}: the killed session holds pages")
    launches_first = read_launches()
    del first
    free_memory()

    _rewarm(engine)
    captured = engine._graphs.captured if engine.graphs else 0
    tel0 = dataclasses.asdict(engine.telemetry)
    reset_launches()
    second = engine.new_session()
    admit_ms = _timed_restores(second)
    for rid, p in enumerate(prompts):
        second.submit(rid, p[None], max_new, frontier=frontiers[rid])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports = _pump_all(second)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    tel = {k: v - tel0[k] for k, v in dataclasses.asdict(engine.telemetry).items()}
    out = restore_checks(label, second.results, frontiers, max_new, reports, cfg.vocab_size)
    check(int(engine.nonfinite) == 0, f"{label}: {int(engine.nonfinite)} non-finite logits")
    check(tel["recomputed_prefill_tokens"] == 0 and tel["prefilled_tokens"] == 0
          and tel["prefills"] == 0 and tel["recovered_tokens"] == out["recovered_tokens"],
          f"{label}: telemetry of the restored session {tel}")
    check(second.allocator.live_pages == 0,
          f"{label}: {second.allocator.live_pages} pages still live after the drain")
    check(not engine.graphs or engine._graphs.captured == captured,
          f"{label}: the restored session captured a graph")
    steps = tel["chunks"] * ecfg.decode_chunk
    split = "decode_attention_paged_splitk"
    for k_, n in launches.items():
        check(n == (cfg.n_layers * steps if k_ == split else 0),
              f"{label}: restored run launched {k_} {n} times ({steps} decode steps)")

    # each prompt's re-prefill on the same engine: a fresh admission's pump
    # on the drained session (its pool published none of these prompts)
    for row, p in zip(rows, prompts):
        second.submit(100 + row["rid"], p[None], 1)
        reps, sec = _sync_s(lambda: _pump_all(second))
        check(sum(r.prefix_misses for r in reps) == 1, f"{label}: re-prefill hit the cache")
        row.update(reprefill_ms=sec * 1e3, reprefill_mixed_steps=sum(r.mixed_steps for r in reps),
                   admit_restored_ms=admit_ms[row["rid"]])
        print(f"  {label} frontier: " + json.dumps(row), flush=True)
    del second
    free_memory()
    for k_, n in launches_first.items():
        launches[k_] += n
    return dict(out, requests=len(prompts), layers=cfg.n_layers, dtype=cfg.dtype,
                max_new=max_new, prefill_chunk=ecfg.prefill_chunk, pumps_before_kill=pumps,
                frontiers=rows, frontier_device_gb=sum(r["device_bytes"] for r in rows) / 1e9,
                frontier_host_gb=sum(r["host_bytes"] for r in rows) / 1e9,
                roundtrip_positions=compared, restored_wall_s=wall,
                restored_decode_steps=steps, launches=launches, capture=capture, card=name_line)


def phase_durable_scan(name_line: str, model) -> dict:
    """Phase 4o: scan-state frontiers on the full-width bf16 model already
    loaded (rwkv6-7b after 4g, zamba2-2.7b after 4i), default EngineConfig
    (legacy admission): 2 requests (prompts 64 and 512, 32 new tokens),
    their ``StateFrontier``s taken after the first pump (each timed, as in
    4n), the session killed, a fresh session (decode chunk captured first)
    restores them (each timed) and drains: 32 tokens each starting with the
    frontier's, zero prefill and no prefill kernel, every launch held to
    ``expected_scan_launches`` of its decode steps.  Then each prompt's
    re-prefill on the drained session (a fresh admission's pump: one
    prefill and one decode chunk)."""
    from repro_torch.serving import EngineConfig

    cfg = model.cfg
    ecfg = EngineConfig()
    label = f"durable state {cfg.name}"
    engine = make_engine_class()(model, ecfg, device=model.device)
    capture = warm_graphs(engine, label)
    prompts = prompts_for(np.random.default_rng(10), 2, 64, 512, cfg.vocab_size)
    max_new = 32
    reset_launches()
    first = engine.new_session()
    for rid, p in enumerate(prompts):
        first.submit(rid, p[None], max_new)
    first.pump()
    check(sorted(first.decoding_lens()) == list(range(len(prompts))),
          f"{label}: not every request decodes after the first pump")
    frontiers, rows = {}, []
    for rid in range(len(prompts)):
        frontiers[rid], row = extract_timed(first, rid)
        rows.append(row)
    for rid in frontiers:
        first.cancel(rid)
    launches_first = read_launches()
    del first
    free_memory()

    _rewarm(engine)
    tel0 = dataclasses.asdict(engine.telemetry)
    reset_launches()
    second = engine.new_session()
    admit_ms = _timed_restores(second)
    for rid, p in enumerate(prompts):
        second.submit(rid, p[None], max_new, frontier=frontiers[rid])
    reports = _pump_all(second)
    launches = read_launches()
    tel = {k: v - tel0[k] for k, v in dataclasses.asdict(engine.telemetry).items()}
    out = restore_checks(label, second.results, frontiers, max_new, reports, cfg.vocab_size)
    check(int(engine.nonfinite) == 0, f"{label}: {int(engine.nonfinite)} non-finite logits")
    check(tel["prefills"] == 0, f"{label}: {tel['prefills']} prefills in the restored session")
    steps = tel["chunks"] * ecfg.decode_chunk
    check_launches(launches, expected_scan_launches(cfg, 0, steps, ecfg.max_len), label)

    # each prompt's re-prefill on the drained session: a fresh admission's pump
    for row, p in zip(rows, prompts):
        second.submit(100 + row["rid"], p[None], 1)
        _, sec = _sync_s(lambda: _pump_all(second))
        row.update(reprefill_ms=sec * 1e3, admit_restored_ms=admit_ms[row["rid"]])
        print(f"  {label} frontier: " + json.dumps(row), flush=True)
    del second
    free_memory()
    for k_, n in launches_first.items():
        launches[k_] = launches.get(k_, 0) + n
    return dict(out, requests=len(prompts), layers=cfg.n_layers, dtype=cfg.dtype,
                max_new=max_new, frontiers=rows,
                frontier_host_gb=sum(r["host_bytes"] for r in rows) / 1e9,
                restored_decode_steps=steps, launches=launches, capture=capture, card=name_line)


def kill_and_restore(model, ecfg, prompts, max_new, device, *, graphs=None, frontiers=None,
                     roundtrip=False) -> dict:
    """Serve ``prompts`` on a session of a fresh engine, take every decoding
    request's frontier after the first pump (``roundtrip``: each injected
    into a second pool, bit-equal below its frontier) and cancel them all;
    then a fresh session (graphs captured first) takes every request again,
    with its frontier where it has one, and drains.  With ``frontiers``
    (another run's), the first session is skipped and only those requests
    are restored.  Returns the streams by rid; launches are counted over
    both sessions, warming excluded."""
    engine = make_engine_class()(model, ecfg, device=device, graphs=graphs)
    launches = dict.fromkeys(read_launches(), 0)
    only_restored = frontiers is not None
    if frontiers is None:
        reset_launches()
        first = engine.new_session()
        for rid, p in enumerate(prompts):
            first.submit(rid, p[None], max_new)
        first.pump()
        frontiers = dict(first.extract_frontiers())
        if roundtrip:
            for rid, fr in frontiers.items():
                inject_roundtrip(first, fr, rid)
        for rid in range(len(prompts)):
            first.cancel(rid)
        launches = read_launches()
        del first
    _rewarm(engine)
    reset_launches()
    sess = engine.new_session()
    rids = sorted(frontiers) if only_restored else range(len(prompts))
    for rid in rids:
        sess.submit(rid, prompts[rid][None], max_new, frontier=frontiers.get(rid))
    reports = _pump_all(sess)
    for k_, n in read_launches().items():
        launches[k_] += n
    out = restore_checks(f"kill-and-restore on {device}", sess.results, frontiers, max_new,
                         reports, model.cfg.vocab_size)
    check(int(engine.nonfinite) == 0, f"kill-and-restore: {int(engine.nonfinite)} non-finite")
    if sess.paged:
        check(sess.allocator.live_pages == 0, "kill-and-restore: pages live after the drain")
    return dict(out, streams=sess.results, frontiers=frontiers, launches=launches)


def durable_exact(label: str, card_model, cpu_model, ecfg, prompts, max_new) -> dict:
    """One run of phase 5i: the uninterrupted card streams; a kill and
    restore on the card captured (inject round trips checked) and again
    with ``graphs=False`` (token-exact, launches equal); the card's
    frontiers restored on the CPU (those requests alone).  Each restored
    card stream must equal the uninterrupted one and the CPU's (or
    near-ties); every card stream the eager run's."""
    card, cpu = torch.device("cuda"), torch.device("cpu")
    walls = {}
    t0 = time.perf_counter()
    handles, _, eng = serve(card_model, ecfg, prompts, max_new, card, label=label)
    check_handles(handles, eng, max_new, card_model.cfg.vocab_size, label)
    plain = [h.result() for h in handles]
    free_memory()
    walls["uninterrupted_s"] = time.perf_counter() - t0
    cap, walls["captured_s"] = _sync_s(lambda: kill_and_restore(
        card_model, ecfg, prompts, max_new, card, roundtrip=ecfg.paged_kv))
    eager, walls["eager_s"] = _sync_s(lambda: kill_and_restore(
        card_model, ecfg, prompts, max_new, card, graphs=False))
    check(all(np.array_equal(cap["streams"][r], eager["streams"][r]) for r in range(len(prompts))),
          f"{label}: captured and eager restored streams differ")
    check(cap["launches"] == eager["launches"],
          f"{label}: launches captured {cap['launches']} differ from eager {eager['launches']}")
    t0 = time.perf_counter()
    on_cpu = kill_and_restore(cpu_model, ecfg, prompts, max_new, cpu,
                              frontiers=cap["frontiers"])
    walls["cpu_s"] = time.perf_counter() - t0
    rids = sorted(cap["frontiers"])
    restored = [prompts[r] for r in rids]
    card_streams = [cap["streams"][r] for r in rids]
    exact, ties = compare_streams(restored, card_streams, [plain[r] for r in rids], card_model,
                                  card_model, ("restored", "uninterrupted"))
    exact_cpu, ties_cpu = compare_streams(restored, card_streams,
                                          [on_cpu["streams"][r] for r in rids], card_model,
                                          cpu_model, ("card", "cpu"))
    free_memory()
    return dict(requests=len(prompts), restored=cap["restored"], restored_rids=rids,
                recovered_tokens=cap["recovered_tokens"],
                roundtrip_bit_equal=bool(ecfg.paged_kv),
                exact_vs_uninterrupted=exact, near_ties_vs_uninterrupted=ties,
                exact_vs_cpu=exact_cpu, near_ties_vs_cpu=ties_cpu,
                eager=dict(exact_streams=len(prompts), launches_equal=True),
                launches=cap["launches"], **walls)


# --------------------------------------------------------------------------
# phase 6: timing and bounds
# --------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phases 4p, 4q, 5j: the fleet's control loop over port replicas
# ---------------------------------------------------------------------------

FLEET_OUTAGE = (6.0, 16.0)


def full_overrides(cfg, **more) -> dict:
    """``TierSpec.model_overrides`` that bring ``cfg.reduce()`` back to
    ``cfg``'s widths (the runtime serves ``get_config(arch).reduce()`` with
    the overrides applied), plus ``more``."""
    red = cfg.reduce()
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "name" and getattr(cfg, f.name) != getattr(red, f.name)}
    out.update(more)
    return out


def fleet_like(builder, *, device, overrides, workload=None, tier_kw=None, **kw):
    """One of the fleet builders' runtimes, its tiers serving
    ``model_overrides`` (and ``tier_kw[tier]``), its trace replaced by
    ``workload(vocab)`` where given; failures, preemptions, capacity events
    and the fleet config are the builder's."""
    from repro_torch.fleet import runtime as fleet_runtime

    base = getattr(fleet_runtime, builder)(device=device, **kw)
    tiers = [dataclasses.replace(t, model_overrides=dict(overrides),
                                 **(tier_kw or {}).get(t.name, {})) for t in base.tiers]
    trace = base.workload if workload is None else workload(int(overrides["vocab_size"]))
    events = {name: list(pool.events) for name, pool in base.pools.items() if pool.events}
    return fleet_runtime.FleetRuntime(tiers, trace, base.cfg, failures=base.failures,
                                      preemptions=base.preemptions, pool_events=events or None,
                                      device=device)


def demo_trace(n_requests, rate, prompt_len, max_new, seed=0):
    """``build_demo_fleet``'s Poisson trace at another vocabulary and sizes."""
    from repro_torch.core.simulator import steady
    from repro_torch.fleet.workload import poisson_trace

    return lambda vocab: poisson_trace(steady(rate), n_requests / rate * 1.5, vocab_size=vocab,
                                       prompt_len=prompt_len, max_new=max_new, seed=seed,
                                       n_max=n_requests)


def run_fleet(rt, label: str) -> tuple:
    """Warm (captures timed apart), zero the launch counters, run to idle.
    Returns the report and a summary: ticks, wall, warm-up, mode trace,
    decisions, the per-replica captures the tracer recorded, launches."""
    t0 = time.perf_counter()
    rt.warmup()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_graphs_ = sum(e.captures[0] for e in rt._engines.values())
    reset_launches()
    t0 = time.perf_counter()
    report = rt.run()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    caps = {}
    for ev in rt.tracer.select(name="engine.capture"):
        g, s = caps.get(ev["replica"], (0, 0.0))
        caps[ev["replica"]] = (g + ev["graphs"], s + ev["capture_s"])
    check(len(report.requests.records) == len(rt.workload) and not report.requests.dropped,
          f"{label}: {len(report.requests.records)} of {len(rt.workload)} completed, "
          f"{len(report.requests.dropped)} dropped")
    check(all(d.explains() for d in report.decisions),
          f"{label}: a controller decision its record does not explain")
    check(not rt.tracer.select(name="engine.compile"),
          f"{label}: a measured pump met a step bucket warmup did not prepare")
    s = report.summary()
    replicas = sorted({r.replica for r in report.requests.records})
    out = dict(
        requests=len(report.requests.records), dropped=len(report.requests.dropped),
        retries=report.requests.total_retries(), ticks=report.ticks, wall_s=wall,
        warmup_s=warm_s, warmup_graphs=warm_graphs_,
        mode_trace=[[t, m] for t, m in report.mode_trace],
        decisions=len(report.decisions), replicas_serving=len(replicas),
        replica_captures={k: dict(graphs=g, capture_s=c) for k, (g, c) in sorted(caps.items())},
        capture_s=sum(c for _, c in caps.values()),
        pump_wall_s=report.pump_wall_s,
        total_cost_usd=s["total_cost_usd"], usd_per_1k_tokens=s["usd_per_1k_tokens"],
        goodput_tokens=s["goodput_tokens"], goodput_tokens_per_s=s["goodput_tokens_per_s"],
        goodput_tokens_per_s_wall=s["goodput_tokens_per_s_wall"],
        slo_attainment=s["slo_attainment"], p50_ttft_s=s["p50_ttft_s"],
        p95_ttft_s=s["p95_ttft_s"], recovered_tokens=s["recovered_tokens"],
        recomputed_prefill_tokens=s["recomputed_prefill_tokens"], launches=launches)
    print(f"  {label}: {report.ticks} ticks in {wall:.1f} s (warm-up {warm_s:.1f} s, "
          f"{warm_graphs_} graphs), mode trace {out['mode_trace']}", flush=True)
    if caps:
        print(f"  {label}: graphs captured on first pumps, by replica: "
              + json.dumps(out["replica_captures"]), flush=True)
    return report, out


def check_fleet_launches(rt, launches: dict, mixed: str, decode: str, label: str) -> dict:
    """The fleet's kernels launched exactly layers x its engines' steps:
    the mixed step once a layer per mixed step, the single-stage decode
    once a layer per decode step; no other kernel."""
    engines = list(rt._engines.values())
    layers = engines[0].model.cfg.n_layers
    steps = sum(e.telemetry.mixed_steps for e in engines)
    decode_steps = sum(e.telemetry.chunks * e.cfg.decode_chunk for e in engines)
    check(launches[mixed] == layers * steps,
          f"{label}: {launches[mixed]} {mixed} launches for {steps} mixed steps of {layers} layers")
    check(launches[decode] == layers * decode_steps,
          f"{label}: {launches[decode]} {decode} launches for {decode_steps} decode steps of "
          f"{layers} layers")
    others = {k: v for k, v in launches.items() if v and k not in (mixed, decode)}
    check(not others, f"{label}: kernels off the fleet's path launched: {others}")
    return dict(mixed_steps=steps, decode_steps=decode_steps)


def check_outage_modes(report, label: str, outage=FLEET_OUTAGE) -> dict:
    """The failover drill's control checks (``tests/test_fleet_runtime.py``):
    at least one retry; capacity mode on more than 60% of the outage's
    ticks from 2 s in; cost mode first, and on more than half of the ticks
    from 4 s after the recovery (there must be some); nothing completes on
    the dead tier during the outage."""
    from repro_torch.core import policy

    modes = {r.t: r.mode for r in report.metrics.records}
    during = [m for t, m in modes.items() if outage[0] + 2.0 <= t < outage[1]]
    share = float(np.mean(np.array(during) == policy.CAPACITY_OPTIMIZED))
    check(report.requests.total_retries() >= 1, f"{label}: the outage interrupted nothing")
    check(share > 0.6, f"{label}: capacity mode on {share:.2f} of the outage's ticks")
    check(report.mode_sequence()[0] == policy.COST_OPTIMIZED, f"{label}: did not start in cost")
    post = [m for t, m in modes.items() if t >= outage[1] + 4.0]
    cost_share = float(np.mean(np.array(post) == policy.COST_OPTIMIZED)) if post else 0.0
    check(cost_share > 0.5, f"{label}: cost mode on {cost_share:.2f} of the {len(post)} ticks "
                            f"from {outage[1] + 4.0} s (more than half wanted)")
    for rec in report.requests.records:
        check(not (outage[0] + 2.0 <= rec.complete_t <= outage[1] and rec.tier == "cheap"),
              f"{label}: request {rec.rid} completed on the dead tier at {rec.complete_t}")
    return dict(capacity_share_in_outage=share, cost_share_after_recovery=cost_share,
                last_mode=report.mode_sequence()[-1])


def policy_cost(rt) -> dict:
    """Host milliseconds of one controller step on the card and on the CPU
    (the tick's signals replayed 200 times; the card's step ends in one
    read of its weights)."""
    from repro_torch.core.controller import ModeController

    req = np.array([rt.autoscalers[s.name].current for s in rt.tiers], np.int64)
    pool = np.array([rt.pools[s.name].capacity_at(rt.t) for s in rt.tiers])
    measured = rt.telemetry.measured_t_max(rt._nominal)
    out = {}
    for dev in ("cuda", "cpu"):
        ctl = ModeController([t.profile() for t in rt.tiers], rt.cfg.controller, device=dev)
        for i in range(10):
            ctl.step(float(i), 2.0, req, pool, measured_t_max=measured)
        t0 = time.perf_counter()
        for i in range(200):
            ctl.step(10.0 + i, 2.0 + (i % 3), req, pool, measured_t_max=measured)
        out[f"{dev}_ms_per_step"] = (time.perf_counter() - t0) / 200 * 1e3
    return out


def bare_streams(model, ecfg, prompts_max_new) -> list:
    """Every request through one bare engine of config ``ecfg``."""
    from repro_torch.serving import EngineClient, InferenceRequest, ServingEngine

    eng = ServingEngine(model, dataclasses.replace(ecfg), device=model.device)
    client = EngineClient(eng, device=model.device)
    hs = [client.submit(InferenceRequest(prompt=p, max_new=n)) for p, n in prompts_max_new]
    client.drain()
    return [h.result() for h in hs]


def fp32_copy(model):
    """The same weights in an fp32 model on the same device."""
    from repro_torch.models import Model

    twin = Model(dataclasses.replace(model.cfg, dtype="float32"), device=model.device)
    twin.load_state_dict(model.state_dict())
    return twin


def bf16_divergence(model, model32, prompt, a, b, rid: int, label: str) -> dict:
    """The first divergence of two bf16 streams of one prompt must be a
    near-tie: the two tokens' fp32 margin under ``BF16_TIE_SIGMAS`` times
    the RMS of the bf16 logits' error against fp32 at that context, and
    that bound under the fp32 gap from the best token to the median one
    (else any token would pass)."""
    j = int(np.nonzero(a != b)[0][0])
    ctx = list(prompt) + list(b[:j])
    l16, l32 = _logits_at(model, ctx).float(), _logits_at(model32, ctx).float()
    sigma = float((l16 - l32).pow(2).mean().sqrt())
    m32 = float((l32[int(a[j])] - l32[int(b[j])]).abs())
    bound, gap = BF16_TIE_SIGMAS * sigma, float(l32.max() - l32.median())
    print(f"  {label}: stream {rid} diverges at generated token {j}: {a[j]} vs {b[j]}, fp32 "
          f"margin {m32:.3e}, bf16 error RMS {sigma:.3e} (bound {bound:.3e}), fp32 best-to-median "
          f"gap {gap:.3e}", flush=True)
    check(bound < gap, f"{label}: stream {rid}: a bf16 bound of {bound:.3e} would pass any token "
                       f"(best-to-median gap {gap:.3e})")
    check(m32 < bound, f"{label}: stream {rid} diverges at a fp32 margin of {m32:.3e} >= "
                       f"{bound:.3e}: not a bf16 near-tie")
    return dict(rid=rid, position=j, tokens=[int(a[j]), int(b[j])], fp32_margin=m32,
                bf16_error_rms=sigma, bound=bound, best_to_median=gap)


def fleet_vs_bare(rt, report, requests, model, label: str) -> tuple:
    """Each request's bf16 stream against a bare engine of the tier it
    completed on: equal, or a near-tie at its first divergence
    (``bf16_divergence``).  Returns the count of equal streams and the
    near-ties."""
    tier_of = {r.rid: r.tier for r in report.requests.records}
    model32, ties, exact = fp32_copy(model), [], 0
    for tier, eng in sorted(rt._engines.items()):
        mine = [r for r in requests if tier_of[r.rid] == tier]
        bare = bare_streams(model, eng.cfg, [(r.prompt[0], r.max_new) for r in mine])
        for r, b in zip(mine, bare):
            a = report.outputs[r.rid]
            check(a.shape == b.shape, f"{label}: request {r.rid} has {a.shape} tokens, its bare "
                                      f"engine {b.shape}")
            if np.array_equal(a, b):
                exact += 1
            else:
                ties.append(bf16_divergence(model, model32, r.prompt[0], a, b, r.rid, label))
    return exact, ties


def phase_fleet(name_line: str) -> dict:
    """Phase 4p: ``build_demo_fleet``'s two tiers and economics at
    qwen3-0.6b's full widths in bf16 (max_len 1024, decode batches 4 and
    8, mixed admission), 32 requests of its Poisson trace at 2 req/s
    (prompts 16..512, 16..32 new tokens), the cheap tier's pool at zero
    from 6 to 16 s."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-0.6b")
    over = full_overrides(cfg)
    label = "fleet 4p"
    rt = fleet_like("build_demo_fleet", device="cuda", overrides=over,
                    workload=demo_trace(32, 2.0, (16, 512), (16, 32)),
                    tier_kw={"cheap": dict(max_len=1024, decode_batch=4),
                             "premium": dict(max_len=1024, decode_batch=8)},
                    n_requests=32, rate=2.0, outage=FLEET_OUTAGE)
    model = rt._engine_for(rt.tiers[0]).model
    check(dataclasses.replace(model.cfg, name=cfg.name) == cfg,
          f"{label}: the tiers' model is not qwen3-0.6b at full width: {model.cfg}")
    requests = list(rt.workload)
    report, out = run_fleet(rt, label)
    out.update(check_outage_modes(report, label))
    out.update(check_fleet_launches(rt, out["launches"], "mixed_attention", "decode_attention",
                                    label))
    for rid, toks in report.outputs.items():
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: token out of vocab")
    # the control loop runs on the loop's clock: a reduced fp32 twin of the
    # fleet on the CPU must take the same decisions and placements
    twin = fleet_like("build_demo_fleet", device="cpu",
                      overrides=dict(vocab_size=cfg.vocab_size),
                      workload=demo_trace(32, 2.0, (16, 512), (16, 32)),
                      tier_kw={"cheap": dict(max_len=1024, decode_batch=4),
                               "premium": dict(max_len=1024, decode_batch=8)},
                      n_requests=32, rate=2.0, outage=FLEET_OUTAGE)
    t0 = time.perf_counter()
    twin_report = twin.run()
    out["cpu_twin_s"] = time.perf_counter() - t0
    same = (twin_report.mode_trace == report.mode_trace
            and [dataclasses.asdict(d) for d in twin_report.decisions]
            == [dataclasses.asdict(d) for d in report.decisions]
            and [(r.rid, r.tier, r.replica, r.retries, r.complete_t)
                 for r in twin_report.requests.records]
            == [(r.rid, r.tier, r.replica, r.retries, r.complete_t)
                for r in report.requests.records])
    check(same, f"{label}: the reduced CPU twin took other decisions or placements")
    exact, ties = fleet_vs_bare(rt, report, requests, model, label)
    out.update(streams_equal_bare_engine=exact, bf16_near_ties=ties)
    out["policy"] = policy_cost(rt)
    out["card"] = name_line
    print(f"  {label}: {exact} of {len(requests)} bf16 streams equal a bare engine's of their "
          f"tier, {len(ties)} near-ties; policy step {out['policy']['cuda_ms_per_step']:.3f} ms "
          f"on the card, {out['policy']['cpu_ms_per_step']:.3f} ms on the CPU", flush=True)
    return out


def phase_fleet_recovery(name_line: str) -> dict:
    """Phase 4q: ``build_recovery_fleet``'s tier (paged, 3 slots, 512-token
    prompts, kills at 2 and 4 s, a preemption notice at 3 s, the fleet KV
    store on) at qwen3-0.6b's full widths in bf16, its burst re-drawn over
    the full vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.fleet.workload import burst_of

    cfg = get_config("qwen3-0.6b")
    label = "fleet recovery 4q"
    rt = fleet_like("build_recovery_fleet", device="cuda", overrides=full_overrides(cfg),
                    workload=lambda vocab: burst_of(8, vocab_size=vocab, prompt_len=512,
                                                    max_new=(12, 24), seed=0))
    report, out = run_fleet(rt, label)
    s = report.summary()
    check(report.requests.total_retries() >= 1, f"{label}: no retry")
    check(s["recomputed_prefill_tokens"] == 0,
          f"{label}: {s['recomputed_prefill_tokens']} prefill tokens recomputed")
    check(s["recovered_tokens"] > 0, f"{label}: nothing recovered from the store")
    check(report.kv_store["puts"] > 0 and report.kv_store["hits"] > 0,
          f"{label}: store puts {report.kv_store['puts']}, hits {report.kv_store['hits']}")
    out.update(check_fleet_launches(rt, out["launches"], "mixed_attention_paged",
                                    "decode_attention_paged", label))
    out.update(kv_store=report.kv_store, kv_flush_s=report.telemetry["spot"]["kv_flush_s"],
               kv_flush_tokens=report.telemetry["spot"]["kv_flush_tokens"], card=name_line)
    return out


def phase_fleet_exact() -> dict:
    """Phase 5j: ``build_demo_fleet`` with the cheap tier out from 6 to 16
    s, 40 requests, on phase 5's model shape (qwen3-0.6b at full width cut
    to 4 layers, fp32), once on the card and once on the CPU: the same
    mode trace, decisions and per-request records; streams equal token for
    token or near-ties (``NEAR_TIE``) printed with their margins."""
    from repro_torch.configs import get_config

    over = full_overrides(get_config("qwen3-0.6b"), n_layers=4, dtype="float32")
    label = "fleet exact 5j"
    runs = {}
    for dev in ("cuda", "cpu"):
        rt = fleet_like("build_demo_fleet", device=dev, overrides=over,
                        workload=demo_trace(40, 2.0, (8, 8), (4, 12)),
                        n_requests=40, rate=2.0, outage=FLEET_OUTAGE)
        report, out = run_fleet(rt, f"{label} {dev}")
        runs[dev] = (rt, report, out)
    (crt, card, cout), (prt_, cpu, pout) = runs["cuda"], runs["cpu"]
    check(card.mode_trace == cpu.mode_trace,
          f"{label}: mode traces differ: {card.mode_trace} vs {cpu.mode_trace}")
    check([dataclasses.asdict(d) for d in card.decisions]
          == [dataclasses.asdict(d) for d in cpu.decisions], f"{label}: decisions differ")
    check([dataclasses.asdict(r) for r in card.requests.records]
          == [dataclasses.asdict(r) for r in cpu.requests.records],
          f"{label}: per-request records (tier, replica, retries, timestamps) differ")
    check_outage_modes(card, label)
    requests = list(crt.workload)
    exact, ties = compare_streams([r.prompt[0] for r in requests],
                                  [card.outputs[r.rid] for r in requests],
                                  [cpu.outputs[r.rid] for r in requests],
                                  crt._engine_for(crt.tiers[0]).model,
                                  prt_._engine_for(prt_.tiers[0]).model, ("card", "cpu"))
    launches = cout["launches"]
    steps = check_fleet_launches(crt, launches, "mixed_attention", "decode_attention", label)
    return dict(**steps, requests=len(requests), exact_streams=exact, near_ties=ties,
                mode_trace=cout["mode_trace"], decisions=cout["decisions"],
                retries=cout["retries"], ticks=cout["ticks"], card_wall_s=cout["wall_s"],
                cpu_wall_s=pout["wall_s"], card_warmup_s=cout["warmup_s"],
                replica_captures=cout["replica_captures"], launches=launches,
                layers=4, dtype="float32")


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

    # single-stage decode, contiguous and paged: the fp32 max_len=1024
    # serving run of phases 5 and 5b (64 columns of 16 over a 769-page
    # pool); the bf16 rows and each cluster size are timed at the end
    dt, S = torch.float32, 1024
    es = torch.finfo(dt).bits // 8
    k, v = _rand(gen, (B, S, HKV, D), dt), _rand(gen, (B, S, HKV, D), dt)
    q = _rand(gen, (B, HKV * G, D), dt)
    lens_np = rng.integers(16, S + 1, B)
    single_np = lens_np
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
    split_np = lens_np
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    keys = int(lens_np.sum())
    # the one-launch split-K decode: its bytes are q, K/V below each length,
    # the lengths and the output (the chunk states are a workspace in L2);
    # partial_ms is the same kernel storing the chunk states alone
    row("decode_attention_splitk", dt,
        time_ms(lambda: kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K), 200),
        time_ms(lambda: ref.decode_attention_splitk(q, k, v, lens, k_splits=K), 20),
        2 * keys * HKV * D * es + 2 * B * HKV * G * D * es + 4 * B,
        4 * keys * HKV * G * D,
        time_ms(lambda: _sdpa(q[:, None], k, v, mask), 50),
        f"bf16 B={B} S={S} K={K} Hkv={HKV} G={G} D={D} lengths={lens_np.tolist()}")
    out["decode_attention_splitk"]["partial_ms"] = time_ms(
        lambda: kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K), 200)

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
    # the verify step of spec_k = 8 (phase 5h's widest): Q = 16 over the
    # same window, cache lengths cut to fit it
    Q16 = 16
    q16 = _rand(gen, (B, Q16, HKV * G, D), dt)
    c16_np = np.minimum(cl_np, W - Q16)
    c16 = torch.as_tensor(c16_np, dtype=torch.int32, device="cuda")
    qpos16 = c16[:, None] + torch.arange(Q16, device="cuda")[None, :]
    mask16 = (torch.arange(W, device="cuda")[None, None, :] <= qpos16[:, :, None])[:, None]
    pairs16 = int(sum((c + i + 1) for c in c16_np for i in range(Q16)))
    b16, by16 = bound_ms(2 * int((c16_np + Q16).sum()) * HKV * D * es
                         + 2 * B * Q16 * HKV * G * D * es + 4 * B, 4 * pairs16 * HKV * G * D, dt)
    out["mixed_attention"]["q16"] = dict(
        ms=time_ms(lambda: kernel.mixed_attention_cuda(q16, kw, vw, c16), 200),
        plain_ms=time_ms(lambda: ref.mixed_attention(q16, kw, vw, c16), 20),
        bound_ms=b16, bound_by=by16, library_ms=time_ms(lambda: _sdpa(q16, kw, vw, mask16), 50),
        shape=f"bf16 B={B} Q={Q16} window={W} Hkv={HKV} G={G} D={D} "
              f"cache_lens={c16_np.tolist()}")

    # the paged split-K partial and mixed step over the auto-sized bf16 pool,
    # at the same lengths as their contiguous twins above.  Bytes: the keys
    # below each length, q, out, lengths and the table entries of their pages.
    kp, vp, tbl = paged_inputs(gen, lens_np, ps, dt)
    shape = (f"bf16 B={B} pool {kp.shape[0]}x{ps} tables ({B},{tbl.shape[1]}) "
             f"Hkv={HKV} G={G} D={D}")
    row("decode_attention_paged_splitk", dt,
        time_ms(lambda: kernel.decode_attention_paged_splitk_cuda(q, kp, vp, tbl, lens,
                                                                  k_splits=K), 200),
        time_ms(lambda: ref.decode_attention_paged_splitk(q, kp, vp, tbl, lens, k_splits=K), 20),
        2 * keys * HKV * D * es + 2 * B * HKV * G * D * es + 4 * B + table_bytes(lens_np),
        4 * keys * HKV * G * D, None,
        f"{shape} K={K} lengths={lens_np.tolist()}; library: {no_call}")
    out["decode_attention_paged_splitk"]["partial_ms"] = time_ms(
        lambda: kernel.paged_splitk_partial_cuda(q, kp, vp, tbl, lens, k_splits=K), 200)
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
    # the final state written once; ops: 5 N^2 per token and head, fp32,
    # which the bf16 kernel runs on the tensor cores in 3xTF32.
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    H, N = 64, 64
    r, k, v, logw, u, _ = wkv_inputs(gen, 1, S, H, N, dt, state=False)
    zeros = torch.zeros((1, H, N, N), device="cuda")
    row("wkv6", "3xtf32",
        time_ms(lambda: wkv_kernel.wkv6_cuda(r, k, v, logw, u), 50),
        time_ms(lambda: wkv_ref.wkv6_chunked(r, k, v, logw, u, zeros), 5),
        3 * S * H * N * es + S * H * N * 4 + H * N * es + S * H * N * 4 + H * N * N * 4,
        5 * N * N * S * H, None,
        f"bf16 r/k/v/u, fp32 logw, B=1 S={S} H={H} N={N}, zero state; "
        "library: none (no one call computes the WKV6 recurrence)")
    # each slice width of the bf16 kernel at this shape, beside the one
    # kernel.chunk_cols picks (32 here): the evidence for that choice
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_cols = {f"B=1 S={S}": {
        c: time_ms(lambda c=c: wkv_kernel.launch(r, k, v, logw, u, None, c), 50)
        for c in (16, 32, 64)}}
    out["wkv6"]["cols"] = wkv_kernel.chunk_cols(1, H, N, sms)
    # and at phase 4g's generate prefill: B=8, S=512
    Bg, Sg = 8, 512
    r, k, v, logw, u, _ = wkv_inputs(gen, Bg, Sg, H, N, dt, state=False)
    zeros = torch.zeros((Bg, H, N, N), device="cuda")
    b_ms, by = bound_ms(Bg * (3 * Sg * H * N * es + 2 * Sg * H * N * 4 + H * N * N * 4)
                        + H * N * es, 5 * N * N * Sg * H * Bg, "3xtf32")
    out["wkv6"]["phase_4g_shape"] = dict(
        ms=time_ms(lambda: wkv_kernel.wkv6_cuda(r, k, v, logw, u), 50),
        plain_ms=time_ms(lambda: wkv_ref.wkv6_chunked(r, k, v, logw, u, zeros), 5),
        bound_ms=b_ms, bound_by=by, library_ms=None, cols=wkv_kernel.chunk_cols(Bg, H, N, sms),
        shape=f"bf16 r/k/v/u, fp32 logw, B={Bg} S={Sg} H={H} N={N}, zero state")
    by_cols[f"B={Bg} S={Sg}"] = {
        c: time_ms(lambda c=c: wkv_kernel.launch(r, k, v, logw, u, None, c), 50)
        for c in (16, 32, 64)}
    out["wkv6"]["ms_by_cols"] = by_cols
    del r, k, v, logw, u

    # SSD at phase 4h's longest prefill: B=1, S=2000, 80 heads of P=64, N=64,
    # bf16 x/B/C, fp32 dt and A, from a zero state (as Model.prefill calls
    # it).  Bytes: x, dt, A, B, C read once, y and the final state written
    # once; ops: 5 P N per token and head, fp32, which the bf16 kernel runs
    # on the tensor cores in two TF32 passes (x, B and C are exact in TF32).
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    H, P, N = 80, 64, 64

    def ssd_bytes(Bs, Ss):
        return (Bs * Ss * H * P * es + 2 * Bs * Ss * N * es + Bs * Ss * H * 4 + H * 4
                + Bs * Ss * H * P * 4 + Bs * H * P * N * 4)

    x, dt_, A, Bm, Cm, _ = ssd_inputs(gen, 1, S, H, P, N, dt, state=False)
    zeros = torch.zeros((1, H, P, N), device="cuda")
    row("ssd", "2xtf32",
        time_ms(lambda: ssd_kernel.ssd_cuda(x, dt_, A, Bm, Cm), 50),
        time_ms(lambda: ssd_ref.ssd_chunked(x, dt_, A, Bm, Cm, zeros), 5),
        ssd_bytes(1, S), 5 * P * N * S * H, None,
        f"bf16 x/B/C, fp32 dt/A, B=1 S={S} H={H} P={P} N={N}, zero state; "
        "library: none (no one call computes the SSD recurrence)")
    # each slice width of the bf16 kernel at this shape, beside the one
    # kernel.chunk_rows picks (64 here): the evidence for that choice
    by_rows = {f"B=1 S={S}": {
        r: time_ms(lambda r=r: ssd_kernel.launch(x, dt_, A, Bm, Cm, None, r), 50)
        for r in (16, 32, 64)}}
    out["ssd"]["rows"] = ssd_kernel.chunk_rows(P)
    # and at phase 4i's generate prefill: B=8, S=512
    x, dt_, A, Bm, Cm, _ = ssd_inputs(gen, Bg, Sg, H, P, N, dt, state=False)
    zeros = torch.zeros((Bg, H, P, N), device="cuda")
    b_ms, by = bound_ms(ssd_bytes(Bg, Sg), 5 * P * N * Sg * H * Bg, "2xtf32")
    out["ssd"]["phase_4i_shape"] = dict(
        ms=time_ms(lambda: ssd_kernel.ssd_cuda(x, dt_, A, Bm, Cm), 50),
        plain_ms=time_ms(lambda: ssd_ref.ssd_chunked(x, dt_, A, Bm, Cm, zeros), 5),
        bound_ms=b_ms, bound_by=by, library_ms=None, rows=ssd_kernel.chunk_rows(P),
        shape=f"bf16 x/B/C, fp32 dt/A, B={Bg} S={Sg} H={H} P={P} N={N}, zero state")
    by_rows[f"B={Bg} S={Sg}"] = {
        r: time_ms(lambda r=r: ssd_kernel.launch(x, dt_, A, Bm, Cm, None, r), 50)
        for r in (16, 32, 64)}
    out["ssd"]["ms_by_rows"] = by_rows
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
    row80("decode_attention_splitk", dt,
          time_ms(lambda: kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K), 200),
          time_ms(lambda: ref.decode_attention_splitk(q, k, v, lens, k_splits=K), 20),
          2 * keys * Hk * Dz * es + 2 * B * Hq * Dz * es + 4 * B,
          4 * keys * Hq * Dz,
          time_ms(lambda: _sdpa(q[:, None], k, v, mask), 50),
          f"bf16 B={B} S={Sc} K={K} Hkv={Hk} G=1 D={Dz} lengths={lens_np.tolist()}")
    out["decode_attention_splitk"]["d80"]["partial_ms"] = time_ms(
        lambda: kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K), 200)
    del k, v

    fp32_timing(out, split_np, cl_np)

    single_stage_timing(out, single_np, table_bytes)
    return out


def fp32_timing(out: dict, split_np, cl_np) -> None:
    """The fp32 routes at phase 6's shapes and lengths, as an ``fp32``
    sub-row of their kernel's row: ``cluster_mixed_f32_kernel`` as the mixed
    step (contiguous, and paged also at the recovery tier's shape; each at
    every cluster size, ``ms_by_cluster``), ``flash_rows_kernel<float>`` as
    the one-launch split-K decode, ``flash_fwd_kernel``, ``wkv6_kernel`` and
    ``ssd_kernel``, each beside its plain version and its fp32 bound (the
    CUDA cores' 67 TFLOP/s: none uses TF32); SDPA in fp32 where one call
    computes the same.  A generator of its own."""
    from repro_torch.kernels.decode_attention import kernel, ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    gen = torch.Generator("cuda").manual_seed(9)
    dt, es = torch.float32, 4
    F = torch.nn.functional

    def sub(name, ms, plain_ms, nbytes, ops, library_ms, shape, **extra):
        b_ms, by = bound_ms(nbytes, ops, dt)
        out[name]["fp32"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                 library_ms=library_ms, shape=shape, **extra)

    K, S = 8, S_MAX
    k, v = _rand(gen, (B, S, HKV, D), dt), _rand(gen, (B, S, HKV, D), dt)
    q = _rand(gen, (B, HKV * G, D), dt)
    lens = torch.as_tensor(split_np, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    keys = int(np.asarray(split_np).sum())
    sub("decode_attention_splitk",
        time_ms(lambda: kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K), 200),
        time_ms(lambda: ref.decode_attention_splitk(q, k, v, lens, k_splits=K), 20),
        2 * keys * HKV * D * es + 2 * B * HKV * G * D * es + 4 * B, 4 * keys * HKV * G * D,
        time_ms(lambda: _sdpa(q[:, None], k, v, mask), 50),
        f"fp32 B={B} S={S} K={K} Hkv={HKV} G={G} D={D} lengths={list(map(int, split_np))}",
        partial_ms=time_ms(lambda: kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K), 200))

    Q, W = 8, 2048
    qm = _rand(gen, (B, Q, HKV * G, D), dt)
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")
    kw, vw = k[:, :W], v[:, :W]
    qpos = cl[:, None] + torch.arange(Q, device="cuda")[None, :]
    mmask = (torch.arange(W, device="cuda")[None, None, :] <= qpos[:, :, None])[:, None]
    seen = int(np.minimum(np.asarray(cl_np) + Q, W).sum())
    pairs = int(sum((c + i + 1) for c in cl_np for i in range(Q)))
    sizes = (1, 2, 4, 8)
    mixed_kernel = f"cluster_mixed_f32_kernel<{D}>"
    sub("mixed_attention",
        time_ms(lambda: kernel.mixed_attention_cuda(qm, kw, vw, cl), 200),
        time_ms(lambda: ref.mixed_attention(qm, kw, vw, cl), 20),
        2 * seen * HKV * D * es + 2 * B * Q * HKV * G * D * es + 4 * B, 4 * pairs * HKV * G * D,
        time_ms(lambda: _sdpa(qm, kw, vw, mmask), 50),
        f"fp32 B={B} Q={Q} window={W} of S={S} Hkv={HKV} G={G} D={D} "
        f"cache_lens={list(map(int, cl_np))}",
        kernel=mixed_kernel, cluster=kernel.mixed_cluster(W, B, HKV, Q, G, D),
        ms_by_cluster={c: time_ms(lambda c=c: kernel._mixed(qm, kw, vw, cl, "mixed_attention",
                                                             cluster=c), 200) for c in sizes})
    del k, v, kw, vw

    S = 2000
    q = _rand(gen, (1, S, HKV * G, D), dt)
    k, v = _rand(gen, (1, S, HKV, D), dt), _rand(gen, (1, S, HKV, D), dt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sub("flash_attention",
        time_ms(lambda: flash_kernel.flash_attention_cuda(q, k, v, causal=True), 20),
        time_ms(lambda: flash_ref.flash_attention(q, k, v, causal=True), 5),
        (2 * S * HKV * G * D + 2 * S * HKV * D) * es, 4 * D * HKV * G * S * (S + 1) // 2,
        time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True), 20),
        f"fp32 B=1 Sq=Sk={S} Hq={HKV * G} Hkv={HKV} D={D} causal")
    del q, k, v, qt, kt, vt

    H, N = 64, 64
    r, k, v, logw, u, _ = wkv_inputs(gen, 1, S, H, N, dt, state=False)
    zeros = torch.zeros((1, H, N, N), device="cuda")
    sub("wkv6",
        time_ms(lambda: wkv_kernel.wkv6_cuda(r, k, v, logw, u), 20),
        time_ms(lambda: wkv_ref.wkv6_chunked(r, k, v, logw, u, zeros), 5),
        (5 * S * H * N + H * N + H * N * N) * es, 5 * N * N * S * H, None,
        f"fp32 r/k/v/u/logw, B=1 S={S} H={H} N={N}, zero state; "
        "library: none (no one call computes the WKV6 recurrence)")
    del r, k, v, logw, u

    H, P, N = 80, 64, 64
    x, dt_, A, Bm, Cm, _ = ssd_inputs(gen, 1, S, H, P, N, dt, state=False)
    zeros = torch.zeros((1, H, P, N), device="cuda")
    sub("ssd",
        time_ms(lambda: ssd_kernel.ssd_cuda(x, dt_, A, Bm, Cm), 20),
        time_ms(lambda: ssd_ref.ssd_chunked(x, dt_, A, Bm, Cm, zeros), 5),
        (2 * S * H * P + 2 * S * N + S * H + H + H * P * N) * es, 5 * P * N * S * H, None,
        f"fp32 x/B/C/dt/A, B=1 S={S} H={H} P={P} N={N}, zero state; "
        "library: none (no one call computes the SSD recurrence)")
    del x, dt_, A, Bm, Cm

    # the paged mixed step in fp32: phase 6's pool and lengths through
    # tables cut to the 2048-key window, and the recovery tier (B=3, 2 kv
    # heads of 32, G 2, Q 8 over its 205-page pool, cache lengths 512-536)
    ps, no_call = PAGE, "none (no one call reads a block table)"
    kp, vp, tbl = paged_inputs(gen, split_np, ps, dt)
    view = tbl[:, :W // ps]
    table = 4 * int((-(-np.minimum(np.asarray(cl_np) + Q, W) // ps)).sum())
    sub("mixed_attention_paged",
        time_ms(lambda: kernel.mixed_attention_paged_cuda(qm, kp, vp, view, cl), 200),
        time_ms(lambda: ref.mixed_attention_paged(qm, kp, vp, view, cl), 20),
        2 * seen * HKV * D * es + 2 * B * Q * HKV * G * D * es + 4 * B + table,
        4 * pairs * HKV * G * D, None,
        f"fp32 B={B} pool {kp.shape[0]}x{ps} tables ({B},{tbl.shape[1]}) cut to {W // ps} "
        f"columns, Q={Q} Hkv={HKV} G={G} D={D} cache_lens={list(map(int, cl_np))}; "
        f"library: {no_call}",
        kernel=mixed_kernel, cluster=kernel.mixed_cluster(W, B, HKV, Q, G, D),
        ms_by_cluster={c: time_ms(lambda c=c: kernel._mixed(
            qm, kp, vp, cl, "mixed_attention_paged", view, cluster=c), 200) for c in sizes})
    del kp, vp
    hk, g, d = TIER_HKV, TIER_G, TIER_D
    tcl_np = np.random.default_rng(25).integers(512, TIER_S - Q + 1, TIER_B)
    tcl = torch.as_tensor(tcl_np, dtype=torch.int32, device="cuda")
    kp, vp, ttbl = tier_inputs(gen, tcl_np + Q, dt)
    tq = _rand(gen, (TIER_B, Q, hk * g, d), dt)
    tseen = int((tcl_np + Q).sum())
    tpairs = int(sum((c + i + 1) for c in tcl_np for i in range(Q)))
    b_ms, by = bound_ms(2 * tseen * hk * d * es + 2 * TIER_B * Q * hk * g * d * es + 4 * TIER_B
                        + 4 * int((-(-(tcl_np + Q) // ps)).sum()), 4 * tpairs * hk * g * d, dt)
    out["mixed_attention_paged"]["fp32"]["phase_tier_shape"] = dict(
        ms=time_ms(lambda: kernel.mixed_attention_paged_cuda(tq, kp, vp, ttbl, tcl), 200),
        plain_ms=time_ms(lambda: ref.mixed_attention_paged(tq, kp, vp, ttbl, tcl), 20),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        kernel=f"cluster_mixed_f32_kernel<{d}>",
        cluster=kernel.mixed_cluster(TIER_S, TIER_B, hk, Q, g, d),
        ms_by_cluster={c: time_ms(lambda c=c: kernel._mixed(
            tq, kp, vp, tcl, "mixed_attention_paged", ttbl, cluster=c), 200) for c in sizes},
        shape=f"fp32 B={TIER_B} pool {kp.shape[0]}x{ps} tables ({TIER_B},{ttbl.shape[1]}) "
              f"Q={Q} Hkv={hk} G={g} D={d} cache_lens={tcl_np.tolist()}; library: {no_call}")


def single_stage_timing(out: dict, lens_np, table_bytes) -> None:
    """The single-stage decode in bf16 at phase 6's shape (B=8, S=1024,
    the fp32 rows' lengths; beside SDPA) and in fp32 at the recovery
    tier's (B=3, 2 kv heads of 32, G 2, paged, max_len 544, lengths
    512-544), each at every cluster size the chooser can return
    (``ms_by_cluster``, with ``cluster`` the one it picks); the fp32 rows
    at every cluster size too.  A generator of its own, so the rows before
    keep their inputs."""
    from repro_torch.kernels.decode_attention import kernel, ref

    gen = torch.Generator("cuda").manual_seed(8)
    sizes = (1, 2, 4, 8)
    no_call = "none (no one call reads a block table)"
    S = 1024
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    keys = int(np.asarray(lens_np).sum())
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    for dt in (torch.bfloat16, torch.float32):
        es = torch.finfo(dt).bits // 8
        k, v = _rand(gen, (B, S, HKV, D), dt), _rand(gen, (B, S, HKV, D), dt)
        q = _rand(gen, (B, HKV * G, D), dt)
        kp, vp, tbl = paged_inputs(gen, lens_np, PAGE, dt, S)
        nbytes = 2 * keys * HKV * D * es + 2 * B * HKV * G * D * es + 4 * B
        by = {name: {c: time_ms(lambda c=c: call(cluster=c), 200) for c in sizes}
              for name, call in (
                  ("decode_attention", lambda **kw: kernel.decode_attention_cuda(
                      q, k, v, lens, **kw)),
                  ("decode_attention_paged", lambda **kw: kernel.decode_attention_paged_cuda(
                      q, kp, vp, tbl, lens, **kw)))}
        picked = kernel.cluster_split(S, B * HKV, kernel.CLUSTER_CTAS_PER_SM[dt][D])
        if dt == torch.float32:
            for name in by:
                out[name].update(ms_by_cluster=by[name], cluster=picked)
            continue
        for name, ms, plain, extra, lib in (
                ("decode_attention", time_ms(lambda: kernel.decode_attention_cuda(q, k, v, lens),
                                             200),
                 time_ms(lambda: ref.decode_attention(q, k, v, lens), 20), 0,
                 time_ms(lambda: _sdpa(q[:, None], k, v, mask), 50)),
                ("decode_attention_paged", time_ms(
                    lambda: kernel.decode_attention_paged_cuda(q, kp, vp, tbl, lens), 200),
                 time_ms(lambda: ref.decode_attention_paged(q, kp, vp, tbl, lens), 20),
                 table_bytes(lens_np), None)):
            b_ms, bound_by = bound_ms(nbytes + extra, 4 * keys * HKV * G * D, dt)
            out[name]["bf16"] = dict(
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=bound_by, library_ms=lib,
                ms_by_cluster=by[name], cluster=picked,
                shape=f"bf16 B={B} S={S} Hkv={HKV} G={G} D={D} lengths={list(map(int, lens_np))}"
                      + ("" if lib is not None else f"; pool {kp.shape[0]}x{PAGE} tables "
                         f"({B},{tbl.shape[1]}); library: {no_call}"))
        del k, v, kp, vp

    # the recovery tier: B=3, paged, max_len 544 (clusters of 4), fp32
    dt, es = torch.float32, 4
    hk, g, d = TIER_HKV, TIER_G, TIER_D
    tier_np = np.random.default_rng(21).integers(512, TIER_S + 1, TIER_B)
    tlens = torch.as_tensor(tier_np, dtype=torch.int32, device="cuda")
    kp, vp, tbl = tier_inputs(gen, tier_np, dt)
    q = _rand(gen, (TIER_B, hk * g, d), dt)
    tkeys = int(tier_np.sum())
    b_ms, bound_by = bound_ms(2 * tkeys * hk * d * es + 2 * TIER_B * hk * g * d * es
                              + 4 * TIER_B + table_bytes(tier_np), 4 * tkeys * hk * g * d, dt)
    out["decode_attention_paged"]["phase_tier_shape"] = dict(
        ms=time_ms(lambda: kernel.decode_attention_paged_cuda(q, kp, vp, tbl, tlens), 200),
        plain_ms=time_ms(lambda: ref.decode_attention_paged(q, kp, vp, tbl, tlens), 20),
        bound_ms=b_ms, bound_by=bound_by, library_ms=None,
        ms_by_cluster={c: time_ms(lambda c=c: kernel.decode_attention_paged_cuda(
            q, kp, vp, tbl, tlens, cluster=c), 200) for c in sizes},
        cluster=kernel.cluster_split(TIER_S, TIER_B * hk, kernel.CLUSTER_CTAS_PER_SM[dt][d]),
        shape=f"fp32 B={TIER_B} pool {kp.shape[0]}x{PAGE} tables ({TIER_B},{tbl.shape[1]}) "
              f"Hkv={hk} G={g} D={d} lengths={tier_np.tolist()}; library: {no_call}")


# --------------------------------------------------------------------------


REPLACES = {
    "ssd": "src/repro/kernels/ssd_scan/kernel.py:75",
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:55",
    "rmsnorm_fused": "src/repro/kernels/rmsnorm/kernel.py:65",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:96",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:103",
    # one launch for both pallas_calls of each split-K function: the partial and the combine
    "decode_attention_splitk": "src/repro/kernels/decode_attention/kernel.py:218 and :272",
    "mixed_attention": "src/repro/kernels/decode_attention/kernel.py:599",
    "decode_attention_paged": "src/repro/kernels/decode_attention/kernel.py:342",
    "decode_attention_paged_splitk": "src/repro/kernels/decode_attention/kernel.py:444 and :511",
    "mixed_attention_paged": "src/repro/kernels/decode_attention/kernel.py:692",
    "wkv6": "src/repro/kernels/rwkv6_scan/kernel.py:75",
}
# the main-path runs whose launches each kernel reports
ZAMBA2_PHASES = ("serve_zamba2", "generate_zamba2", "durable_zamba2")
LAUNCH_PHASES = {
    "flash_attention": ("serve_legacy", "serve_legacy_paged", "generate") + ZAMBA2_PHASES,
    "decode_attention": ("serve_single", "card_vs_cpu", "zamba2_card_vs_cpu",
                         "durable_exact_zamba2", "fleet", "fleet_exact"),
    "decode_attention_splitk": ("serve",) + ZAMBA2_PHASES,
    "mixed_attention": ("serve", "serve_single", "serve_spec", "fleet"),
    "decode_attention_paged": ("serve_single_paged", "card_vs_cpu_paged", "durable_exact_mixed",
                               "durable_exact_legacy", "fleet_recovery"),
    "decode_attention_paged_splitk": ("serve_paged", "durable_kv"),
    "mixed_attention_paged": ("serve_paged", "serve_legacy_paged", "serve_single_paged",
                              "serve_spec_paged", "durable_kv", "fleet_recovery"),
    "wkv6": ("serve_rwkv", "generate_rwkv", "durable_rwkv"),
    "ssd": ZAMBA2_PHASES,
    "rmsnorm": ZAMBA2_PHASES,
    "rmsnorm_fused": ZAMBA2_PHASES,
}
# the fp32 phases whose launches each fp32 route reports: by kernel row,
# (the run, the counter read) for phases 5, 5b, 5c (its legacy runs and its
# card generate), 5d, 5e, 5h (its speculating runs) and 5i
_VS = ("legacy_vs_mixed",)
_SPEC = tuple(("spec_card_vs_cpu", f"{layout}_k{k}") for layout in ("contiguous", "paged")
              for k in (1, 4, 8))
FP32_PHASES = {
    "mixed_attention": ((("card_vs_cpu",), "mixed_attention"),
                        (("fleet_exact",), "mixed_attention"))
    + tuple((run, "mixed_attention") for run in _SPEC if run[1].startswith("contiguous")),
    "mixed_attention_paged": ((("card_vs_cpu_paged",), "mixed_attention_paged"),
                              (_VS + ("paged",), "mixed_attention_paged"),
                              (("durable_exact_mixed",), "mixed_attention_paged"))
    + tuple((run, "mixed_attention_paged") for run in _SPEC if run[1].startswith("paged")),
    "decode_attention_splitk": tuple(
        ((ph,), name) for ph in ("card_vs_cpu", "card_vs_cpu_paged", "zamba2_card_vs_cpu")
        for name in ("decode_attention_splitk", "decode_attention_paged_splitk")),
    "flash_attention": tuple((_VS + (key,), "flash_attention")
                             for key in ("contiguous", "paged", "generate"))
    + tuple(((ph,), "flash_attention")
            for ph in ("zamba2_card_vs_cpu", "durable_exact_legacy", "durable_exact_zamba2")),
    "wkv6": tuple(((ph,), "wkv6") for ph in ("rwkv_card_vs_cpu", "durable_exact_rwkv")),
    "ssd": tuple(((ph,), "ssd") for ph in ("zamba2_card_vs_cpu", "durable_exact_zamba2")),
}


def fp32_launches(runs: dict, name: str) -> dict:
    """The fp32 route's launches in the fp32 phases, by "run/counter"."""
    out = {}
    for path, counter in FP32_PHASES[name]:
        run = runs
        for key in path:
            run = run[key]
        out["/".join(path + (counter,))] = run["launches"][counter]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rmsnorm import kernel as norm_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig

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
    print("  tensor-core kernels (ptxas -v): " + json.dumps(mma), flush=True)
    check(len(mma) == 42, f"expected 42 redesigned kernel instantiations, found {len(mma)}")
    for r in mma:
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0, f"ptxas spills: {r}")
    occ = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt in (torch.bfloat16, torch.float32):
        for d in kernel.HEAD_DIMS:
            for c in (1, 2, 4, 8):
                n, smem = kernel.cluster_occupancy(dt, d, 1 if d == Z_D else G, c)
                check(n >= 1, f"no cluster of {c} single-stage CTAs ({dt}, D={d}) fits the card")
                occ[f"{str(dt)[6:]} D={d} C={c}"] = dict(clusters=n, dynamic_smem_bytes=smem)
                # the chooser's budget: CLUSTER_CTAS_PER_SM CTAs on each SM
                per_sm = kernel.CLUSTER_CTAS_PER_SM[dt][d]
                check(c > 1 or n == sms * per_sm,
                      f"{n} single-stage CTAs ({dt}, D={d}) fit {sms} SMs at once, "
                      f"not the {per_sm} an SM that cluster_split assumes")
    print("  single-stage decode clusters resident at once (G=1 at D=80, else 2): "
          + json.dumps(occ), flush=True)
    mocc = {}
    for d in kernel.HEAD_DIMS:
        for c in (1, 2, 4, 8):
            n, smem = kernel.mixed_occupancy(d, c)
            check(n >= 1, f"no cluster of {c} fp32 mixed-step CTAs (D={d}) fits the card")
            mocc[f"D={d} C={c}"] = dict(clusters=n, dynamic_smem_bytes=smem)
            # the chooser's budget: MIXED_CTAS_PER_SM CTAs on each SM
            per_sm = kernel.MIXED_CTAS_PER_SM[torch.float32][d]
            check(c > 1 or n == sms * per_sm,
                  f"{n} fp32 mixed-step CTAs (D={d}) fit {sms} SMs at once, "
                  f"not the {per_sm} an SM that mixed_cluster assumes")
    print("  fp32 mixed step (cluster_mixed_f32_kernel) clusters resident at once: "
          + json.dumps(mocc), flush=True)

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
    for key, tag, paged in (("serve_single", "4j", False), ("serve_single_paged", "4k", True)):
        t0 = time.perf_counter()
        runs[key] = phase_serve_single(name_line, model, paged=paged)
        free_memory()
        print(f"[{tag}/6] served full-width qwen3-0.6b at max_len {SINGLE_MAX_LEN} "
              f"({'paged ' if paged else ''}single-stage decode) in "
              f"{time.perf_counter() - t0:.1f} s on {name_line}: " + json.dumps(runs[key]),
              flush=True)
    for key, tag, paged in (("serve_spec", "4l", False), ("serve_spec_paged", "4m", True)):
        t0 = time.perf_counter()
        runs[key] = phase_serve_spec(name_line, model, paged=paged)
        free_memory()
        print(f"[{tag}/6] served full-width qwen3-0.6b with speculative decoding (spec_k "
              f"{SPEC_K}, {'paged' if paged else 'contiguous'}) in "
              f"{time.perf_counter() - t0:.1f} s on {name_line}: " + json.dumps(runs[key]),
              flush=True)
    t0 = time.perf_counter()
    runs["durable_kv"] = phase_durable_kv(name_line, model)
    free_memory()
    durable_s = time.perf_counter() - t0
    print(f"[4n/6] durable KV on full-width qwen3-0.6b (paged, mixed admission): 8 frontiers "
          f"out, the session killed, restored with zero prefill, in "
          f"{time.perf_counter() - t0:.1f} s on {name_line}: " + json.dumps(runs["durable_kv"]),
          flush=True)
    del model
    free_memory()
    t0 = time.perf_counter()
    runs["fleet"] = phase_fleet(name_line)
    free_memory()
    fleet_s = time.perf_counter() - t0
    print(f"[4p/6] fleet drill at full width (bf16 qwen3-0.6b, cheap and premium tiers, the "
          f"cheap pool out from 6 to 16 s) in {fleet_s:.1f} s on {name_line}: "
          + json.dumps(runs["fleet"]), flush=True)
    t0 = time.perf_counter()
    runs["fleet_recovery"] = phase_fleet_recovery(name_line)
    free_memory()
    fleet_s += time.perf_counter() - t0
    print(f"[4q/6] durable-KV fleet drill at full width (bf16, paged, kills at 2 and 4 s, a "
          f"preemption at 3 s) in {time.perf_counter() - t0:.1f} s on {name_line}: "
          + json.dumps(runs["fleet_recovery"]), flush=True)

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
    t0 = time.perf_counter()
    runs["durable_rwkv"] = phase_durable_scan(name_line, model)
    durable_s += time.perf_counter() - t0
    print(f"[4o/6] durable state on rwkv6-7b: 2 frontiers out and restored with zero prefill in "
          f"{time.perf_counter() - t0:.1f} s on {name_line}: " + json.dumps(runs["durable_rwkv"]),
          flush=True)
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
    t0 = time.perf_counter()
    runs["durable_zamba2"] = phase_durable_scan(name_line, model)
    durable_s += time.perf_counter() - t0
    print(f"[4o/6] durable state on zamba2-2.7b: 2 frontiers out and restored with zero prefill "
          f"in {time.perf_counter() - t0:.1f} s on {name_line}: "
          + json.dumps(runs["durable_zamba2"]), flush=True)
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
    t0 = time.perf_counter()
    runs["stale_buffers"] = phase_stale_buffers(card_model)
    free_memory()
    print(f"[5g/6] replays after the lengths and tables change equal eager, in "
          f"{time.perf_counter() - t0:.1f} s: " + json.dumps(runs["stale_buffers"]), flush=True)
    t0 = time.perf_counter()
    runs["spec_card_vs_cpu"] = phase_spec_card_vs_cpu(small)
    free_memory()
    print(f"[5h/6] speculative fp32 streams (vocab 16, spec_k 1/4/8, both layouts) equal spec "
          f"off and the CPU, captured equal eager, in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(runs["spec_card_vs_cpu"]), flush=True)
    prompts = prompts_for(np.random.default_rng(11), 10, 16, 120, small.vocab_size)
    for key, legacy in (("durable_exact_mixed", False), ("durable_exact_legacy", True)):
        t0 = time.perf_counter()
        what = "legacy" if legacy else "mixed"
        runs[key] = durable_exact(f"durable 5i {what}", card_model, cpu_model,
                                  EngineConfig(max_len=1024, paged_kv=True, mixed_step=not legacy),
                                  prompts, 24)
        durable_s += time.perf_counter() - t0
        print(f"[5i/6] restored fp32 streams, 4-layer qwen3 paged ({what} admission), equal the "
              f"uninterrupted ones and the CPU's, captured equal eager, in "
              f"{time.perf_counter() - t0:.1f} s: " + json.dumps(runs[key]), flush=True)
    del cpu_model, card_model
    free_memory()
    t0 = time.perf_counter()
    runs["fleet_exact"] = phase_fleet_exact()
    free_memory()
    fleet_s += time.perf_counter() - t0
    print(f"[5j/6] fleet exactness (demo fleet, 4-layer fp32 qwen3, the cheap pool out from 6 "
          f"to 16 s) card vs cpu in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(runs["fleet_exact"]), flush=True)
    for key, tag, zcfg_, n_layers in (("rwkv", "5d", rcfg, 2), ("zamba2", "5e", zcfg, 12)):
        t0 = time.perf_counter()
        runs[f"{key}_card_vs_cpu"], cpu_model, card_model = phase_scan_card_vs_cpu(zcfg_, n_layers)
        free_memory()
        print(f"[{tag}/6] {zcfg_.name} card vs cpu ({n_layers} layers, fp32, 2 slots) in "
              f"{time.perf_counter() - t0:.1f} s: " + json.dumps(runs[f"{key}_card_vs_cpu"]),
              flush=True)
        t0 = time.perf_counter()
        prompts = prompts_for(np.random.default_rng(12), 4, 16, 300, zcfg_.vocab_size)
        runs[f"durable_exact_{key}"] = durable_exact(
            f"durable 5i {key}", card_model, cpu_model, EngineConfig(max_len=512, decode_batch=2),
            prompts, 16)
        durable_s += time.perf_counter() - t0
        print(f"[5i/6] restored fp32 streams, {n_layers}-layer {zcfg_.name} (scan state), equal "
              f"the uninterrupted ones and the CPU's, captured equal eager, in "
              f"{time.perf_counter() - t0:.1f} s: " + json.dumps(runs[f"durable_exact_{key}"]),
              flush=True)
        del cpu_model, card_model
        free_memory()

    lvm = runs["legacy_vs_mixed"]
    eager = {"5": runs["card_vs_cpu"]["eager"], "5b": runs["card_vs_cpu_paged"]["eager"],
             "5c contiguous": lvm["contiguous"]["eager"], "5c paged": lvm["paged"]["eager"],
             "5c generate": lvm["generate"]["eager"], "5d": runs["rwkv_card_vs_cpu"]["eager"],
             "5e": runs["zamba2_card_vs_cpu"]["eager"]}
    print("[5f/6] fp32 traffic of 5-5e captured vs eager (graphs=False) on the card, "
          "token-exact, launches equal: " + json.dumps(eager), flush=True)

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
            **({"head_dim_80": t["d80"]} if "d80" in t else {}),
            **({"fp32": dict(t["fp32"], launches_by_phase=fp32_launches(runs, name))}
               if "fp32" in t else {}),
            **{k: v for k, v in t.items()
               if k.startswith("phase_") or k in ("ms_by_cols", "ms_by_rows", "ms_by_cluster",
                                                  "cluster", "bf16", "partial_ms", "q16")}))
    print(f"durable KV phases (4n, 4o, 5i): {durable_s:.1f} s")
    print(f"fleet phases (4p, 4q, 5j): {fleet_s:.1f} s")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(name_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
