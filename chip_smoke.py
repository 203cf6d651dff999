#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: serve qwen3-0.6b on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. card: name and power limit from nvidia-smi;
2. build: nvcc builds every kernel source of the path (printing ptxas -v);
3. kernels: each CUDA kernel against its plain PyTorch version at the
   serving shapes, in bf16 (atol 2e-2, and each output row's largest error
   within a tenth of that row's RMS) and fp32 (atol 2e-5, rtol 1e-3);
4. serve: EngineClient serves full-width qwen3-0.6b (28 layers, bf16,
   seeded random weights) at the default EngineConfig: 16 requests,
   prompts 16..2000 tokens, 32 new tokens each; launch counters are
   zeroed just before and read just after;
5. card vs CPU: the same kind of traffic at fp32 (full width, 4 layers,
   max_len 1024, prompts up to 900) on the card and on the CPU (plain
   versions); greedy streams must agree token for token, or each first
   divergence must be a near-tie, printed with its logit margin;
6. timing: every kernel, its plain version and the one PyTorch call with
   the same result (scaled_dot_product_attention, used only as a
   yardstick) timed with CUDA events; bounds from the bytes and
   operations of the inputs timed.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

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


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


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
    """Every kernel vs its plain version; returns max abs err per kernel and dtype."""
    from repro_torch.kernels.decode_attention import kernel, ref

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
    torch.cuda.synchronize()
    return errs


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


def phase_serve(name_line: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig

    cfg = get_config("qwen3-0.6b")
    dev = torch.device("cuda")
    model = Model(cfg, device=dev).init_(torch.Generator("cuda").manual_seed(0))
    ecfg = EngineConfig()
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator) outside the counted run
    serve(model, ecfg, prompts_for(rng, 2, 16, 64, cfg.vocab_size), 4, dev)

    prompts = prompts_for(rng, 16, 16, 2000, cfg.vocab_size)
    max_new = 32
    kernel.reset_launches()
    handles, wall, engine = serve(model, ecfg, prompts, max_new, dev)
    launches = dict(kernel.LAUNCHES)
    check_handles(handles, engine, max_new, cfg.vocab_size, "serve")
    for k_ in ("mixed_attention", "decode_attention_splitk_partial",
               "decode_attention_splitk_combine"):
        check(launches[k_] > 0, f"serve: kernel {k_} never launched on the main path")
    ttft = np.array([h.record.ttft_s for h in handles])
    tel = engine.telemetry
    out = dict(
        requests=len(handles), layers=cfg.n_layers, dtype=cfg.dtype, max_new=max_new,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        generated_tokens=int(sum(len(h.result()) for h in handles)),
        wall_s=wall, tokens_per_s=sum(len(h.result()) for h in handles) / wall,
        ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p99_s=float(np.percentile(ttft, 99)),
        mixed_steps=tel.mixed_steps, decode_chunks=tel.chunks,
        launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        card=name_line,
    )
    del model, engine, handles
    torch.cuda.empty_cache()
    return out


def _margin(model, tokens, a: int, b: int) -> float:
    """|logit(a) - logit(b)| after ``tokens`` (one B=1 mixed step)."""
    cache = model.empty_cache(1, len(tokens) + 1)
    t = torch.as_tensor(np.asarray(tokens)[None], device=model.device)
    logits = model.step_mixed(t, cache, np.array([0]), np.array([len(tokens)]))[0]
    return float((logits[a] - logits[b]).abs())


def phase_card_vs_cpu() -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4, dtype="float32")
    ecfg = EngineConfig(max_len=1024)
    cpu_model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(1))
    card_model = Model(cfg, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(1)
    prompts = prompts_for(rng, 16, 16, 900, cfg.vocab_size)
    max_new = 32
    kernel.reset_launches()
    card_h, card_wall, card_eng = serve(card_model, ecfg, prompts, max_new, torch.device("cuda"))
    launches = dict(kernel.LAUNCHES)
    check(launches["decode_attention"] > 0, "card-vs-cpu: single-stage decode never launched")
    check(launches["mixed_attention"] > 0, "card-vs-cpu: mixed kernel never launched")
    cpu_h, cpu_wall, cpu_eng = serve(cpu_model, ecfg, prompts, max_new, torch.device("cpu"))
    check_handles(card_h, card_eng, max_new, cfg.vocab_size, "card fp32")
    check_handles(cpu_h, cpu_eng, max_new, cfg.vocab_size, "cpu fp32")
    exact, ties = 0, []
    for p, hc, hp in zip(prompts, card_h, cpu_h):
        a, b = hc.result(), hp.result()
        if np.array_equal(a, b):
            exact += 1
            continue
        j = int(np.nonzero(a != b)[0][0])
        ctx = list(p) + list(b[:j])
        m_cpu = _margin(cpu_model, ctx, int(a[j]), int(b[j]))
        m_card = _margin(card_model, ctx, int(a[j]), int(b[j]))
        ties.append(dict(rid=hc.rid, position=j, card_token=int(a[j]), cpu_token=int(b[j]),
                         margin_cpu=m_cpu, margin_card=m_card))
        print(f"  stream {hc.rid} diverges at generated token {j}: card {a[j]} vs cpu {b[j]}, "
              f"logit margin {m_cpu:.3e} (cpu) / {m_card:.3e} (card)")
        check(m_cpu < NEAR_TIE, f"stream {hc.rid} diverges at a margin of {m_cpu:.3e} "
                                f">= {NEAR_TIE}: not a near-tie")
    out = dict(requests=len(prompts), exact_streams=exact, near_ties=ties, layers=cfg.n_layers,
               dtype=cfg.dtype, max_len=ecfg.max_len, launches=launches,
               card_wall_s=card_wall, cpu_wall_s=cpu_wall)
    del card_model, card_eng, card_h
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 6: timing and bounds
# --------------------------------------------------------------------------


def time_ms(fn, iters: int, warm: int = 3) -> float:
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

    # single-stage decode: its main path is the fp32 max_len=1024 serving run
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
    return out


# --------------------------------------------------------------------------


REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:103",
    "decode_attention_splitk_partial": "src/repro/kernels/decode_attention/kernel.py:218",
    "decode_attention_splitk_combine": "src/repro/kernels/decode_attention/kernel.py:272",
    "mixed_attention": "src/repro/kernels/decode_attention/kernel.py:599",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel

    t_start = time.perf_counter()
    name_line = card_line()
    print(f"[1/6] card: {name_line}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build([kernel.SOURCE])
    print(f"[2/6] built {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        print(f"  {src.relative_to(ROOT)}:")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("    " + line.strip())

    t0 = time.perf_counter()
    errs = phase_kernels()
    print(f"[3/6] kernels vs plain in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(errs), flush=True)
    print("  worst bf16 row error / row RMS: " + json.dumps(ROW_FRAC), flush=True)

    t0 = time.perf_counter()
    srv = phase_serve(name_line)
    print(f"[4/6] served full-width qwen3-0.6b in {time.perf_counter() - t0:.1f} s "
          f"on {name_line}: " + json.dumps(srv), flush=True)

    t0 = time.perf_counter()
    cmp_ = phase_card_vs_cpu()
    print(f"[5/6] card vs cpu in {time.perf_counter() - t0:.1f} s: " + json.dumps(cmp_),
          flush=True)

    t0 = time.perf_counter()
    tim = phase_timing()
    print(f"[6/6] timing in {time.perf_counter() - t0:.1f} s on {name_line}: "
          + json.dumps(tim), flush=True)

    rows = []
    for name, t in tim.items():
        launches = (cmp_["launches"][name] if name == "decode_attention"
                    else srv["launches"][name])
        e = errs[name]
        rows.append(dict(
            name=name, route="cuda", source=str(kernel.SOURCE.relative_to(ROOT)),
            replaces=REPLACES[name], launches=launches,
            max_abs_err=e[str(torch.bfloat16)], max_abs_err_fp32=e[str(torch.float32)],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"]))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(name_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
