"""Profile the port's serving path on the card with ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve
        [--arch qwen3-0.6b|rwkv6-7b|zamba2-2.7b] [--paged] [--legacy]
        [--max-len 4096] [--eager] [--out build/profile]

Serves a full-width model (all layers, seeded random weights, bf16;
qwen3-0.6b by default) through ``EngineClient`` at the default
``EngineConfig`` (with ``--paged``, ``paged_kv=True``; with ``--legacy``,
``mixed_step=False``: one prefill per admission; rwkv6-7b and
zamba2-2.7b take legacy admission either way, as they have no mixed
step; ``--max-len`` sets the cache length, which picks the decode
attention: split-K at 2048 keys or more, the single-stage cluster kernel
below; the engine's steps run as CUDA graphs, captured before the
profiled run, or with ``--eager`` (``graphs=False``) kernel by kernel,
for the A/B of step time and idle share) -- 8 requests with distinct
prompts of 16 to 1024 tokens, 16 new tokens each -- once to warm up and
once under the profiler, and prints
one JSON line: wall time, device busy time (the union of kernel and
memcpy intervals in the trace) and idle share, time per engine step (a
mixed step, a decode step or a prefill), the top device kernels, the
prefill kernel's share of the device busy time (flash attention, the
WKV6 recurrence for rwkv, or the SSD scan for the hybrid), the
host-side calls that synchronise (``cudaStreamSynchronize``, pageable
``cudaMemcpyAsync``), the decode-attention kernels' launches and device
time, and the device kernels one decode step and one
prefill launch per layer (each counted in a trace of that call alone).
The Chrome trace goes to ``<out>/trace.json``.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model
from repro_torch.serving import EngineClient, EngineConfig, InferenceRequest, ServingEngine

REQUESTS = 8
PROMPT_MAX = 1024
MAX_NEW = 16


def _engine(model, ecfg, eager: bool) -> ServingEngine:
    """An engine whose graphs (unless ``eager``) are captured now: the
    mixed-step grid and the decode chunk, into its next session's state."""
    engine = ServingEngine(model, ecfg, graphs=not eager)
    if engine.graphs:
        engine.warm_mixed_traces([ecfg.prefill_chunk])
        engine.warm_decode()
        torch.cuda.synchronize()
    return engine


def _serve(engine, prompts, max_new):
    client = EngineClient(engine)
    handles = [client.submit(InferenceRequest(prompt=p, max_new=max_new)) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    client.drain()
    torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, engine


def _union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _kernels_in(fn) -> int:
    """Device kernels that ``fn`` launches, from a profiler trace of it alone."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paged", action="store_true", help="serve from the paged KV pool")
    ap.add_argument("--legacy", action="store_true",
                    help="legacy admission (mixed_step=False): one prefill per request")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--max-len", type=int, default=EngineConfig.max_len,
                    help="KV cache length per slot (the engine's default: 4096)")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps kernel by kernel (graphs=False), not as CUDA graphs")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = Model(cfg).init_(torch.Generator("cuda").manual_seed(0))
    ecfg = EngineConfig(paged_kv=args.paged, mixed_step=not args.legacy, max_len=args.max_len)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in np.linspace(16, PROMPT_MAX, REQUESTS).round()]
    _serve(_engine(model, ecfg, args.eager), prompts[:2], 4)        # warm-up
    engine = _engine(model, ecfg, args.eager)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        handles, wall, engine = _serve(engine, prompts, MAX_NEW)
    tel = engine.telemetry
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "trace.json"
    prof.export_chrome_trace(str(trace))

    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e]
    busy_us = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    span_us = (max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)) if dev else 0.0
    kern, kern_n = Counter(), Counter()
    for e in dev:
        if e.get("cat") == "kernel":
            kern[e["name"][:80]] += e["dur"]
            kern_n[e["name"][:80]] += 1
    rt = Counter(e["name"] for e in events if e.get("cat") == "cuda_runtime")
    legacy_prefills = 0 if engine.mixed else tel.prefills
    steps = tel.mixed_steps + tel.chunks * ecfg.decode_chunk + legacy_prefills
    # flash_fwd_mma_kernel in bf16, flash_fwd_kernel in fp32
    # wkv6_ matches the fp32 wkv6_kernel and the bf16 wkv6_chunk_kernel,
    # ssd_ the fp32 ssd_kernel and the bf16 ssd_chunk_kernel
    prefill_kernel = {"rwkv": "wkv6_", "hybrid": "ssd_"}.get(cfg.family, "flash_fwd")
    prefill_us = sum(v for k, v in kern.items() if prefill_kernel in k)

    # kernels per layer: one decode step over the slot batch, one prefill
    cache = model.empty_cache(ecfg.decode_batch, ecfg.max_len)
    tok = torch.zeros((ecfg.decode_batch, 1), dtype=torch.int64, device=model.device)
    lens = torch.full((ecfg.decode_batch,), 16, dtype=torch.int32, device=model.device)
    decode_kernels = _kernels_in(lambda: model.decode(tok, cache, lens))
    prompt = torch.as_tensor(prompts[-1][None], device=model.device)
    prefill_kernels = _kernels_in(lambda: model.prefill(prompt))
    print(json.dumps(dict(
        card=torch.cuda.get_device_name(0), arch=cfg.name, paged_kv=args.paged,
        max_len=ecfg.max_len,
        legacy=not engine.mixed, graphs=engine.graphs, layers=cfg.n_layers,
        requests=len(handles),
        **(dict(graphs_captured=engine._graphs.captured, capture_s=engine._graphs.capture_s,
                graph_pool_gb=engine._graphs.pool_bytes() / 1e9) if engine.graphs else {}),
        prompt_tokens=int(sum(len(p) for p in prompts)), max_new=MAX_NEW,
        wall_s=wall, mixed_steps=tel.mixed_steps, decode_steps=tel.chunks * ecfg.decode_chunk,
        prefills=legacy_prefills, ms_per_step=wall * 1e3 / max(1, steps),
        device_busy_s=busy_us / 1e6, device_span_s=span_us / 1e6,
        device_idle_share=1.0 - busy_us / max(span_us, 1.0),
        prefill_kernel=prefill_kernel, prefill_kernel_ms=prefill_us / 1e3,
        prefill_kernel_share_of_busy=prefill_us / max(busy_us, 1.0),
        decode_kernels_per_layer=decode_kernels / cfg.n_layers,
        prefill_kernels_per_layer=prefill_kernels / cfg.n_layers,
        top_kernels_ms={k: v / 1e3 for k, v in kern.most_common(12)},
        # the decode-attention kernels: the single-stage (cluster_, or
        # flash_rows_ for more than 16 heads per kv head) and split-K ones
        decode_attention_kernels={k: dict(launches=kern_n[k], ms=v / 1e3) for k, v in kern.items()
                                  if any(n in k for n in ("cluster_", "flash_rows", "splitk"))},
        syncs=dict(stream_sync=rt.get("cudaStreamSynchronize", 0),
                   memcpy_async=rt.get("cudaMemcpyAsync", 0),
                   launches=rt.get("cudaLaunchKernel", 0) + rt.get("cudaLaunchKernelExC", 0),
                   graph_launches=rt.get("cudaGraphLaunch", 0)),
        trace=str(trace),
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
