"""Profile the port's serving path on the card with ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--out build/profile]

Serves full-width qwen3-0.6b (all 28 layers, seeded random weights, bf16)
through ``EngineClient`` at the default ``EngineConfig`` -- 8 requests with
prompts of 16 to 1024 tokens, 16 new tokens each -- once to warm up and once
under the profiler, and prints one JSON line: wall time, device busy time
(the union of kernel and memcpy intervals in the trace) and idle share,
time per mixed step and per decode step, the top device kernels, and the
host-side calls that synchronise (``cudaStreamSynchronize``, pageable
``cudaMemcpyAsync``).  The Chrome trace goes to ``<out>/trace.json``.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import EngineClient, EngineConfig, InferenceRequest, ServingEngine

REQUESTS = 8
PROMPT_MAX = 1024
MAX_NEW = 16


def _serve(model, ecfg, prompts, max_new):
    engine = ServingEngine(model, ecfg)
    client = EngineClient(engine)
    handles = [client.submit(InferenceRequest(prompt=p, max_new=max_new)) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    client.drain()
    torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, engine.telemetry


def _union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)

    cfg = get_config("qwen3-0.6b")
    model = Model(cfg).init_(torch.Generator("cuda").manual_seed(0))
    ecfg = EngineConfig()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in np.linspace(16, PROMPT_MAX, REQUESTS).round()]
    _serve(model, ecfg, prompts[:2], 4)                      # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        handles, wall, tel = _serve(model, ecfg, prompts, MAX_NEW)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "trace.json"
    prof.export_chrome_trace(str(trace))

    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e]
    busy_us = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    span_us = (max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)) if dev else 0.0
    kern = Counter()
    for e in dev:
        if e.get("cat") == "kernel":
            kern[e["name"][:80]] += e["dur"]
    rt = Counter(e["name"] for e in events if e.get("cat") == "cuda_runtime")
    steps = tel.mixed_steps + tel.chunks * ecfg.decode_chunk
    print(json.dumps(dict(
        card=torch.cuda.get_device_name(0), layers=cfg.n_layers, requests=len(handles),
        prompt_tokens=int(sum(len(p) for p in prompts)), max_new=MAX_NEW,
        wall_s=wall, mixed_steps=tel.mixed_steps, decode_steps=tel.chunks * ecfg.decode_chunk,
        ms_per_step=wall * 1e3 / max(1, steps),
        device_busy_s=busy_us / 1e6, device_span_s=span_us / 1e6,
        device_idle_share=1.0 - busy_us / max(span_us, 1.0),
        top_kernels_ms={k: v / 1e3 for k, v in kern.most_common(12)},
        syncs=dict(stream_sync=rt.get("cudaStreamSynchronize", 0),
                   memcpy_async=rt.get("cudaMemcpyAsync", 0),
                   launches=rt.get("cudaLaunchKernel", 0)),
        trace=str(trace),
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
