#!/usr/bin/env python3
"""Where the fp32 mixed step's time goes, without a profiler: copies of
``decode_attention.cu`` with one part of ``cluster_mixed_f32_kernel`` left
out, each built and timed at ``chip_smoke.py`` phase 6's fp32 shape
(B=8, Q=8, 8 kv heads, G=2, D=128, a 2048-key window of a 4096-row
cache, phase 6's cache lengths), at cluster sizes 1 and 2.

    python3 mixed_breakdown.py

Variants, each a copy under ``build/breakdown/`` built as the source is:
``full`` (the kernel as it is); ``no_scores``, ``no_softmax``, ``no_pv``
(one of the three passes of each tile left out); ``ring_only`` (all three
left out: the ``cp.async`` ring, the barriers, the epilogue and the
cluster merge remain); ``no_memory`` (the K/V copies left out: the passes
run on whatever shared memory holds); ``empty`` (no walk at all: the
identity states and the cluster merge). Only ``full`` computes the
function, so the others are timed and never checked. Each variant is timed
twice, in turns, queued behind a sleep kernel (``attention_timing.time_ms``).
Prints the card's name and power limit, then one JSON line. Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from attention_timing import time_ms  # noqa: E402

KERNEL = "cluster_mixed_f32_kernel(RowsParams p) {"
# each pass of a tile, from its first line to the line after it
SCORES = ("      {\n        // x[r * 8 + j]",
          "      __syncthreads();                               // the tile's scores are in")
SOFTMAX = ("      {\n        float* sp = st + srw * PR + sk;",
           "      __syncthreads();                               // p and the rescale factors are in")
PV = ("      {\n        float c[8];", "    }\n    attn_mma::cp_async_wait<0>();")
COPIES = ("        attn_mma::cp_async16(ks + j * D + c, k + (ok ? off + c : 0), ok);\n"
          "        attn_mma::cp_async16(ks + KK * D + j * D + c, v + (ok ? off + c : 0), ok);\n")
WALK = "  if (hi > lo) {\n"


def variants(src: str) -> dict:
    """The source with the kernel's body cut as each variant says."""
    a = src.index(KERNEL)
    b = src.index("\n}\n", a)
    body = src[a:b]

    def without(text, *parts):
        for start, end in parts:
            i = text.index(start)
            text = text[:i] + "      {}\n" + text[text.index(end, i):]
        return text

    def swap(text, old, new):
        assert text.count(old) == 1, old
        return text.replace(old, new)

    bodies = {
        "full": body,
        "no_scores": without(body, SCORES),
        "no_softmax": without(body, SOFTMAX),
        "no_pv": without(body, PV),
        "ring_only": without(body, SCORES, SOFTMAX, PV),
        "no_memory": swap(body, COPIES, "        (void)off;\n"),
        "empty": swap(body, WALK, "  if (hi > lo && lo < 0) {\n"),
    }
    return {name: src[:a] + cut + src[b:] for name, cut in bodies.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("mixed_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel

    out_dir = ROOT / "build" / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variants(kernel.SOURCE.read_text()).items():
        paths[name] = out_dir / f"{name}.cu"
        paths[name].write_text(text)
    _build.build(paths.values())
    ref = kernel._lib()
    libs = {}
    for name, path in paths.items():
        lib = _build.load(path)
        lib.flash_rows.argtypes, lib.flash_rows.restype = ref.flash_rows.argtypes, ref.flash_rows.restype
        libs[name] = lib

    rng = np.random.default_rng(2)               # phase 6's draws: the third is the cache lengths
    rng.integers(16, 1025, 8), rng.integers(16, 2033, 8)
    cl_np = rng.integers(0, 2041, 8)
    B, Q, HKV, G, D, W = 8, 8, 8, 2, 128, 2048
    gen = torch.Generator("cuda").manual_seed(12)
    k, v = (torch.randn((B, 4096, HKV, D), generator=gen, device="cuda") for _ in range(2))
    q = torch.randn((B, Q, HKV * G, D), generator=gen, device="cuda")
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device="cuda")
    ms = {name: {c: [] for c in (1, 2)} for name in libs}
    saved = kernel._lib
    try:
        for _ in range(2):
            for name, lib in libs.items():
                kernel._lib = lambda lib=lib: lib
                for c in (1, 2):
                    ms[name][c].append(time_ms(lambda c=c: kernel._mixed(
                        q, k[:, :W], v[:, :W], cl, "mixed_attention", cluster=c), 200))
    finally:
        kernel._lib = saved
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"shape": f"fp32 B={B} Q={Q} window={W} Hkv={HKV} G={G} D={D} "
                               f"cache_lens={cl_np.tolist()}", "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
