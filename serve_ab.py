#!/usr/bin/env python3
"""Captured against eager serving on one CUDA card: ``chip_smoke.py``'s
phases 4 (mixed admission), 4b (mixed, paged), 4c (legacy admission),
4j and 4k (mixed, max_len 1536: the single-stage decode, contiguous and
paged) over full-width qwen3-0.6b (bf16, seeded random weights), each run with
the engine's steps as CUDA graphs (captured before the clock) and with
``graphs=False`` (the same steps kernel by kernel), in turns: captured,
eager, eager, captured.  Run from the repository root:

    python3 serve_ab.py [--phases 4,4b,4c,4j,4k] [--out chiprun_out/serve_ab.jsonl]

Prints the card's name and power limit, one JSON line per run (tokens/s,
TTFT p50/p99, wall, mixed steps, decode chunks, prefills, and for a
captured run its capture time, graph count and graph pool), and a summary
line of the medians per phase and mode.  Each run is held to the same
checks as in the smoke (every request completes, launch counts exact).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
import torch  # noqa: E402

PHASES = {"4": (chip_smoke.phase_serve, dict(paged=False, legacy=False)),
          "4b": (chip_smoke.phase_serve, dict(paged=True, legacy=False)),
          "4c": (chip_smoke.phase_serve, dict(paged=False, legacy=True)),
          "4j": (chip_smoke.phase_serve_single, dict(paged=False)),
          "4k": (chip_smoke.phase_serve_single, dict(paged=True))}
KEYS = ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "wall_s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="4,4b,4c,4j,4k")
    ap.add_argument("--out", default="chiprun_out/serve_ab.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    name_line = chip_smoke.card_line()
    print(name_line, flush=True)
    model = Model(get_config("qwen3-0.6b"), device="cuda").init_(
        torch.Generator("cuda").manual_seed(0))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    with out.open("w") as f:
        for tag in args.phases.split(","):
            for graphs in (True, False, False, True):
                t0 = time.perf_counter()
                phase, kw = PHASES[tag]
                r = phase(name_line, model, graphs=graphs, **kw)
                chip_smoke.free_memory()
                r.update(phase=tag, graphs=graphs, run_s=time.perf_counter() - t0)
                r.pop("launches")
                runs.append(r)
                line = json.dumps(r)
                print(line, flush=True)
                f.write(line + "\n")
    summary = {}
    for tag in args.phases.split(","):
        for graphs in (True, False):
            sel = [r for r in runs if r["phase"] == tag and r["graphs"] == graphs]
            summary[f"{tag} {'captured' if graphs else 'eager'}"] = {
                k: float(np.median([r[k] for r in sel])) for k in KEYS}
    print(json.dumps({"summary": summary, "card": name_line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
