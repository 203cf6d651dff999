"""Deterministic synthetic data pipeline with host-side prefetch (the JAX
package's ``training/data.py``, copied: numpy only).

Every microbatch is a pure function of (seed, step), so resuming from a
checkpoint at step k regenerates exactly the batches k, k+1, ...  The
arrays are those of the JAX pipeline bit for bit.  A background thread
keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    accum_steps: int = 1


def batch_for_step(
    cfg: ModelConfig, shape: InputShape, dcfg: DataConfig, step: int,
    n_patches: int = 576,
) -> Dict[str, np.ndarray]:
    """One global (A, micro, ...) training batch for ``step``."""
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step]))
    A = dcfg.accum_steps
    micro = shape.global_batch // A
    S = shape.seq_len
    if cfg.family == "encoder":
        return {
            "embeds": rng.standard_normal((A, micro, S, cfg.d_model), dtype=np.float32),
            "targets": rng.integers(0, cfg.vocab_size, (A, micro, S), dtype=np.int32),
            "mask": (rng.random((A, micro, S)) < 0.3).astype(np.float32),
        }
    if cfg.family == "vlm":
        s_text = S - n_patches
        return {
            "inputs": rng.integers(0, cfg.vocab_size, (A, micro, s_text), dtype=np.int32),
            "patches": rng.standard_normal((A, micro, n_patches, cfg.d_model), dtype=np.float32),
            "targets": rng.integers(0, cfg.vocab_size, (A, micro, s_text), dtype=np.int32),
        }
    toks = rng.integers(0, cfg.vocab_size, (A, micro, S + 1), dtype=np.int32)
    return {"inputs": toks[..., :-1], "targets": toks[..., 1:]}


class PrefetchIterator:
    """Background-thread prefetch of batch_for_step outputs."""

    def __init__(
        self,
        cfg: ModelConfig,
        shape: InputShape,
        dcfg: DataConfig,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_for_step(self.cfg, self.shape, self.dcfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
