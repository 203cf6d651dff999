"""The fixed-shape device state the engine's steps run on, and their CUDA
graphs.

The engine's decode chunk and mixed step read every input from device
buffers of fixed shape and address (``StepState``) and never read back to
the host, so one step function serves both devices: on the card it is
captured once per key as a ``torch.cuda.CUDAGraph`` and replayed
(``StepGraphs``); on the CPU, or with ``graphs=False``, it is called
directly.

* ``StagedInts`` — an int32 device buffer filled before every call by one
  copy from pinned host memory.  Its host side is a ring whose slots are
  rewritten only after the copy that read them has run, so the host can
  queue several steps ahead of the card without a sync.
* ``StepState`` — one session's (or one ``generate`` batch size's) cache
  and step buffers: the carried tokens, the lengths, new lengths, the two
  per-slot flag rows, the block tables, one chunk buffer per q-chunk width,
  the sampling generator, and the graphs captured on them.
* ``StepGraphs`` — capture and replay.  The first call of a key runs the
  step eagerly on the capture stream (the warm-up capture needs: it builds
  the kernel libraries, sets their function attributes and makes the
  split-K counters of that stream) and is that call's result; the capture
  follows, and every later call replays.  Each graph records the kernel
  launches (``kernels.*.LAUNCHES``) its capture counted, which the capture
  itself does not keep and every replay adds back.  The cyclic garbage
  collector is held off during a capture: a collection there can destroy
  an unreachable engine's graphs, events and pinned buffers, calls that a
  capturing stream does not permit, and the capture is then invalidated.
"""
from __future__ import annotations

import functools
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@functools.cache
def _launch_tables() -> List[dict]:
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rmsnorm import kernel as norm_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    return [m.LAUNCHES for m in (kernel, flash_kernel, norm_kernel, wkv_kernel, ssd_kernel)]


class StagedInts:
    """``n`` int32 values on the device at a fixed address, written by
    ``fill`` from pinned host staging with one copy on the current stream."""

    RING = 8

    def __init__(self, n: int, device: torch.device):
        self.dev = torch.zeros(n, dtype=torch.int32, device=device)
        cuda = device.type == "cuda"
        self._host = [torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
                      for _ in range(self.RING if cuda else 1)]
        self._copied = [torch.cuda.Event() for _ in self._host] if cuda else None
        self._i = 0

    def fill(self, *parts) -> None:
        """Write the flattened ``parts`` into the buffer, in order; their
        sizes must add up to the buffer's."""
        parts = [np.ravel(p) for p in parts]
        if sum(p.size for p in parts) != self.dev.numel():
            raise ValueError(f"staged inputs of {[p.size for p in parts]} values do not fill "
                             f"a step buffer of {self.dev.numel()}")
        i = self._i
        self._i = (i + 1) % len(self._host)
        if self._copied is not None:
            self._copied[i].synchronize()        # the copy that last read this slot has run
        host = self._host[i].numpy()
        at = 0
        for p in parts:
            host[at:at + p.size] = p
            at += p.size
        self.dev.copy_(self._host[i], non_blocking=True)
        if self._copied is not None:
            self._copied[i].record()


class StepState:
    """The cache and the fixed-shape step buffers of ``batch`` slots.  The
    host keeps the truth (lengths, tables, flags) and ``stage`` copies it in
    before every call: a graph replays on whatever these buffers hold."""

    def __init__(self, cache, batch: int, *, device: torch.device, n_blocks: int,
                 seed: Optional[int]):
        self.cache = cache
        self.batch = batch
        self.tok = torch.zeros((batch,), dtype=torch.int32, device=device)
        # lens | new_lens | decoding | update | tables (B, n_blocks)
        self.inputs = StagedInts(batch * (4 + n_blocks), device)
        rows = self.inputs.dev[:4 * batch].view(4, batch)
        self.lens, self.new_lens = rows[0], rows[1]
        self.decoding, self.update = rows[2], rows[3]      # per-slot 0/1 flags
        self.tables = self.inputs.dev[4 * batch:].view(batch, n_blocks) if n_blocks else None
        self.chunks: Dict[int, StagedInts] = {}
        self.generator = (torch.Generator(device=device).manual_seed(seed)
                          if seed is not None else None)
        self.graphs: Dict[tuple, "CapturedStep"] = {}

    def stage(self, lens, new_lens, decoding, update, tables=None) -> None:
        """Copy one call's (B,) rows and (B, n_blocks) tables in."""
        self.inputs.fill(lens, new_lens, decoding, update,
                         *(() if self.tables is None else (tables,)))

    def chunk(self, Q: int) -> StagedInts:
        """The (B, Q) chunk-token buffer of q-chunk width ``Q``."""
        if Q not in self.chunks:
            self.chunks[Q] = StagedInts(self.batch * Q, self.tok.device)
        return self.chunks[Q]


class CapturedStep:
    """One captured step: its graph, the outputs its replays write, and the
    kernel launches one replay makes."""

    def __init__(self, graph, outputs, launches: List[Dict[str, int]]):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self):
        self.graph.replay()
        for table, delta in zip(_launch_tables(), self.launches):
            for name, n in delta.items():
                table[name] += n
        return self.outputs


class StepGraphs:
    """Capture and replay of one engine's steps: every graph in one memory
    pool, captured on one side stream, replayed on the current stream in
    the order the session calls them (never two at once, so graphs that
    share the pool never overlap)."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.captured = 0          # graphs captured
        self.capture_s = 0.0       # host seconds in first calls and their captures

    def pool_bytes(self) -> int:
        """Device memory the graphs' pool holds (its segments' total size)."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))

    def run(self, st: StepState, key: tuple, body: Callable):
        """``body()``'s outputs: replayed from ``st``'s graph of ``key``, or
        on the first call run eagerly on the capture stream, then captured."""
        step = st.graphs.get(key)
        if step is not None:
            return step.replay()
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = body()
        tables = _launch_tables()
        before = [dict(t) for t in tables]
        graph = torch.cuda.CUDAGraph()
        if st.generator is not None:
            graph.register_generator_state(st.generator)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = body()
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing: its counts go to the graph
            launched = [{k: t[k] - b[k] for k in t if t[k] != b[k]} for t, b in zip(tables, before)]
            for t, b in zip(tables, before):
                t.update(b)
        cur.wait_stream(self.stream)
        st.graphs[key] = CapturedStep(graph, outputs, launched)
        self.captured += 1
        self.capture_s += time.perf_counter() - t0
        return out
