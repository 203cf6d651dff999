"""Serving engine of the port: the contiguous mixed-batch path.

Counterpart of the JAX package's ``serving/engine.py`` for its default
path (``EngineConfig`` defaults: contiguous KV, ``mixed_step=True``,
``spec_k=0``).  ``QueueSession.pump`` admits requests into free slots,
drives fused prefill+decode ("mixed") steps until this pump's prompts are
ingested — decode slots advance one token in every one — and then runs
one decode chunk of ``decode_chunk`` steps over the whole slot batch.

Differences from the JAX engine, and why:

* The JAX ``lax.scan`` bodies are Python loops; the steps run eagerly on
  PyTorch's stream (CUDA graphs come in a later change).
* The KV cache is updated in place where JAX donated it to the step.
* ``self.tok`` is rebound to a new tensor after every step and never
  written in place: the pump saves each step's ``tok`` for one read after
  its dispatch loop, and an in-place update would make every deferred read
  return the last step's token.
* Idle slots in the decode chunk still decode garbage and write its KV at
  their frozen length (clamped to ``max_len - 1``), exactly as the JAX
  chunk scan does; real writes overwrite it before any mask uncovers it.

Not ported yet (raise ``NotImplementedError``): paged KV and the legacy
``mixed_step=False`` admission (ROADMAP §1 item 5), speculative decoding
(item 7), durable-KV frontiers (item 8).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model


@dataclass
class EngineConfig:
    max_len: int = 4096
    decode_batch: int = 8
    temperature: float = 0.0        # 0 => greedy
    seed: int = 0
    decode_chunk: int = 8           # decode steps between admission points
    mixed_step: bool = True         # fuse prefill chunks into the decode step
    prefill_chunk: int = 64         # token budget per mixed step
    paged_kv: bool = False          # not ported yet (ROADMAP §1 item 5)
    spec_k: int = 0                 # not ported yet (ROADMAP §1 item 7)


@dataclass
class EngineTelemetry:
    """Measured engine-side counters (the JAX engine's, minus the paged,
    recovery and speculative ones this path never moves)."""

    prefills: int = 0                # prompts ingested to completion
    prefill_chunks: int = 0          # prompt chunks dispatched
    mixed_steps: int = 0             # fused prefill+decode dispatches
    chunks: int = 0                  # decode chunks run
    decode_s: float = 0.0            # wall time inside pumps
    useful_tokens: int = 0           # tokens delivered to some request
    wasted_tokens: int = 0           # idle/finished-slot tokens
    completed_requests: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.useful_tokens / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def efficiency(self) -> float:
        total = self.useful_tokens + self.wasted_tokens
        return self.useful_tokens / total if total else 1.0


class ServingEngine:
    """One model-server replica over a ``Model``.  ``device`` defaults to
    the card; it must be the device the model lives on."""

    def __init__(self, model: Model, cfg: EngineConfig, *, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine asked for {self.device}")
        if cfg.paged_kv:
            raise NotImplementedError("paged_kv=True is not ported yet (ROADMAP §1 item 5)")
        if not cfg.mixed_step:
            raise NotImplementedError(
                "mixed_step=False (legacy admission) is not ported yet (ROADMAP §1 item 5)")
        if cfg.spec_k > 0:
            raise NotImplementedError("spec_k > 0 (speculative decoding) is not ported yet "
                                      "(ROADMAP §1 item 7)")
        if not model.supports_mixed_step:
            raise NotImplementedError(f"{model.cfg.name}: the port serves mixed-step models only")
        self.model = model
        self.cfg = cfg
        self.telemetry = EngineTelemetry()

    def new_session(self) -> "QueueSession":
        return QueueSession(self)

    # -- device steps ----------------------------------------------------------
    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy argmax (first maximum, as ``jnp.argmax``) or a temperature
        sample.  Sampled streams follow torch's generator, not jax.random."""
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 generator=generator).reshape(probs.shape[:-1]).to(torch.int32)

    def _mixed_tokens(self, chunks: torch.Tensor, tok: torch.Tensor,
                      is_decode: torch.Tensor) -> torch.Tensor:
        """Column 0 of a decode row is its carried token; prefill rows keep
        their host-built chunk tokens."""
        col0 = torch.arange(chunks.shape[1], device=chunks.device)[None, :] == 0
        return torch.where(is_decode[:, None] & col0, tok[:, None], chunks)

    def _mixed_step(self, cache, chunks: torch.Tensor, tok: torch.Tensor,
                    lens: np.ndarray, new_lens: np.ndarray, is_decode: torch.Tensor,
                    attn_window: int) -> torch.Tensor:
        """ONE step advancing every slot by its ragged suffix (decode slots
        by their carried token, prefill slots by a prompt chunk); attention
        reads only the first ``attn_window`` cache positions.  Returns the
        last-valid-position logits (B, V)."""
        tokens = self._mixed_tokens(chunks, tok, is_decode)
        return self.model.step_mixed(tokens, cache, lens, new_lens, attn_window=attn_window)

    def _chunk_loop(self, cache, tok: torch.Tensor, lens: torch.Tensor,
                    active: torch.Tensor, generator: Optional[torch.Generator],
                    steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ragged decode chunk: every ``active`` slot advances ``steps``
        tokens with its own cache length; inactive slots decode discarded
        garbage at a frozen length.  Returns (next tok, toks (steps, B))."""
        max_row = self.cfg.max_len - 1
        emitted = []
        for _ in range(steps):
            logits = self.model.decode(tok[:, None], cache, lens)
            emitted.append(tok)
            tok = self._sample(logits, generator)
            lens = torch.where(active, torch.clamp(lens + 1, max=max_row), lens)
        return tok, torch.stack(emitted)

    def chunk_quantum(self, token_budget: int) -> int:
        """The fixed q-chunk width a budget implies: pow2(budget / slots)."""
        per_slot = max(1, int(token_budget) // max(1, self.cfg.decode_batch))
        q = 1 << (per_slot - 1).bit_length()
        return min(q, 1 << (self.cfg.max_len - 1).bit_length())


@dataclass
class PumpReport:
    """What one ``QueueSession.pump`` observed."""

    admitted: List[int] = field(default_factory=list)
    emitted: Dict[int, int] = field(default_factory=dict)
    tokens: Dict[int, List[int]] = field(default_factory=dict)
    completed: Dict[int, np.ndarray] = field(default_factory=dict)
    chunk_steps: int = 0
    prefill_chunks: int = 0
    mixed_steps: int = 0
    useful_tokens: int = 0
    wasted_tokens: int = 0
    occupancy: float = 0.0
    wall_s: float = 0.0
    admit_s: float = 0.0
    dispatch_s: float = 0.0
    sync_s: float = 0.0


class QueueSession:
    """Resumable continuous-batching session over one engine (contiguous
    mixed path): ``submit`` any time, ``pump`` one admission + mixed
    steps + decode chunk cycle."""

    def __init__(self, engine: ServingEngine):
        self.eng = engine
        n_slots = engine.cfg.decode_batch
        dev = engine.device
        self.slots = DecodeSlots(n_slots)
        self.cache = engine.model.empty_cache(n_slots, engine.cfg.max_len)
        self.tok = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.generator = None
        if engine.cfg.temperature > 0.0:
            self.generator = torch.Generator(device=dev).manual_seed(engine.cfg.seed)
        self.queue: List[Tuple[int, np.ndarray, int]] = []
        self.results: Dict[int, np.ndarray] = {}
        self._out: Dict[int, List[int]] = {}
        self._admissions = 0
        self._instant: List[int] = []
        self._slo: Dict[int, Tuple[int, int, float, int]] = {}
        self._seq = 0
        self.token_budget = max(1, engine.cfg.prefill_chunk)
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        # host mirror of per-slot cache lengths (the single source of truth
        # for the attention window and the mixed step's KV placement)
        self._lens_host = np.zeros((n_slots,), np.int64)

    # -- request intake -------------------------------------------------------
    def submit(self, rid: int, inp: np.ndarray, max_new: int, *,
               slo_class: str = "interactive", priority: int = 0,
               deadline_s: Optional[float] = None) -> None:
        """Queue a request; admission order is interactive before batch,
        higher priority first, soonest deadline first, then FIFO."""
        if rid in self._out or rid in self.results:
            raise ValueError(f"request id {rid} already in session")
        inp = np.asarray(inp)
        max_new = int(max_new)
        if max_new <= 0:
            self.results[rid] = np.asarray([], np.int64)
            self._instant.append(rid)
            return
        if inp.shape[1] + max_new > self.eng.cfg.max_len:
            raise ValueError(
                f"request {rid}: prompt_len={inp.shape[1]} + "
                f"max_new={max_new} exceeds max_len={self.eng.cfg.max_len}")
        from repro_torch.serving.api import slo_order_key

        deadline_at = (time.monotonic() + deadline_s if deadline_s is not None else math.inf)
        self._slo[rid] = slo_order_key(slo_class, priority, deadline_at, self._seq)
        self._seq += 1
        self._out[rid] = []
        self.queue.append((rid, inp, max_new))

    def _pop_next(self) -> Tuple[int, np.ndarray, int]:
        best = min(range(len(self.queue)), key=lambda i: self._slo[self.queue[i][0]])
        return self.queue.pop(best)

    def _retire(self, rid: int) -> None:
        self._slo.pop(rid, None)

    def cancel(self, rid: int) -> bool:
        """Abandon a request: drop it from the queue, or free its slot
        mid-prefill or mid-decode.  Returns False if it already completed."""
        if rid in self.results:
            return False
        before = len(self.queue)
        self.queue = [q for q in self.queue if q[0] != rid]
        hit = len(self.queue) < before
        for s in np.nonzero(self.slots.request_id == rid)[0]:
            self.slots.request_id[s] = -1
            self.slots.remaining[s] = 0
            hit = True
        for s, st in list(self._prefilling.items()):
            if st["rid"] == rid:
                del self._prefilling[s]
                hit = True
        self._out.pop(rid, None)
        self._retire(rid)
        return hit

    def fits(self, prompt_len: int, max_new: int) -> bool:
        return prompt_len + max_new <= self.eng.cfg.max_len

    @property
    def idle(self) -> bool:
        return (not self.queue and not self._instant and not self._prefilling
                and self.slots.occupancy == 0.0)

    @property
    def load(self) -> int:
        return (len(self.queue) + len(self._prefilling)
                + int(np.sum(self.slots.request_id >= 0)))

    # -- mixed-batch admission ------------------------------------------------
    def _akey(self) -> Optional[torch.Generator]:
        """Per-admission sampling generator (None in greedy mode)."""
        self._admissions += 1
        if self.eng.cfg.temperature <= 0.0:
            return None
        seed = (self.eng.cfg.seed * 1_000_003 + self._admissions) % (2 ** 63)
        return torch.Generator(device=self.eng.device).manual_seed(seed)

    def _admit_mixed(self, s: int, rid: int, inp: np.ndarray, max_new: int) -> None:
        """The prompt enters the slot as pending chunks; nothing is
        dispatched here — it rides the next mixed steps."""
        self._lens_host[s] = 0
        self._prefilling[s] = dict(
            rid=rid, rem=np.asarray(inp)[0].astype(np.int64),
            plen=int(inp.shape[1]), max_new=int(max_new), akey=self._akey())

    def _schedule_chunks(self) -> List[Tuple[int, np.ndarray]]:
        """Token-budget packing for the next mixed step: decode slots take
        one token each; ingesting slots get one chunk quantum each, in SLO
        order, until the budget runs out (at least one is scheduled)."""
        pending = sorted(
            self._prefilling.items(),
            key=lambda kv: (self._slo.get(kv[1]["rid"], (0, 0, math.inf, 0)), kv[0]))
        if not pending:
            return []
        n_decode = int(np.sum(self.slots.request_id >= 0))
        room = max(1, int(self.token_budget) - n_decode)
        quantum = self.eng.chunk_quantum(self.token_budget)
        k = max(1, room // quantum)
        return [(s, st["rem"][:quantum]) for s, st in pending[:k]]

    # -- the loop body --------------------------------------------------------
    def pump(self) -> PumpReport:
        """One cycle: admission -> budget-bounded mixed steps until this
        pump's admissions are ingested -> one decode chunk."""
        eng, slots = self.eng, self.slots
        dev = eng.device
        chunk = max(1, eng.cfg.decode_chunk)
        n_slots = slots.n_slots
        greedy = eng.cfg.temperature <= 0.0
        report = PumpReport()
        t0 = time.perf_counter()
        for rid in self._instant:
            report.completed[rid] = self.results[rid]
        self._instant = []

        for s in slots.free:
            if not self.queue:
                break
            s = int(s)
            if s in self._prefilling:
                continue
            rid, inp, max_new = self._pop_next()
            self._admit_mixed(s, rid, inp, max_new)
            report.admitted.append(rid)
        report.admit_s = time.perf_counter() - t0

        decode_active = slots.request_id >= 0
        report.occupancy = (int(np.sum(decode_active)) + len(self._prefilling)) / n_slots

        def _complete(rid: int) -> None:
            tokens = np.asarray(self._out.pop(rid), np.int64)
            self.results[rid] = tokens
            report.completed[rid] = tokens
            self._retire(rid)

        sched = self._schedule_chunks()
        if not sched and not decode_active.any():
            report.wall_s = time.perf_counter() - t0
            return report

        # ---- the fused prefill+decode steps --------------------------------
        # emitted-token reads are deferred past the loop: each step's tok
        # tensor is kept (self.tok is rebound, never mutated), so the steps
        # queue on the stream with no per-step host sync
        deferred_emits: List[Tuple[torch.Tensor, List[Tuple[int, int]]]] = []
        deferred_done: List[int] = []
        t_disp = time.perf_counter()
        while sched:
            decode_active = slots.request_id >= 0
            Q = eng.chunk_quantum(self.token_budget)
            chunks_np = np.zeros((n_slots, Q), np.int32)
            new_lens = np.zeros((n_slots,), np.int32)
            for s, c in sched:
                chunks_np[s, :len(c)] = c
                new_lens[s] = len(c)
            new_lens[decode_active] = 1
            pairs = [(int(s), int(slots.request_id[s])) for s in np.nonzero(decode_active)[0]]
            deferred_emits.append((self.tok, pairs))
            is_decode = torch.as_tensor(decode_active, device=dev)
            # attention window: pow-2 bucket over the advancing rows' content
            # frontier, floored at Q and capped at max_len
            need = int(np.max(np.where(new_lens > 0, self._lens_host + new_lens, 0)))
            aw = max(1 << (max(1, need) - 1).bit_length(), Q)
            aw = min(aw, eng.cfg.max_len)
            logits = eng._mixed_step(self.cache, torch.as_tensor(chunks_np, device=dev),
                                     self.tok, self._lens_host, new_lens, is_decode, aw)
            self._lens_host += new_lens
            report.mixed_steps += 1
            completing = [s for s, c in sched if len(self._prefilling[s]["rem"]) == len(c)]
            if greedy:
                nxt = eng._sample(logits)
                upd = decode_active.copy()
                upd[completing] = True
                self.tok = torch.where(torch.as_tensor(upd, device=dev), nxt, self.tok)
            else:
                nxt = eng._sample(logits, self.generator)
                tok = torch.where(is_decode, nxt, self.tok)
                for s in completing:
                    first = eng._sample(logits[s][None], self._prefilling[s]["akey"])
                    tok = torch.where(torch.arange(n_slots, device=dev) == s, first, tok)
                self.tok = tok
            report.useful_tokens += len(pairs)
            report.wasted_tokens += n_slots - len(pairs) - len(sched)
            deferred_done.extend(slots.step())
            for s, c in sched:
                stt = self._prefilling[s]
                stt["rem"] = stt["rem"][len(c):]
                report.prefill_chunks += 1
                if len(stt["rem"]) == 0:
                    slots.admit(s, stt["rid"], stt["max_new"])
                    del self._prefilling[s]
                    eng.telemetry.prefills += 1
            sched = self._schedule_chunks()

        t_sync = time.perf_counter()
        report.dispatch_s += t_sync - t_disp
        if deferred_emits:
            vals_all = torch.stack([t for t, _ in deferred_emits]).cpu().numpy()
            for vals, (_, pairs) in zip(vals_all, deferred_emits):
                for s, rid in pairs:
                    val = int(vals[s])
                    self._out[rid].append(val)
                    report.emitted[rid] = report.emitted.get(rid, 0) + 1
                    report.tokens.setdefault(rid, []).append(val)
        for rid in deferred_done:
            _complete(rid)
        report.sync_s += time.perf_counter() - t_sync

        # ---- the decode chunk ----------------------------------------------
        decode_active = slots.request_id >= 0
        if decode_active.any():
            t_disp = time.perf_counter()
            active = torch.as_tensor(decode_active, device=dev)
            lens_dev = torch.as_tensor(self._lens_host, dtype=torch.int32, device=dev)
            self.tok, toks = eng._chunk_loop(
                self.cache, self.tok, lens_dev, active, self.generator, chunk)
            self._lens_host[decode_active] = np.minimum(
                self._lens_host[decode_active] + chunk, eng.cfg.max_len - 1)
            t_sync = time.perf_counter()
            report.dispatch_s += t_sync - t_disp
            toks_np = toks.cpu().numpy()              # ONE transfer per chunk
            for t in range(chunk):
                live = np.nonzero(slots.request_id >= 0)[0]
                for s in live:
                    rid = int(slots.request_id[s])
                    val = int(toks_np[t, s])
                    self._out[rid].append(val)
                    report.emitted[rid] = report.emitted.get(rid, 0) + 1
                    report.tokens.setdefault(rid, []).append(val)
                report.useful_tokens += len(live)
                report.wasted_tokens += n_slots - len(live)
                for rid in slots.step():
                    _complete(rid)
            report.chunk_steps = chunk
            report.sync_s += time.perf_counter() - t_sync

        report.wall_s = time.perf_counter() - t0
        tel = eng.telemetry
        tel.mixed_steps += report.mixed_steps
        tel.prefill_chunks += report.prefill_chunks
        if report.chunk_steps:
            tel.chunks += 1
        tel.decode_s += report.wall_s
        tel.useful_tokens += report.useful_tokens
        tel.wasted_tokens += report.wasted_tokens
        tel.completed_requests += len(report.completed)
        return report


class DecodeSlots:
    """Continuous batching: fixed decode slots, per-slot request ids."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.request_id = np.full(n_slots, -1, dtype=np.int64)
        self.remaining = np.zeros(n_slots, dtype=np.int64)

    @property
    def free(self) -> np.ndarray:
        return np.nonzero(self.request_id < 0)[0]

    @property
    def occupancy(self) -> float:
        return float(np.mean(self.request_id >= 0))

    def admit(self, slot: int, request_id: int, new_tokens: int) -> None:
        self.request_id[slot] = request_id
        self.remaining[slot] = new_tokens

    def step(self) -> list:
        """Advance one decode step; returns request ids that finished."""
        active = self.request_id >= 0
        self.remaining[active] -= 1
        done = np.nonzero(active & (self.remaining <= 0))[0]
        finished = self.request_id[done].tolist()
        self.request_id[done] = -1
        return finished
