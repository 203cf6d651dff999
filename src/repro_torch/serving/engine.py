"""Serving engine of the port: mixed-batch and legacy admission, contiguous
or paged, speculative decoding, and fixed-batch ``generate``, over the
dense family's KV cache, the rwkv family's constant-size state or the
hybrid family's Mamba-2 states and shared-attention KV.

Counterpart of the JAX package's ``serving/engine.py`` on both cache
layouts.  With ``mixed_step=True`` (the default)
``QueueSession.pump`` admits requests into free slots, drives fused
prefill+decode ("mixed") steps until this pump's prompts are ingested —
decode slots advance one token in every one — and then runs one decode
chunk of ``decode_chunk`` steps over the whole slot batch, or, with the
session's ``spec_k`` above 0, up to ``decode_chunk`` speculative rounds
(``serving/spec.py``: drafts from ``engine.drafter``, verified in one
mixed step with all-position logits).  With
``mixed_step=False`` (legacy admission) every admission is one B=1
``Model.prefill`` placed into its slot (or a ``prefill_paged`` of the
suffix on a prefix hit), then the same decode chunk; legacy sessions
ignore ``spec_k``, as in JAX.  A model without
a mixed step (the rwkv family, ``Model.supports_mixed_step`` False) takes
legacy admission whatever ``mixed_step`` says, as in JAX: its per-slot
cache is a recurrent state (L, B, H, N, N) and two shift rows (L, B, d),
which admission replaces whole for the slot.  So does a model with a
sliding window (mixtral): its contiguous cache is a ring of min(max_len,
W) rows, written by the prefill and every decode step at row p % W.  The
hybrid family (zamba2)
also has no mixed step: admission replaces its conv tails (L, B, K-1, C)
and Mamba-2 states (L, B, H, P, N) whole and writes each shared
application's KV (G, B, S, Hkv, Dh) over [0, S).

With ``EngineConfig.paged_kv`` the per-slot stripes become a shared page
pool (L, P, page_size, Hkv, Dh) read and written through per-slot block
tables, managed by ``paged_kv.BlockAllocator``: admission allocates
``ceil((prompt + max_new) / page_size)`` pages; an identical prompt
decodes straight off its cached logits (copy-on-write of a shared partial
last page first); a block-aligned prefix hit queues only the suffix; a
prompt whose pages another slot is still ingesting waits one pump and
then hits.  The tables live on the host and are copied in before every
step.

Each step the JAX engine jits (the decode chunk ``_chunk_scan`` and its
paged form, ``generate``'s ``_gen_scan``, the mixed step once per (Q,
attention-window) bucket, the spec verify step once per (Q, window)
bucket) is one function here, ``_decode_steps``, ``_mixed_step`` or
``_spec_step``, over the fixed-shape device buffers of a
``steps.StepState``: the host mirrors (``_lens_host``, ``tables``, the
slot flags, the chunk tokens) are copied in from pinned memory before each
call, and the step reads nothing back.  On the card
(``ServingEngine(graphs=None)`` there) each is captured as a CUDA graph
once per key -- (steps,) for the decode chunk and ``generate``, (Q,
window) for the mixed step, ("spec", Q, window) for the verify step,
whose only output is the (3, B, Q) verdict -- and replayed; on the CPU,
or with ``graphs=False``, the same function is called directly.
``warm_mixed_traces``, ``warm_spec_traces`` and ``warm_decode`` capture
ahead of a measured run, into the state the next session takes.  Legacy
admission's ``Model.prefill`` stays eager: JAX jits it per prompt shape,
and no bucket grid bounds those.

Differences from the JAX engine, and why:

* The JAX ``lax.scan`` bodies are Python loops, captured whole on the card.
* A graph holds the addresses of one state's cache and buffers, so graphs
  belong to a session's ``StepState``, not to the engine: a second
  session of one engine captures its own (``mixed_traces`` counts each
  bucket once, as JAX counts each trace once).
* The KV cache is updated in place where JAX donated it to the step.
* The carried tokens live in one static buffer (``StepState.tok``) that
  every step updates in place, so the pump clones each mixed step's
  tokens before the next step for its one read after the dispatch loop
  (a saved reference would read the last step's tokens).
* Idle slots in the decode chunk still decode garbage and write its KV at
  their frozen length (clamped to ``max_len - 1``), exactly as the JAX
  chunk scan does; real writes overwrite it before any mask uncovers it.
* The contiguous mixed step rewrites a Q-row window per slot, its padding
  rows' old contents kept bit for bit (``attention.mixed_write_plan``);
  paged, padding rows go to the trash page, as in JAX.  A full-prompt
  hit's cached logits are kept as fp32 numpy.
* A temperature draw is ``torch.multinomial``'s one-sample form (the
  exponential race) without its host-side checks; on the card the decode
  chunk's and the verify step's generator is registered with their graphs,
  so captured and eager runs draw the same stream from the same seed.  The
  mixed step's draws stay outside its graph.
* A spec round's carried token rides column 0 of its chunk (the host knows
  it from the last verdict), so the round stages no slot as reading
  ``StepState.tok``; the carry is copied back into it after the rounds.

Durable KV: a decoding request leaves a paged session as a
``paged_kv.KVFrontier`` (its tokens, its carried token and a host copy of
its pages) and a scan-state session as a ``backends.StateFrontier`` (a
host copy of its slot's leaves); ``submit(frontier=...)`` in a fresh
session injects it and the request decodes on with no prefill, under
either admission.  Where this differs from the JAX session, and why:

* ``extract_pages`` gathers exactly the frontier's pages; JAX pads the
  gather (and ``_admit_restored`` the inject) to a power-of-two page count
  with the trash page, because ``jit`` traces once per index length.
* The payload is numpy on the host, a bf16 leaf held as float32 (the card's
  machine has no ``ml_dtypes``; bf16 -> float32 is exact), cast back to the
  pool's dtype on restore, so a round trip is bit-exact.
* A restore writes the session's cache in place (``_inject_pages``,
  ``_restore_slot``), where JAX rebinds it: the captured graphs read the
  cache at fixed addresses.  Lengths, tables and the carried token reach
  the steps only through the host mirrors and ``StepState.tok``.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.backends import StateFrontier
from repro_torch.serving.paged_kv import TRASH_PAGE, BlockAllocator, KVFrontier
from repro_torch.serving.spec import (
    Drafter,
    NgramDrafter,
    categorical_draw,
    spec_quantum,
    verify_tokens,
)
from repro_torch.serving.steps import StepGraphs, StepState

# the auto-sized page pool holds this many times the worst-case live set:
# the slack lets finished prompts stay cached for prefix reuse
PAGE_HEADROOM = 1.5


@dataclass
class EngineConfig:
    max_len: int = 4096
    decode_batch: int = 8
    temperature: float = 0.0        # 0 => greedy
    seed: int = 0
    decode_chunk: int = 8           # decode steps between admission points
    mixed_step: bool = True         # fuse prefill chunks into the decode step
    prefill_chunk: int = 64         # token budget per mixed step
    paged_kv: bool = False          # block-based KV with prefix reuse
    page_size: int = 16             # tokens per KV page
    num_pages: int = 0              # 0 => auto-size from decode_batch/max_len
    prefix_reuse: bool = True       # cross-request prompt-prefix sharing
    spec_k: int = 0                 # draft tokens per decode round (0 = off);
                                    # sessions retune it live
    spec_ngram: int = 3             # n-gram length of the default drafter


@dataclass
class EngineTelemetry:
    """Measured engine-side counters (the JAX engine's, plus the host
    seconds of the speculative rounds and their drafting)."""

    prefills: int = 0                # prompts ingested to completion
    prefill_chunks: int = 0          # prompt chunks dispatched
    mixed_steps: int = 0             # fused prefill+decode dispatches
    chunks: int = 0                  # decode chunks run
    decode_s: float = 0.0            # wall time inside pumps
    useful_tokens: int = 0           # tokens delivered to some request
    wasted_tokens: int = 0           # idle/finished-slot tokens
    completed_requests: int = 0
    # paged-KV prefix cache effectiveness (zero when paging is off)
    prefix_hits: int = 0             # full-prompt + block-aligned hits
    prefix_misses: int = 0
    reused_tokens: int = 0           # prompt tokens served from cached pages
    prefilled_tokens: int = 0        # prompt tokens run through the model
    # durable-KV recovery (zero when no frontier is restored)
    recovered_tokens: int = 0        # tokens resumed from injected frontiers
    recomputed_prefill_tokens: int = 0  # prompt tokens of retries run through the model
    # speculative decoding (zero when spec_k is 0): only accepted drafts
    # count toward useful_tokens; a rejected draft is wasted
    drafted_tokens: int = 0          # draft tokens dispatched for verification
    accepted_tokens: int = 0         # drafts that survived verification
    spec_rounds: int = 0             # verify steps with at least one draft
    spec_s: float = 0.0              # wall time of the speculative rounds
    draft_s: float = 0.0             # of which the drafter's

    @property
    def tokens_per_s(self) -> float:
        return self.useful_tokens / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def spec_accept_rate(self) -> float:
        return self.accepted_tokens / self.drafted_tokens if self.drafted_tokens else 0.0

    @property
    def efficiency(self) -> float:
        total = self.useful_tokens + self.wasted_tokens
        return self.useful_tokens / total if total else 1.0

    @property
    def cache_hit_rate(self) -> float:
        total = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / total if total else 0.0


def to_host(leaves) -> List[torch.Tensor]:
    """Device leaves copied to host memory (a copy on the CPU too, so the
    result never aliases a live cache)."""
    return [t.to("cpu", copy=True) for t in leaves]


def host_cast(leaves) -> List[np.ndarray]:
    """Host tensors as numpy: bf16 as float32 (exact), others as they are."""
    return [(t.float() if t.dtype == torch.bfloat16 else t).numpy() for t in leaves]


@contextlib.contextmanager
def _rng_kept(generator: Optional[torch.Generator]):
    """Restore ``generator``'s state after the block (a warm-up's draws)."""
    state = None if generator is None else generator.get_state()
    try:
        yield
    finally:
        if generator is not None:
            generator.set_state(state)


class ServingEngine:
    """One model-server replica over a ``Model``.  ``device`` defaults to
    the card; it must be the device the model lives on.  ``graphs``: run
    the steps as CUDA graphs (the default on the card; ``True`` on the CPU
    raises) or call them directly (the default on the CPU; ``False`` on the
    card runs the same steps eagerly)."""

    def __init__(self, model: Model, cfg: EngineConfig, *, device=None,
                 graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine asked for {self.device}")
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs the card; the engine is on {self.device}")
        if cfg.paged_kv and not model.supports_paged_kv:
            raise ValueError(
                f"paged_kv=True but {model.cfg.name} has no pageable KV cache")
        if not model.cfg.supports_decode:
            raise ValueError(f"{model.cfg.name} (family {model.cfg.family!r}) does not decode: "
                             f"prefill it through Model.prefill")
        self.model = model
        self.cfg = cfg
        self.telemetry = EngineTelemetry()
        # a model without a mixed step (rwkv) takes legacy admission, as in JAX
        self.mixed = bool(cfg.mixed_step) and model.supports_mixed_step
        # the pluggable drafter; sessions read it every speculative round
        self.drafter: Drafter = NgramDrafter(max(1, cfg.spec_ngram))
        # paged-KV resolution (sessions read these): the auto pool holds a
        # max_len request in every slot, times PAGE_HEADROOM so finished
        # prompts can stay cached (page 0 is the reserved trash page)
        self.paged = bool(cfg.paged_kv)
        ps = max(1, cfg.page_size)
        self.max_blocks = -(-cfg.max_len // ps)
        self.num_pages = cfg.num_pages or (
            1 + math.ceil(PAGE_HEADROOM * cfg.decode_batch * self.max_blocks))
        self._graphs = StepGraphs(self.device) if graphs else None
        # (Q, window) mixed and ("spec", Q, window) verify buckets prepared
        self._buckets: set = set()
        self._primed: Optional[StepState] = None    # the next session's state
        self._gen_states: Dict[int, StepState] = {}  # generate's, by batch size

    @property
    def graphs(self) -> bool:
        return self._graphs is not None

    @property
    def mixed_traces(self) -> int:
        """Mixed-step and verify-step buckets (Q, attention window)
        prepared, as the JAX engine counts its traces: by warming or by a
        first use."""
        return len(self._buckets)

    @property
    def captures(self) -> Tuple[int, float]:
        """Graphs this engine's sessions captured, and the host seconds
        their first calls and captures took: (0, 0.0) without graphs."""
        g = self._graphs
        return (0, 0.0) if g is None else (g.captured, g.capture_s)

    def new_session(self) -> "QueueSession":
        return QueueSession(self)

    # -- step states and their graphs ------------------------------------------
    def _session_state(self) -> StepState:
        """The state the next session takes (made here if none is waiting):
        its cache or page pool and step buffers, and the graphs warmed on it."""
        if self._primed is None:
            n = self.cfg.decode_batch
            cache = (self.model.empty_page_pool(self.num_pages, self.cfg.page_size)
                     if self.paged else self.model.empty_cache(n, self.cfg.max_len))
            self._primed = self._step_state(cache, n, self.max_blocks if self.paged else 0)
        return self._primed

    def _take_session_state(self) -> StepState:
        """``_session_state`` for a new session, which keeps it."""
        st, self._primed = self._session_state(), None
        return st

    def _step_state(self, cache, batch: int, n_blocks: int) -> StepState:
        return StepState(cache, batch, device=self.device, n_blocks=n_blocks,
                         seed=self.cfg.seed if self.cfg.temperature > 0.0 else None)

    def _run(self, st: StepState, key: tuple, body):
        return body() if self._graphs is None else self._graphs.run(st, key, body)

    def _decode_call(self, st: StepState, steps: int) -> torch.Tensor:
        return self._run(st, ("decode", steps), lambda: self._decode_steps(st, steps))

    def _mixed_call(self, st: StepState, Q: int, aw: int):
        self._buckets.add((Q, aw))
        return self._run(st, ("mixed", Q, aw), lambda: self._mixed_step(st, Q, aw))

    def _spec_call(self, st: StepState, Qs: int, aw: int) -> torch.Tensor:
        self._buckets.add(("spec", Qs, aw))
        return self._run(st, ("spec", Qs, aw), lambda: self._spec_step(st, Qs, aw))

    def _windows(self, Q: int) -> List[int]:
        """The pow-2 attention-window buckets of q-chunk width Q: Q, 2Q, ...,
        up to max_len (the buckets a session can ever request)."""
        out, aw = [], Q
        while True:
            out.append(min(aw, self.cfg.max_len))
            if out[-1] >= self.cfg.max_len:
                return out
            aw *= 2

    def warm_mixed_traces(self, budgets) -> int:
        """Prepare the mixed-step grid for the given token budgets: for each
        budget's Q quantum, every attention-window bucket, run once on dummy
        inputs (lengths 0, one new token, no decode slot) -- on the card
        captured, into the state the next session takes.  Keeps captures
        out of measured pumps; returns the buckets added (the JAX engine's
        traces compiled)."""
        if not self.mixed:
            return 0
        before = self.mixed_traces
        st = self._session_state()
        n = st.batch
        with _rng_kept(st.generator):
            for Q in sorted({self.chunk_quantum(b) for b in budgets}):
                st.chunk(Q).fill(np.zeros((n, Q), np.int32))
                for aw in self._windows(Q):
                    st.stage(np.zeros(n), np.ones(n), np.zeros(n), np.zeros(n),
                             np.full((n, self.max_blocks), TRASH_PAGE))
                    self._mixed_call(st, Q, aw)
        return self.mixed_traces - before

    def warm_spec_traces(self, ks) -> int:
        """Prepare the verify-step grid for the given draft depths: for
        each depth's column quantum ``spec_quantum(k)``, every attention-
        window bucket, run once on dummy inputs (lengths 0, one new token)
        -- on the card captured, into the state the next session takes --
        so that retuning ``spec_k`` never captures mid-pump.  Returns the
        buckets added (the JAX engine's traces compiled): 0 for a model
        without a mixed step."""
        if not self.mixed:
            return 0
        before = self.mixed_traces
        st = self._session_state()
        n = st.batch
        with _rng_kept(st.generator):
            for Qs in sorted({spec_quantum(k) for k in ks if k > 0}):
                st.chunk(Qs).fill(np.zeros((n, Qs), np.int32))
                for aw in self._windows(Qs):
                    st.stage(np.zeros(n), np.ones(n), np.zeros(n), np.zeros(n),
                             np.full((n, self.max_blocks), TRASH_PAGE))
                    self._spec_call(st, Qs, aw)
        return self.mixed_traces - before

    def warm_decode(self) -> int:
        """Capture the session decode chunk ahead of time, on dummy inputs
        (every slot idle), into the state the next session takes.  Returns
        the graphs captured: 0 on the CPU, or when it is already there."""
        st = self._session_state()
        steps = max(1, self.cfg.decode_chunk)
        if self._graphs is None or ("decode", steps) in st.graphs:
            return 0
        n = st.batch
        with _rng_kept(st.generator):
            st.stage(np.zeros(n), np.zeros(n), np.zeros(n), np.zeros(n),
                     np.full((n, self.max_blocks), TRASH_PAGE))
            self._decode_call(st, steps)
        st.tok.zero_()
        return 1

    # -- single-shot steps and fixed-batch generation ---------------------------
    def prefill(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Any]:
        """``batch['inputs']`` (B, S), with a vlm's ``batch['patches']`` (B,
        Np, d) ahead of them -> last-position logits (B, V) and the prompt
        cache: KV (L, B, Np + S, Hkv, Dh), or the rwkv states and shift rows
        after the prompt."""
        patches = batch.get("patches")
        if patches is not None:
            patches = torch.as_tensor(patches, device=self.device)
        return self.model.prefill(torch.as_tensor(np.asarray(batch["inputs"]),
                                                  device=self.device), patches=patches)

    def generate(self, prompt: Dict[str, Any], steps: int, prompt_len: int) -> np.ndarray:
        """Greedy/temperature generation for a fixed batch of prompts.
        ``prompt['inputs']`` is (B, S_prompt), with a vlm's
        ``prompt['patches']`` (B, Np, d) ahead of them (``prompt_len`` is
        then Np + S_prompt); returns (B, steps) tokens:
        one prefill, the cache padded into a ``max_len`` buffer, then
        ``steps`` decode steps at one shared length.  A temperature above 0
        draws from a ``torch.Generator`` seeded with ``cfg.seed``."""
        if prompt_len + steps > self.cfg.max_len:
            raise ValueError(f"prompt_len={prompt_len} + steps={steps} exceeds "
                             f"max_len={self.cfg.max_len}")
        logits, pcache = self.prefill(prompt)
        B = logits.shape[0]
        st = self._gen_states.get(B)
        if st is None:
            st = self._gen_states[B] = self._step_state(
                self.model.empty_cache(B, self.cfg.max_len), B, 0)
        self._load_prefill(st.cache, pcache)
        if st.generator is not None:
            st.generator.manual_seed(self.cfg.seed)
        st.tok.copy_(self._sample(logits, st.generator))
        st.stage(np.full(B, prompt_len), np.zeros(B), np.ones(B), np.zeros(B))
        return self._decode_call(st, steps).T.cpu().numpy()

    @staticmethod
    def _load_prefill(cache, pcache) -> None:
        """The prefill cache into the fixed decode buffer, leaf by leaf: a KV
        leaf at the head of its zeroed (L, B, max_len, ...) buffer (a
        sliding window's ring rows at the head of the ring); a leaf
        of the buffer's own shape (rwkv states, shift rows, the hybrid's
        conv tails and states) copied whole."""
        for buf, c in zip(cache, pcache):
            if buf.shape != c.shape:
                buf.zero_()
            buf[tuple(slice(0, n) for n in c.shape)] = c

    def _place_slot(self, cache, pcache, slot: int) -> None:
        """Write a B=1 prefill cache into slot ``slot`` of the decode buffer,
        in place, over every leaf at a zero offset in every axis but the
        batch: KV at positions [0, S) (with a sliding window, the prefill's
        ring rows, position p at row p % W, so the offset-0 write places
        every position at its ring row); rwkv states and shift rows, and the
        hybrid's conv tails and Mamba-2 states, replaced whole, so nothing
        an idle slot decoded survives admission."""
        for buf, c in zip(cache, pcache):
            buf[(slice(None), slot) + tuple(slice(0, n) for n in c.shape[2:])] = c[:, 0]

    def _place_pages(self, pool, pcache, pages: List[int]) -> None:
        """Scatter a B=1 prefill cache (L, 1, Sp, Hkv, Dh) into ``pages`` of
        the pool: padded to whole pages with zeros (as the JAX ``jnp.pad``,
        so pools compare page for page), one scatter per leaf."""
        ps = self.cfg.page_size
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for buf, c in ((pool.k, pcache.k), (pool.v, pcache.v)):
            L, _, Sp = c.shape[:3]
            pad = len(pages) * ps - Sp
            c = torch.nn.functional.pad(c[:, 0], (0, 0, 0, 0, 0, pad))
            buf[:, idx] = c.reshape(L, len(pages), ps, *c.shape[2:]).to(buf.dtype)

    # -- device steps ----------------------------------------------------------
    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy argmax (first maximum, as ``jnp.argmax``) or a temperature
        sample: one draw from softmax(logits / T) per row, as
        ``torch.multinomial`` makes it (argmax of p / E, E ~ Exp(1)) but
        without its host-side checks, so a graph can hold it.  Sampled
        streams follow torch's generator, not jax.random."""
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return categorical_draw(torch.softmax(logits.float() / self.cfg.temperature, dim=-1),
                                generator)

    def _mixed_tokens(self, chunks: torch.Tensor, tok: torch.Tensor,
                      is_decode: torch.Tensor) -> torch.Tensor:
        """Column 0 of a decode row is its carried token; prefill rows keep
        their host-built chunk tokens."""
        col0 = torch.arange(chunks.shape[1], device=chunks.device)[None, :] == 0
        return torch.where(is_decode[:, None] & col0, tok[:, None], chunks)

    def _mixed_step(self, st: StepState, Q: int, attn_window: int
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The mixed step, as the card captures it: ONE step advancing every
        slot of ``st`` by its ragged suffix (decode slots, ``st.decoding``,
        by their carried token, prefill slots by the chunk in ``st.chunk(Q)``)
        from ``st.lens`` by ``st.new_lens``; attention reads only the first
        ``attn_window`` cache positions, through ``st.tables`` when paged.
        Returns the last-valid-position logits (B, V) and, greedy, their
        argmax (a temperature draw is made outside, per request)."""
        chunks = st.chunks[Q].dev.view(st.batch, Q)
        tokens = self._mixed_tokens(chunks, st.tok, st.decoding != 0)
        logits = self.model.step_mixed(tokens, st.cache, st.lens, st.new_lens,
                                       page_table=st.tables, attn_window=attn_window)
        return logits, (self._sample(logits) if self.cfg.temperature <= 0.0 else None)

    def _spec_step(self, st: StepState, Qs: int, attn_window: int) -> torch.Tensor:
        """The verify step, as the card captures it: one mixed step over
        ``st.chunk(Qs)`` with all-position logits, every slot advancing by
        ``st.new_lens`` (a speculating slot: its carry in column 0 and d
        drafts after it, ``new_len = 1 + d``) from ``st.lens``, reduced on
        the device by ``verify_tokens`` (draws from ``st.generator``).
        Returns only the (3, B, Qs) verdict: the (B, Qs, V) logits stay
        inside the step (inside the graph's pool on the card).  Rejected
        columns write KV past the slot's accepted frontier; nothing undoes
        them (the session's length mirror never covers them, and the next
        round's writes land on them first)."""
        buf = st.chunks.get(Qs)
        if buf is None:
            raise ValueError(f"no chunk buffer of width {Qs} was filled for this verify step")
        chunks = buf.dev.view(st.batch, Qs)
        tokens = self._mixed_tokens(chunks, st.tok, st.decoding != 0)
        logits = self.model.step_mixed(tokens, st.cache, st.lens, st.new_lens,
                                       page_table=st.tables, attn_window=attn_window,
                                       all_logits=True)
        # column j's logits judge the token in column j + 1 (the last is padding)
        drafts = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
        return self._verify(logits, drafts, st.generator)

    def _verify(self, logits: torch.Tensor, drafts: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """``verify_tokens`` at the engine's temperature."""
        return verify_tokens(logits, drafts, self.cfg.temperature, generator)

    def _decode_steps(self, st: StepState, steps: int) -> torch.Tensor:
        """The decode chunk, as the card captures it: every slot flagged in
        ``st.decoding`` advances ``steps`` tokens from its ``st.lens``;
        the others decode discarded garbage at a frozen length.  Paged,
        every step reads and writes the pool through ``st.tables``.
        Draws from ``st.generator``.  Leaves the next tokens in ``st.tok``
        and returns the emitted ones (steps, B)."""
        max_row = self.cfg.max_len - 1
        active = st.decoding != 0
        tok, lens = st.tok, st.lens
        emitted = []
        for _ in range(steps):
            logits = self.model.decode(tok[:, None], st.cache, lens, page_table=st.tables)
            emitted.append(tok)
            tok = self._sample(logits, st.generator)
            lens = torch.where(active, torch.clamp(lens + 1, max=max_row), lens)
        toks = torch.stack(emitted)
        st.tok.copy_(tok)
        return toks

    def _copy_page(self, pool, src: int, dst: int) -> None:
        """Copy-on-write on the device: page ``src`` into ``dst`` in every
        layer, before a slot writes into a page it shared."""
        pool.k[:, dst] = pool.k[:, src]
        pool.v[:, dst] = pool.v[:, src]

    # -- durable-KV frontiers ----------------------------------------------------
    def gather_pages(self, pool, pages) -> List[torch.Tensor]:
        """``pages`` of every pool leaf, gathered on the device: one gather
        per leaf, (L, nb, ps, Hkv, Dh).  The pool is untouched."""
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=self.device)
        return [buf[:, idx] for buf in pool]

    def extract_pages(self, pool, pages):
        """The ``KVFrontier`` payload: ``pages`` of the pool as host numpy
        leaves (L, nb, ps, Hkv, Dh) in the pool's NamedTuple, gathered on
        the device, copied to the host, then cast there (bf16 to float32)."""
        return type(pool)(*host_cast(to_host(self.gather_pages(pool, pages))))

    def _device_leaf(self, leaf, buf: torch.Tensor, n: int) -> torch.Tensor:
        """A frontier's host leaf on the device in ``buf``'s dtype; raises
        unless it is ``buf``'s shape with ``n`` along axis 1 (pages, or the
        batch axis of a slot)."""
        src = torch.as_tensor(np.asarray(leaf))
        want = (buf.shape[0], n) + tuple(buf.shape[2:])
        if tuple(src.shape) != want:
            raise ValueError(f"frontier leaf of shape {tuple(src.shape)} does not fit {want} "
                             f"of the cache leaf {tuple(buf.shape)}")
        return src.to(self.device).to(buf.dtype)

    def _inject_pages(self, pool, kv, pages) -> None:
        """The inverse of ``extract_pages``: each host leaf (L, nb, ps, Hkv,
        Dh) goes to the device, is cast to the pool's dtype and written into
        ``pages`` in place, so graphs captured on the pool read it."""
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=self.device)
        for buf, leaf in zip(pool, kv, strict=True):
            buf[:, idx] = self._device_leaf(leaf, buf, len(idx))

    def _restore_slot(self, cache, state, slot: int) -> None:
        """Write a ``StateFrontier``'s host leaves (batch axis 1) into slot
        ``slot`` of the cache, in place, cast to each leaf's dtype."""
        self._place_slot(cache, [self._device_leaf(leaf, buf, 1)
                                 for buf, leaf in zip(cache, state, strict=True)], slot)

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
    # paged-KV prefix cache activity this pump (zero when paging is off)
    prefix_hits: int = 0              # admissions served from cached pages
    prefix_misses: int = 0            # admissions that prefilled the whole prompt
    reused_tokens: int = 0            # prompt tokens skipped via the cache
    prefilled_tokens: int = 0         # prompt tokens run through the model
    page_occupancy: float = 0.0       # live fraction of the page pool
    cached_pages: int = 0             # reusable (refcount-0) pages held
    # durable-KV recovery this pump (zero when no frontier moves)
    recovered_tokens: int = 0         # tokens resumed from injected frontiers
    recomputed_prefill_tokens: int = 0  # prompt tokens of retries run through the model
    # speculative decoding this pump (zero when spec_k is 0); only accepted
    # drafts reach emitted, tokens and useful_tokens
    drafted_tokens: int = 0           # draft tokens dispatched for verification
    accepted_tokens: int = 0          # drafts that survived verification
    spec_rounds: int = 0              # verify steps with at least one draft
    spec_s: float = 0.0               # wall time of the speculative rounds
    draft_s: float = 0.0              # of which the drafter's


class QueueSession:
    """Resumable continuous-batching session over one engine (mixed or
    legacy admission, contiguous or paged): ``submit`` any time, ``pump``
    one admission (+ mixed steps) + decode chunk cycle."""

    def __init__(self, engine: ServingEngine):
        self.eng = engine
        n_slots = engine.cfg.decode_batch
        self.slots = DecodeSlots(n_slots)
        self.paged = engine.paged
        # the cache (or page pool), the step buffers and their graphs: the
        # state warm_* captured into, or a fresh one
        self.st = engine._take_session_state()
        # host block tables (the source of truth; copied in before every step)
        self.tables = None
        self.allocator = None
        if self.paged:
            self.allocator = BlockAllocator(engine.num_pages, engine.cfg.page_size,
                                            enable_reuse=engine.cfg.prefix_reuse)
            self.tables = np.full((n_slots, engine.max_blocks), TRASH_PAGE, dtype=np.int32)
            self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
            self._slot_of: Dict[int, int] = {}        # rid -> slot holding its pages
        # scan-state backend: the rwkv and hybrid decode states are
        # per-slot caches (no pages); a frontier is a copy of the slot's leaves
        self.scan_state = (not self.paged
                           and engine.model.cfg.family in ("rwkv", "hybrid"))
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
        # speculative decoding: the live draft depth (0 = off), the rids that
        # opted out, the acceptance EWMA over drafted rounds (None before the
        # first), and each request's prompt, which the drafter reads
        self.spec_k = max(0, int(engine.cfg.spec_k))
        self._no_spec: set = set()
        self.spec_accept_ewma: Optional[float] = None
        self._prompt_of: Dict[int, Tuple[int, ...]] = {}
        # durable KV: rid -> validated frontier awaiting a slot (admission
        # injects it instead of prefilling); the rids whose prefill counts as
        # recomputed; restored tokens replayed through the next report; and
        # the recovery counts the next report takes
        self._frontiers: Dict[int, Any] = {}
        self._recompute: set = set()
        self._restored: List[Tuple[int, List[int]]] = []
        self._pending_recovered = 0
        self._pending_recomputed = 0

    @property
    def cache(self):
        """The session's KV cache, page pool or scan states."""
        return self.st.cache

    # -- request intake -------------------------------------------------------
    def submit(self, rid: int, inp: np.ndarray, max_new: int, *,
               slo_class: str = "interactive", priority: int = 0,
               deadline_s: Optional[float] = None, recompute: bool = False,
               frontier=None, speculate: bool = True) -> None:
        """Queue a request; admission order is interactive before batch,
        higher priority first, soonest deadline first, then FIFO.
        ``speculate=False`` keeps this request out of speculative rounds:
        it decodes one token a round while the rest of the batch drafts.

        ``frontier`` resumes a checkpointed request: admission injects its
        pages (paged) or its state (scan state) and decode goes on from its
        tokens, with no prefill.  A frontier that does not match this
        session (another prompt or page size, the other kind, or a
        contiguous dense session) is ignored and the request prefills; one
        that already holds ``max_new`` tokens completes at once.
        ``recompute`` counts this request's prefill as recomputed work (its
        first prefill completed on a replica that died)."""
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
        if self.paged:
            need = self.allocator.blocks_for(inp.shape[1] + max_new)
            if need > self.allocator.usable:
                raise ValueError(f"request {rid}: needs {need} KV pages but the pool only "
                                 f"has {self.allocator.usable}")
        if recompute:
            self._recompute.add(rid)
        if frontier is not None and self._frontier_fits(frontier, inp):
            if len(frontier.generated) >= max_new:
                # the frontier covers the ask: complete off its tokens
                self.results[rid] = np.asarray(list(frontier.generated[:max_new]), np.int64)
                self._instant.append(rid)
                self._recompute.discard(rid)
                self._pending_recovered += len(frontier.prompt) + max_new
                return
            self._frontiers[rid] = frontier
        from repro_torch.serving.api import slo_order_key

        deadline_at = (time.monotonic() + deadline_s if deadline_s is not None else math.inf)
        self._slo[rid] = slo_order_key(slo_class, priority, deadline_at, self._seq)
        self._seq += 1
        if not speculate:
            self._no_spec.add(rid)
        self._out[rid] = []
        self.queue.append((rid, inp, max_new))

    def _pop_next(self) -> Tuple[int, np.ndarray, int]:
        best = min(range(len(self.queue)), key=lambda i: self._slo[self.queue[i][0]])
        return self.queue.pop(best)

    def _frontier_fits(self, frontier, inp: np.ndarray) -> bool:
        """Whether ``frontier`` can resume ``inp`` here: a ``KVFrontier`` of
        this page size in a paged session, a ``StateFrontier`` in a
        scan-state one, of this prompt."""
        if self.paged:
            ok = (isinstance(frontier, KVFrontier)
                  and frontier.page_size == self.allocator.page_size)
        else:
            ok = self.scan_state and isinstance(frontier, StateFrontier)
        return ok and tuple(int(t) for t in np.asarray(inp)[0]) == tuple(frontier.prompt)

    def _retire(self, rid: int) -> None:
        self._slo.pop(rid, None)
        self._prompt_of.pop(rid, None)
        self._frontiers.pop(rid, None)
        self._recompute.discard(rid)
        self._no_spec.discard(rid)

    def cancel(self, rid: int) -> bool:
        """Abandon a request: drop it from the queue, or free its slot (and
        pages) mid-prefill or mid-decode.  Returns False if it already
        completed."""
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
        if self.paged:
            self._release_rid(rid)
        self._out.pop(rid, None)
        self._retire(rid)
        return hit

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Whether a request of this shape can ever be admitted here (the
        bounds ``submit`` enforces with ValueError, as a predicate)."""
        if prompt_len + max_new > self.eng.cfg.max_len:
            return False
        if self.paged:
            return self.allocator.blocks_for(prompt_len + max_new) <= self.allocator.usable
        return True

    # -- paged-KV bookkeeping -------------------------------------------------
    def prefix_match_len(self, prompt) -> int:
        """Reusable-prefix length of ``prompt`` ((1, Sp) array or token
        tuple) against this session's cache."""
        if not self.paged:
            return 0
        toks = prompt if type(prompt) is tuple else np.asarray(prompt)[0]
        return self.allocator.match_len(toks)

    def _bind_pages(self, s: int, rid: int, pages: List[int]) -> None:
        """Slot ``s`` now holds request ``rid``'s ``pages``: its table row and
        the bookkeeping ``_release_rid`` undoes."""
        self.tables[s, :] = TRASH_PAGE
        self.tables[s, :len(pages)] = pages
        self._slot_pages[s] = pages
        self._slot_of[rid] = s

    def _claim_pages(self, s: int, rid: int, tokens: List[int],
                     total_blocks: int) -> Optional[int]:
        """Reuse the longest cached block-aligned prefix of ``tokens`` and
        allocate the rest of the request's ``total_blocks`` into slot ``s``;
        records the prompt (the drafter and frontiers read it).  Returns the
        reused token count, or None, with every reference rolled back, under
        pool pressure."""
        al = self.allocator
        m, shared = al.match_prefix(tokens)
        pages = [int(p) for p in shared]
        for p in pages:
            al.ref(p)
        if not self._extend_alloc(pages, total_blocks):
            for p in pages:
                al.deref(p)
            return None
        self._bind_pages(s, rid, pages)
        self._prompt_of[rid] = tuple(tokens)
        return m

    def _release_rid(self, rid: int) -> None:
        """Free a request's pages (completion, cancel): deref every page it
        held — private pages free at once, published prompt pages park in
        the LRU for later prefix hits — and trash the table row."""
        s = self._slot_of.pop(rid, None)
        if s is None:
            return
        for p in self._slot_pages[s]:
            self.allocator.deref(p)
        self._slot_pages[s] = []
        self.tables[s, :] = TRASH_PAGE

    def _extend_alloc(self, pages: List[int], total_blocks: int, reserve: int = 0) -> bool:
        """Grow ``pages`` to ``total_blocks`` with fresh pages, all or
        nothing.  The capacity check comes first: alloc() under pressure
        evicts cached pages (their prefix entries are lost for good), so a
        grab that cannot fully succeed must fail before evicting anything.
        ``reserve`` holds back capacity the caller still needs (a COW page)."""
        al = self.allocator
        need = total_blocks - len(pages) + reserve
        if need > al.free_pages + al.cached_pages:
            return False
        added: List[int] = []
        while len(pages) + len(added) < total_blocks:
            p = al.alloc()
            if p is None:                 # unreachable after the check; stay all-or-nothing
                for q in added:
                    al.deref(q)
                return False
            added.append(p)
        pages.extend(added)
        return True

    @property
    def idle(self) -> bool:
        return (not self.queue and not self._instant and not self._prefilling
                and self.slots.occupancy == 0.0)

    @property
    def load(self) -> int:
        return (len(self.queue) + len(self._prefilling)
                + int(np.sum(self.slots.request_id >= 0)))

    def inflight_rids(self) -> List[int]:
        """Incomplete rids, slot occupants first (the requeue set when this
        session's replica dies): decoding, then mid-prefill, then queued."""
        active = [int(r) for r in self.slots.request_id if r >= 0]
        active += [st["rid"] for _, st in sorted(self._prefilling.items())]
        return active + [rid for rid, _, _ in self.queue]

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
        self._prompt_of[rid] = tuple(int(t) for t in np.asarray(inp)[0])
        self._prefilling[s] = dict(
            rid=rid, rem=np.asarray(inp)[0].astype(np.int64),
            plen=int(inp.shape[1]), max_new=int(max_new), akey=self._akey(), tokens=None)

    def _admit_paged_mixed(self, s: int, rid: int, inp: np.ndarray, max_new: int) -> bool:
        """Paged mixed admission.  A full-prompt cache hit decodes at once
        off the cached logits (no model work); anything else allocates the
        request's whole block budget and queues the un-cached suffix as
        pending chunks.  Returns False, with all page state rolled back,
        under pool pressure or while a sibling prompt is mid-ingest."""
        al = self.allocator
        tokens = [int(t) for t in np.asarray(inp)[0]]
        plen = len(tokens)
        total_blocks = al.blocks_for(plen + max_new)

        entry = al.lookup_prompt(tokens)
        if entry is not None:
            if not self._admit_full_hit(s, rid, entry, plen, total_blocks):
                return False
            self.slots.admit(s, rid, max_new)     # decoding immediately
            return True

        if al.enable_reuse and self._ingest_overlap(tokens):
            # another slot is mid-ingest on this prompt (or one sharing whole
            # blocks with it): wait for its publish, then hit the cache
            return False

        m = self._claim_pages(s, rid, tokens, total_blocks)
        if m is None:
            return False
        if m > 0:
            # block-aligned prefix hit: only the suffix goes through the model
            al.stats.prefix_hits += 1
            al.stats.reused_tokens += m
        else:
            al.stats.misses += 1
        self._lens_host[s] = m
        self._prefilling[s] = dict(
            rid=rid, rem=np.asarray(tokens[m:], np.int64), plen=plen,
            max_new=int(max_new), akey=self._akey(), tokens=tokens)
        return True

    def _admit_full_hit(self, s: int, rid: int, entry, plen: int, total_blocks: int) -> bool:
        """Full-prompt cache hit (both admissions): no model work; the cached
        logits give the first token.  The partial boundary page takes this
        request's first decode write, so if another reader holds it, it is
        copied first (the copy's page reserved before anything is evicted).
        Records the prompt.  Returns False, with every reference rolled
        back, under pressure."""
        eng, al = self.eng, self.allocator
        pages = [int(p) for p in entry.pages]
        for p in pages:
            al.ref(p)
        bi = plen // al.page_size
        cow_needed = bool(plen % al.page_size) and al.refcount[pages[bi]] > 1
        ok = self._extend_alloc(pages, total_blocks, reserve=1 if cow_needed else 0)
        if ok and cow_needed:
            fresh = al.cow(pages[bi])
            if fresh is None:
                ok = False
            else:
                eng._copy_page(self.cache, pages[bi], fresh)
                pages[bi] = fresh
        if not ok:
            for p in pages:
                al.deref(p)
            return False
        self._bind_pages(s, rid, pages)
        self._prompt_of[rid] = entry.tokens
        logits = torch.as_tensor(entry.logits, device=eng.device)[None]
        self._set_tok(s, eng._sample(logits, self._akey()))
        self._lens_host[s] = plen
        al.stats.full_hits += 1
        al.stats.reused_tokens += plen
        return True

    def _set_tok(self, s: int, tok0: torch.Tensor) -> None:
        """Slot ``s``'s carried token, written into the step buffer."""
        self.st.tok[s:s + 1].copy_(tok0.reshape(1))

    # -- durable-KV checkpoint and restore ---------------------------------------
    @property
    def supports_frontiers(self) -> bool:
        """Paged sessions copy KV pages out, scan-state sessions their slot's
        leaves; a contiguous dense session has no frontiers (a ``max_len``
        stripe copy per checkpoint is not worth paying), as in JAX."""
        return self.paged or self.scan_state

    def extract_frontier(self, rid: int):
        """Copy one decoding request's resumable state out: its prompt, the
        tokens generated so far, the carried next token, and a host copy of
        its pages (paged) or its slot's leaves (scan state) covering them.
        None for a request not decoding (queued or mid-prefill: its retry is
        a plain prefill) and in a session without frontiers."""
        if self.scan_state:
            return self._extract_frontier_state(rid)
        if not self.paged:
            return None
        s = self._slot_of.get(rid)
        if s is None or int(self.slots.request_id[s]) != rid:
            return None
        prompt = self._prompt_of.get(rid)
        if prompt is None:
            return None
        # a request in flight never reaches the max_len - 1 clamp, so the
        # host's bookkeeping is its cache length
        generated = tuple(self._out.get(rid, ()))
        n = len(prompt) + len(generated)
        if n <= 0:
            return None
        al = self.allocator
        pages = al.extract_kv(self._slot_pages[s][:al.blocks_for(n)])
        return KVFrontier(prompt=prompt, generated=generated, carry_tok=int(self.st.tok[s]),
                          pages_kv=self.eng.extract_pages(self.cache, pages),
                          page_size=al.page_size)

    def _extract_frontier_state(self, rid: int) -> Optional[StateFrontier]:
        """Scan-state checkpoint: the slot's slice of every cache leaf, the
        batch axis kept as a singleton, copied to the host."""
        hits = np.nonzero(self.slots.request_id == rid)[0]
        if hits.size == 0:
            return None
        s = int(hits[0])
        prompt = self._prompt_of.get(rid)
        if prompt is None:
            return None
        state = type(self.cache)(*host_cast(to_host(leaf[:, s:s + 1] for leaf in self.cache)))
        return StateFrontier(prompt=prompt, generated=tuple(self._out.get(rid, ())),
                             carry_tok=int(self.st.tok[s]), state=state)

    def extract_frontiers(self) -> List[Tuple[int, Any]]:
        """Checkpoint every decoding request."""
        out = []
        for r in self.slots.request_id:
            if r >= 0:
                fr = self.extract_frontier(int(r))
                if fr is not None:
                    out.append((int(r), fr))
        return out

    def decoding_lens(self) -> Dict[int, int]:
        """rid -> current frontier length of every decoding request, from
        the host's bookkeeping (no device read)."""
        out: Dict[int, int] = {}
        for r in self.slots.request_id:
            rid = int(r)
            if rid >= 0 and rid in self._prompt_of:
                out[rid] = len(self._prompt_of[rid]) + len(self._out.get(rid, ()))
        return out

    def _admit_restored(self, s: int, rid: int, fr, max_new: int) -> bool:
        """Admit straight into decode from a frontier: the slot takes the
        checkpointed KV (fresh pages) or state, and decodes on from the
        carried token, with no prefill.  Counts an admission without a draw,
        as JAX does, so later admissions' generators stay aligned.  Returns
        False, with no state change, under pool pressure (paged only)."""
        n = fr.tokens
        gen = list(fr.generated)
        if self.paged:
            al = self.allocator
            pages = al.inject_kv(al.blocks_for(len(fr.prompt) + max_new))
            if pages is None:
                return False
            self.eng._inject_pages(self.cache, fr.pages_kv, pages[:al.blocks_for(n)])
            self._bind_pages(s, rid, pages)
        else:
            self.eng._restore_slot(self.cache, fr.state, s)
        self._prompt_of[rid] = tuple(fr.prompt)
        self._set_tok(s, torch.tensor(int(fr.carry_tok), dtype=torch.int32))
        self._lens_host[s] = n
        self._out[rid] = list(gen)
        self._admissions += 1
        self.slots.admit(s, rid, max_new - len(gen))
        # the checkpointed tokens replay through the next report: a streaming
        # client reconciles by position and forwards only what it has not seen
        self._restored.append((rid, gen))
        self._pending_recovered += n
        return True

    def _drain_recovery(self, report: PumpReport) -> None:
        report.recovered_tokens += self._pending_recovered
        report.recomputed_prefill_tokens += self._pending_recomputed
        self._pending_recovered = 0
        self._pending_recomputed = 0

    def _emit_restored(self, report: PumpReport) -> None:
        for rid, toks in self._restored:
            if rid in self._out and toks:
                report.emitted[rid] = report.emitted.get(rid, 0) + len(toks)
                report.tokens.setdefault(rid, []).extend(toks)
        self._restored = []

    # -- legacy admission (mixed_step=False) ------------------------------------
    def _admit_prefill(self, s: int, rid: int, inp: np.ndarray) -> None:
        """Contiguous legacy admission: one B=1 prefill dispatch, its cache
        placed into slot ``s``, the first token sampled from its logits.  A
        scan-state session records the prompt, which its frontiers carry."""
        eng = self.eng
        logits, pcache = eng.prefill({"inputs": inp})
        eng._place_slot(self.cache, pcache, s)
        self._lens_host[s] = inp.shape[1]
        self._set_tok(s, eng._sample(logits, self._akey()))
        if self.scan_state:
            self._prompt_of[rid] = tuple(int(t) for t in np.asarray(inp)[0])
        if rid in self._recompute:
            self._pending_recomputed += int(inp.shape[1])
        eng.telemetry.prefills += 1

    def _admit_paged(self, s: int, rid: int, inp: np.ndarray, max_new: int) -> bool:
        """Paged legacy admission: a full-prompt hit decodes off the cached
        logits; a block-aligned prefix hit runs only the suffix, through
        ``Model.prefill_paged`` into the reused pages; a miss prefills the
        whole prompt and scatters it into fresh pages.  Both prefills
        publish the prompt so a repeat takes the full-hit path.  Returns
        False, with all page state rolled back, under pool pressure."""
        eng, al = self.eng, self.allocator
        tokens = [int(t) for t in np.asarray(inp)[0]]
        plen = len(tokens)
        total_blocks = al.blocks_for(plen + max_new)
        entry = al.lookup_prompt(tokens)
        if entry is not None:
            return self._admit_full_hit(s, rid, entry, plen, total_blocks)

        m = self._claim_pages(s, rid, tokens, total_blocks)
        if m is None:
            return False
        nb_p = al.blocks_for(plen)
        pages = self._slot_pages[s]
        if m > 0:
            # block-aligned prefix hit: the first m tokens never touch the model
            suffix = torch.as_tensor(np.asarray([tokens[m:]]), device=eng.device)
            logits = eng.model.prefill_paged(suffix, self.cache, self.tables[s], m)
            al.stats.prefix_hits += 1
            al.stats.reused_tokens += m
        else:
            logits, pcache = eng.prefill({"inputs": inp})
            eng._place_pages(self.cache, pcache, pages[:nb_p])
            al.stats.misses += 1
        al.publish(tokens, pages[:nb_p], logits[0].float().cpu().numpy())
        al.stats.prefilled_tokens += plen - m
        if rid in self._recompute:
            self._pending_recomputed += plen - m
        eng.telemetry.prefills += 1
        self._set_tok(s, eng._sample(logits, self._akey()))
        self._lens_host[s] = plen
        return True

    def _ingest_overlap(self, tokens: List[int]) -> bool:
        """Whether a slot is ingesting a prompt this one would share cached
        pages with once published: the same prompt, or one equal to it
        over their common whole blocks."""
        ps = self.allocator.page_size
        for st in self._prefilling.values():
            ft = st["tokens"]
            if ft is None:
                continue
            if tokens == ft:
                return True
            nb = min(len(tokens), len(ft)) // ps
            if nb > 0 and tokens[:nb * ps] == ft[:nb * ps]:
                return True
        return False

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
        """One engine cycle; safe to call when idle.  Mixed admission (the
        default): admission -> budget-bounded mixed steps until this pump's
        admissions are ingested -> one decode chunk.  Legacy admission
        (``mixed_step=False``): one prefill dispatch per admission -> one
        decode chunk."""
        return self._pump_mixed() if self.eng.mixed else self._pump_legacy()

    def _pump_start(self, report: PumpReport) -> Optional[Tuple[int, int, int, int]]:
        """Report last pump's instant completions; snapshot the prefix-cache
        totals the report's deltas are taken from (None when not paged)."""
        for rid in self._instant:
            report.completed[rid] = self.results[rid]
        self._instant = []
        if not self.paged:
            return None
        st = self.allocator.stats
        return st.full_hits + st.prefix_hits, st.misses, st.reused_tokens, st.prefilled_tokens

    def _paged_report_tail(self, report: PumpReport,
                           stats0: Optional[Tuple[int, int, int, int]]) -> None:
        if stats0 is None:
            return
        st = self.allocator.stats
        report.prefix_hits = st.full_hits + st.prefix_hits - stats0[0]
        report.prefix_misses = st.misses - stats0[1]
        report.reused_tokens = st.reused_tokens - stats0[2]
        report.prefilled_tokens = st.prefilled_tokens - stats0[3]
        # sampled after releases: a draining session reports decaying
        # occupancy, not the admission-time peak
        report.page_occupancy = self.allocator.occupancy
        report.cached_pages = self.allocator.cached_pages

    def _complete(self, rid: int, report: PumpReport) -> None:
        tokens = np.asarray(self._out.pop(rid), np.int64)
        self.results[rid] = tokens
        report.completed[rid] = tokens
        self._retire(rid)
        if self.paged:
            self._release_rid(rid)

    def _pump_legacy(self) -> PumpReport:
        """One admission pass (a prefill dispatch per admitted request) and
        one decode chunk."""
        slots = self.slots
        report = PumpReport()
        t0 = time.perf_counter()
        stats0 = self._pump_start(report)
        for s in slots.free:
            if not self.queue:
                break
            s = int(s)
            rid, inp, max_new = self._pop_next()
            fr = self._frontiers.pop(rid, None)
            if fr is not None:
                if not self._admit_restored(s, rid, fr, max_new):
                    # page pressure: requeue with the frontier intact, so the
                    # retry still resumes instead of prefilling
                    self._frontiers[rid] = fr
                    self.queue.insert(0, (rid, inp, max_new))
                    break
                report.admitted.append(rid)
                continue
            if self.paged:
                if not self._admit_paged(s, rid, inp, max_new):
                    # page pressure: put it back and retry after decodes
                    # release pages (completions free at chunk boundaries)
                    self.queue.insert(0, (rid, inp, max_new))
                    break
            else:
                self._admit_prefill(s, rid, inp)
            slots.admit(s, rid, max_new)
            report.admitted.append(rid)
        self._emit_restored(report)
        report.admit_s = time.perf_counter() - t0
        report.occupancy = slots.occupancy
        if report.occupancy > 0.0:
            self._decode_chunk(report)
        self._paged_report_tail(report, stats0)
        self._drain_recovery(report)
        report.wall_s = time.perf_counter() - t0
        # an idle pump records nothing, its recovery counts included (as JAX)
        if report.chunk_steps:
            self._add_telemetry(report)
        return report

    def _pump_mixed(self) -> PumpReport:
        """Admission -> mixed steps until this pump's prompts are ingested ->
        one decode chunk."""
        eng, slots, st = self.eng, self.slots, self.st
        dev = eng.device
        n_slots = slots.n_slots
        greedy = eng.cfg.temperature <= 0.0
        report = PumpReport()
        t0 = time.perf_counter()
        stats0 = self._pump_start(report)

        for s in slots.free:
            if not self.queue:
                break
            s = int(s)
            if s in self._prefilling:
                continue
            rid, inp, max_new = self._pop_next()
            fr = self._frontiers.pop(rid, None)
            if fr is not None:
                if not self._admit_restored(s, rid, fr, max_new):
                    # page pressure: requeue with the frontier intact
                    self._frontiers[rid] = fr
                    self.queue.insert(0, (rid, inp, max_new))
                    break
            elif self.paged:
                if not self._admit_paged_mixed(s, rid, inp, max_new):
                    # page pressure or a sibling mid-ingest: put it back and
                    # retry next pump (completions release pages)
                    self.queue.insert(0, (rid, inp, max_new))
                    break
            else:
                self._admit_mixed(s, rid, inp, max_new)
            report.admitted.append(rid)
        self._emit_restored(report)
        report.admit_s = time.perf_counter() - t0

        decode_active = slots.request_id >= 0
        report.occupancy = (int(np.sum(decode_active)) + len(self._prefilling)) / n_slots

        sched = self._schedule_chunks()
        if not sched and not decode_active.any():
            self._paged_report_tail(report, stats0)
            self._drain_recovery(report)
            report.wall_s = time.perf_counter() - t0
            return report

        # ---- the fused prefill+decode steps --------------------------------
        # emitted-token reads are deferred past the loop: each step's carried
        # tokens are cloned out of the step buffer, which the next step
        # overwrites, so the steps queue on the stream with no per-step sync
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
            completing = [s for s, c in sched if len(self._prefilling[s]["rem"]) == len(c)]
            upd = decode_active.copy()                 # slots whose token this step sets
            upd[completing] = True
            pairs = [(int(s), int(slots.request_id[s])) for s in np.nonzero(decode_active)[0]]
            deferred_emits.append((st.tok.clone(), pairs))
            # attention window: pow-2 bucket over the advancing rows' content
            # frontier, floored at Q and capped at max_len
            need = int(np.max(np.where(new_lens > 0, self._lens_host + new_lens, 0)))
            aw = max(1 << (max(1, need) - 1).bit_length(), Q)
            aw = min(aw, eng.cfg.max_len)
            st.stage(self._lens_host, new_lens, decode_active, upd, self.tables)
            st.chunk(Q).fill(chunks_np)
            logits, nxt = eng._mixed_call(st, Q, aw)
            self._lens_host += new_lens
            report.mixed_steps += 1
            if greedy:
                st.tok.copy_(torch.where(st.update != 0, nxt, st.tok))
            else:
                nxt = eng._sample(logits, st.generator)
                tok = torch.where(st.decoding != 0, nxt, st.tok)
                for s in completing:
                    first = eng._sample(logits[s][None], self._prefilling[s]["akey"])
                    tok = torch.where(torch.arange(n_slots, device=dev) == s, first, tok)
                st.tok.copy_(tok)
            # a prompt completing this step publishes its last-position logits
            published = (dict(zip(completing, logits[completing].float().cpu().numpy()))
                         if self.paged and completing else None)
            report.useful_tokens += len(pairs)
            report.wasted_tokens += n_slots - len(pairs) - len(sched)
            deferred_done.extend(slots.step())
            for s, c in sched:
                stt = self._prefilling[s]
                stt["rem"] = stt["rem"][len(c):]
                report.prefill_chunks += 1
                if stt["rid"] in self._recompute:
                    self._pending_recomputed += len(c)
                if self.paged:
                    self.allocator.stats.prefilled_tokens += len(c)
                if len(stt["rem"]) == 0:
                    if self.paged:
                        al = self.allocator
                        al.publish(stt["tokens"], self._slot_pages[s][:al.blocks_for(stt["plen"])],
                                   published[s])
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
            self._complete(rid, report)
        report.sync_s += time.perf_counter() - t_sync

        if (slots.request_id >= 0).any():
            if self.spec_k > 0:
                # speculative rounds replace the decode chunk: each one
                # advances every decoding slot by 1 + its accepted drafts
                self._decode_speculative(report)
            else:
                self._decode_chunk(report)
        self._paged_report_tail(report, stats0)
        self._drain_recovery(report)
        report.wall_s = time.perf_counter() - t0
        self._add_telemetry(report)
        return report

    def _decode_chunk(self, report: PumpReport) -> None:
        """One decode chunk over the whole slot batch (both admissions):
        ``decode_chunk`` steps, ONE transfer of the emitted tokens, then
        the completions."""
        eng, slots = self.eng, self.slots
        chunk = max(1, eng.cfg.decode_chunk)
        n_slots = slots.n_slots
        decode_active = slots.request_id >= 0
        t_disp = time.perf_counter()
        none = np.zeros(n_slots)
        self.st.stage(self._lens_host, none, decode_active, none, self.tables)
        toks = eng._decode_call(self.st, chunk)
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
                self._complete(rid, report)
        report.chunk_steps = chunk
        report.sync_s += time.perf_counter() - t_sync

    def _decode_speculative(self, report: PumpReport) -> None:
        """The decode phase with speculation on: up to ``decode_chunk``
        draft + verify rounds in place of the decode chunk.

        Per round the drafter proposes up to ``min(spec_k, remaining - 1,
        Qs - 1)`` tokens per decoding slot from its whole history (prompt,
        generated tokens, carry: all known on the host); the carry and the
        drafts fill columns 0..d of one verify step of width ``Qs =
        spec_quantum(spec_k)`` (``new_len = 1 + d``; an opted-out or
        missing slot runs d = 0); one (3, B, Qs) read of the verdict, and
        the host emits the carry and the longest accepted prefix and takes
        the next carry.  The carry is read from ``StepState.tok`` once at
        the start and copied back at the end; in between the verdicts keep
        it on the host.  The round's sync is inherent: the next drafts need
        this round's tokens.

        Rejected columns already wrote KV past the accepted frontier, and
        nothing undoes them: ``_lens_host`` only advances by what was
        emitted, so those rows stay masked until the next round's writes
        land on them.  The contiguous window keeps its other rows bit for
        bit; paged, every page at or past a slot's write frontier is its
        own by the copy-on-write invariant of admission, so no shared
        prefix page is written and no allocator call is needed."""
        eng, slots, st = self.eng, self.slots, self.st
        n_slots = slots.n_slots
        Qs = spec_quantum(self.spec_k)
        drafter = eng.drafter
        none = np.zeros(n_slots)
        t_start = time.perf_counter()
        carry = st.tok.cpu().numpy().astype(np.int64)      # ONE carry read
        executed = 0
        for _ in range(max(1, eng.cfg.decode_chunk)):
            active = np.nonzero(slots.request_id >= 0)[0]
            if len(active) == 0:
                break
            t_draft = time.perf_counter()
            chunks_np = np.zeros((n_slots, Qs), np.int32)
            new_lens = np.zeros((n_slots,), np.int32)
            d_of = np.zeros((n_slots,), np.int64)
            for s in active:
                rid = int(slots.request_id[s])
                # never draft past the request's budget: carry + accepted <=
                # remaining keeps completions exact and writes inside its pages
                k = min(self.spec_k, int(slots.remaining[s]) - 1, Qs - 1)
                drafts: List[int] = []
                if k > 0 and rid not in self._no_spec:
                    ctx = list(self._prompt_of.get(rid, ()))
                    ctx += self._out[rid]
                    ctx.append(int(carry[s]))
                    drafts = drafter.propose(ctx, k)[:k]
                d_of[s] = len(drafts)
                chunks_np[s, 0] = carry[s]
                chunks_np[s, 1:1 + len(drafts)] = drafts
                new_lens[s] = 1 + len(drafts)
            # the attention window: the mixed loop's pow-2 rule, floored at
            # Qs so that (Qs, window) stays on the warm_spec_traces grid
            need = int(np.max(self._lens_host[active] + new_lens[active]))
            aw = min(max(1 << (max(1, need) - 1).bit_length(), Qs), eng.cfg.max_len)
            t_disp = time.perf_counter()
            report.draft_s += t_disp - t_draft
            st.stage(self._lens_host, new_lens, none, none, self.tables)
            st.chunk(Qs).fill(chunks_np)
            verdict = eng._spec_call(st, Qs, aw)
            t_sync = time.perf_counter()
            v = verdict.cpu().numpy()                 # ONE (3, B, Qs) read a round
            counts = np.zeros(n_slots, np.int64)
            drafted = accepted = 0
            for s in active:
                rid = int(slots.request_id[s])
                d = int(d_of[s])
                a = 0
                while a < d and v[0, s, a]:
                    a += 1
                vals = [int(carry[s])] + [int(t) for t in chunks_np[s, 1:1 + a]]
                self._out[rid].extend(vals)
                report.emitted[rid] = report.emitted.get(rid, 0) + len(vals)
                report.tokens.setdefault(rid, []).extend(vals)
                # the next carry: the replacement at the first rejection, or
                # the bonus after a fully accepted draft
                carry[s] = int(v[1, s, a]) if a < d else int(v[2, s, d])
                self._lens_host[s] += len(vals)
                counts[s] = len(vals)
                drafted += d
                accepted += a
            report.useful_tokens += int(counts.sum())
            # idle slots and rejected drafts are paid for and not delivered
            report.wasted_tokens += n_slots - len(active) + drafted - accepted
            report.drafted_tokens += drafted
            report.accepted_tokens += accepted
            if drafted:
                report.spec_rounds += 1
                rate = accepted / drafted
                self.spec_accept_ewma = (rate if self.spec_accept_ewma is None
                                         else 0.3 * rate + 0.7 * self.spec_accept_ewma)
            executed += 1
            t_done = time.perf_counter()
            report.dispatch_s += t_sync - t_disp
            report.sync_s += (t_disp - t_draft) + (t_done - t_sync)
            for rid in slots.advance(counts):
                self._complete(rid, report)
        st.tok.copy_(torch.from_numpy(carry.astype(np.int32)))
        report.chunk_steps = executed
        report.spec_s += time.perf_counter() - t_start

    def _add_telemetry(self, report: PumpReport) -> None:
        tel = self.eng.telemetry
        tel.mixed_steps += report.mixed_steps
        tel.prefill_chunks += report.prefill_chunks
        if report.chunk_steps:
            tel.chunks += 1
        tel.decode_s += report.wall_s
        tel.useful_tokens += report.useful_tokens
        tel.wasted_tokens += report.wasted_tokens
        tel.completed_requests += len(report.completed)
        tel.prefix_hits += report.prefix_hits
        tel.prefix_misses += report.prefix_misses
        tel.reused_tokens += report.reused_tokens
        tel.prefilled_tokens += report.prefilled_tokens
        tel.recovered_tokens += report.recovered_tokens
        tel.recomputed_prefill_tokens += report.recomputed_prefill_tokens
        tel.drafted_tokens += report.drafted_tokens
        tel.accepted_tokens += report.accepted_tokens
        tel.spec_rounds += report.spec_rounds
        tel.spec_s += report.spec_s
        tel.draft_s += report.draft_s


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
        return self.advance(np.ones(self.n_slots, np.int64))

    def advance(self, counts: np.ndarray) -> list:
        """Advance every active slot by its own ``counts[slot]`` emitted
        tokens (a speculative round); returns request ids that finished."""
        active = self.request_id >= 0
        self.remaining[active] -= np.asarray(counts, np.int64)[active]
        done = np.nonzero(active & (self.remaining <= 0))[0]
        finished = self.request_id[done].tolist()
        self.request_id[done] = -1
        return finished
