"""Diffusion-style job engine of the port: the paper's sd21 deployment
units, served.

The counterpart of the JAX package's ``serving/diffusion.py``.  The
paper's Table-1 workload is Stable Diffusion 2.1: seconds-long, highly
batchable, non-streaming *jobs*, not token streams.  This module serves
that request class behind the surface the fleet already speaks:
``DiffusionEngine.new_session()`` returns a ``DiffusionSession`` that
duck-types ``QueueSession``'s ``CacheBackend``/pump interface (``submit``
/ ``pump`` / ``cancel`` / ``fits`` / ``load`` / ``inflight_rids``), so
``Replica``, the dispatcher, the fleet runtime and ``EngineClient`` work
unchanged.

The "model" is a deterministic latent denoiser, not a UNet: each job owns
one (D, D) latent seeded from its prompt tokens, and every pump advances
all active jobs ``steps_per_pump`` denoising steps (per-slot step masking,
so a slot's trajectory depends only on its own latent and conditioning:
admission order and batch composition never change a job's output).  A
finished job emits its result as one non-streaming burst of ``max_new``
digest tokens, a deterministic quantization of the final latent, the same
across replicas, retries and batch shapes, which is what lets the fleet's
requeue-and-retry machinery apply to jobs unchanged.

What jobs do NOT have: KV caches, prefix reuse, frontiers (a half-denoised
latent is cheaper to restart than to externalize at these step counts),
mixed-batch prefill, or speculation.  ``DiffusionSession`` reports all of
those capabilities absent and the fleet routes around them.

Where the port differs from the JAX engine, and why:

* A session's latents, conditionings and remaining steps live in fixed
  device buffers (``JobState``).  On the card each pump is one replay of a
  CUDA graph of ``denoise`` captured per ``steps`` over them (the JAX
  engine's one jitted ``lax.scan`` dispatch); on the CPU, or with
  ``graphs=False``, the same function runs directly.  Placement writes a
  slot in place (``lat[s].copy_``) where JAX rebinds the buffer: a graph
  reads fixed addresses.
* ``lat @ w_mix`` is a broadcast product summed over the shared axis, so
  no BLAS kernel choice and no TF32 setting reaches it: a row's result
  never depends on its batchmates, and the card's latents stay within
  2e-5 of the CPU's whatever ``torch.backends.cuda.matmul`` says.
* The weights are drawn on the host from ``cfg.seed`` with a
  ``torch.Generator`` (as the fleet draws model weights) and copied to the
  device; a job's noise (``seed_job``) is drawn on the host by numpy from
  ``cfg.seed`` and the prompt tokens.  Neither can reproduce
  ``jax.random``'s threefry bits without JAX, so a port job's digest is
  its own: ``load_params`` takes JAX's weights (through
  ``convert.diffusion_params_from_jax``) where a test compares the two.
* The host mirrors the remaining steps (``max(rem - steps, 0)``, what the
  device computes) instead of reading them back each pump; only a pump
  that finishes a job reads latents back.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.api import slo_order_key
from repro_torch.serving.engine import PumpReport
from repro_torch.serving.steps import StagedInts, StepGraphs


@dataclass
class DiffusionConfig:
    """Shape of one sd21-style job engine (per-tier, like ``EngineConfig``)."""

    batch: int = 8                 # concurrent job slots per replica
    denoise_steps: int = 20        # total denoising steps per job
    steps_per_pump: int = 5        # steps advanced per pump — a job spans
                                   # ceil(denoise_steps/steps_per_pump) pumps,
                                   # which is what makes it "seconds-long" in
                                   # fleet ticks rather than instant
    latent_dim: int = 16           # latent is (latent_dim, latent_dim)
    max_len: int = 4096            # prompt + digest-token bound (API compat)
    seed: int = 0


def denoise(lat: torch.Tensor, cond: torch.Tensor, rem: torch.Tensor, w_mix: torch.Tensor,
            w_cond: torch.Tensor, steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance every slot with remaining steps by up to ``steps`` denoising
    iterations, in fp32: ``lat`` (B, D, D), ``cond`` (B, D), ``rem`` (B,)
    int32 remaining steps -> (lat, rem) after them.  Slots at rem 0 are
    frozen, so a slot admitted mid-flight never overshoots its step budget
    and its trajectory is independent of its batchmates."""
    for _ in range(steps):
        upd = rem > 0
        mixed = (lat[..., :, None] * w_mix).sum(-2)          # lat @ w_mix, row by row
        eps = torch.tanh(mixed + cond[:, None, :] * w_cond)
        lat = torch.where(upd[:, None, None], lat - 0.1 * eps, lat)
        rem = torch.clamp(rem - upd.to(rem.dtype), min=0)
    return lat, rem


class JobState:
    """One session's fixed-shape device buffers: the latents (B, D, D), the
    conditionings (B, D), the remaining steps (B,) staged from the host
    before every pump, and the graphs captured on them."""

    generator = None           # the denoiser draws nothing

    def __init__(self, batch: int, dim: int, device: torch.device):
        self.batch = batch
        self.lat = torch.zeros((batch, dim, dim), dtype=torch.float32, device=device)
        self.cond = torch.zeros((batch, dim), dtype=torch.float32, device=device)
        self.rem = StagedInts(batch, device)
        self.graphs: Dict[tuple, object] = {}


class DiffusionEngine:
    """Tier-shared denoiser; replicas get isolated sessions.  ``device``
    defaults to the card; ``graphs``: each pump one CUDA-graph replay (the
    default on the card; ``True`` on the CPU raises) or the same function
    called directly (the default on the CPU; ``False`` on the card)."""

    is_job_engine = True

    def __init__(self, cfg: DiffusionConfig, *, device=None, graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs the card; the engine is on {self.device}")
        self.cfg = cfg
        self.paged = False
        self.mixed = False
        D = cfg.latent_dim
        # fixed mixing weights, the stand-in denoiser's "parameters": drawn
        # on the host from the seed, so every device holds the same ones
        gen = torch.Generator().manual_seed(cfg.seed)
        self.w_mix = (torch.randn((D, D), generator=gen) / math.sqrt(D)).to(self.device)
        self.w_cond = (torch.randn((D,), generator=gen) / math.sqrt(D)).to(self.device)
        self._graphs = StepGraphs(self.device) if graphs else None
        self._primed: Optional[JobState] = None      # the next session's state

    @property
    def graphs(self) -> bool:
        return self._graphs is not None

    @property
    def mixed_traces(self) -> int:
        """Mixed-step buckets prepared: none, as a job engine has no mixed step."""
        return 0

    @property
    def captures(self) -> Tuple[int, float]:
        """Graphs this engine's sessions captured, and the host seconds
        their first calls and captures took: (0, 0.0) without graphs."""
        g = self._graphs
        return (0, 0.0) if g is None else (g.captured, g.capture_s)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Take ``w_mix`` and ``w_cond`` from ``params`` (e.g.
        ``convert.diffusion_params_from_jax``), written in place so that
        graphs captured on them stay valid."""
        for name in ("w_mix", "w_cond"):
            getattr(self, name).copy_(torch.as_tensor(params[name], dtype=torch.float32))

    def new_session(self) -> "DiffusionSession":
        return DiffusionSession(self)

    # -- the state a session takes, and its step ------------------------------
    def _session_state(self) -> JobState:
        if self._primed is None:
            self._primed = JobState(self.cfg.batch, self.cfg.latent_dim, self.device)
        return self._primed

    def _take_session_state(self) -> JobState:
        st, self._primed = self._session_state(), None
        return st

    def _denoise_call(self, st: JobState, steps: int) -> torch.Tensor:
        """``steps`` denoising iterations on ``st`` in place: replayed from
        its graph of ("denoise", steps) on the card, else called directly."""
        def body():
            lat, rem = denoise(st.lat, st.cond, st.rem.dev, self.w_mix, self.w_cond, steps)
            st.lat.copy_(lat)
            st.rem.dev.copy_(rem)
            return st.lat

        return body() if self._graphs is None else self._graphs.run(st, ("denoise", steps), body)

    def warm(self) -> int:
        """Run the denoise step once on the state the next session takes,
        every slot at rem 0 (nothing moves): on the card that captures its
        graph there, so the session's first pump replays.  Returns the
        graphs captured (0 on the CPU, or when it is already there)."""
        st = self._session_state()
        before = self.captures[0]
        st.rem.fill(np.zeros(st.batch, np.int32))
        self._denoise_call(st, self.cfg.steps_per_pump)
        return self.captures[0] - before

    # -- deterministic job setup / readout ------------------------------------
    def seed_job(self, prompt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(initial latent (D, D), conditioning (D,)) float32 on the host
        for a prompt: a pure function of the prompt tokens and the engine
        seed (numpy's ``default_rng`` over ``[seed, *tokens & 0x7FFFFFFF]``),
        so the digest a job produces is replica-, device- and
        retry-independent."""
        toks = [int(t) & 0x7FFFFFFF for t in np.asarray(prompt).ravel()]
        rng = np.random.default_rng([self.cfg.seed, *toks])
        D = self.cfg.latent_dim
        lat0 = rng.standard_normal((D, D), dtype=np.float32)
        cond = rng.standard_normal((D,), dtype=np.float32)
        return lat0, cond

    def digest(self, lat_row: np.ndarray, max_new: int) -> np.ndarray:
        """Quantize a finished latent into ``max_new`` int tokens — the
        job's non-streaming "output".  Tiles when max_new exceeds the
        latent size; deterministic given the latent."""
        flat = np.asarray(lat_row, np.float64).ravel()
        reps = -(-max_new // flat.size)
        flat = np.tile(flat, reps)[:max_new]
        return (np.floor(np.abs(flat) * 1e6).astype(np.int64)) % 65536


class DiffusionSession:
    """One replica's job slots: the ``QueueSession`` duck type for jobs.

    Satisfies ``serving.backends.CacheBackend`` with every capability
    reported absent: no pages, no prefixes, no frontiers — a killed job
    simply requeues and re-denoises from its deterministic seed.
    """

    def __init__(self, engine: DiffusionEngine):
        self.eng = engine
        B = engine.cfg.batch
        self.paged = False
        self.scan_state = False
        self.mixed = False
        self.allocator = None
        # live-knob surface the fleet pokes on every session type; both are
        # inert here (jobs have no prefill budget and nothing to speculate)
        self.token_budget = 1
        self.spec_k = 0
        self.spec_accept_ewma: Optional[float] = None
        self.state = engine._take_session_state()
        self._rid = np.full((B,), -1, np.int64)       # slot -> rid (-1 free)
        self._rem = np.zeros((B,), np.int64)          # host mirror of steps left
        self._max_new: Dict[int, int] = {}            # rid -> digest length
        self.queue: List[Tuple[int, np.ndarray, int]] = []
        self.results: Dict[int, np.ndarray] = {}
        self._instant: List[int] = []
        self._slo: Dict[int, Tuple[int, int, float, int]] = {}
        self._seq = 0

    # -- request intake -------------------------------------------------------
    def submit(self, rid: int, inp: np.ndarray, max_new: int, *,
               slo_class: str = "job", priority: int = 0,
               deadline_s: Optional[float] = None,
               recompute: bool = False, frontier=None,
               speculate: bool = True) -> None:
        """Queue a job.  ``frontier``/``recompute``/``speculate`` are
        accepted for interface parity and ignored — jobs restart from
        their deterministic seed on retry."""
        del recompute, frontier, speculate
        if rid in self.results or rid in self._max_new or any(
                q[0] == rid for q in self.queue):
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
                f"max_new={max_new} exceeds max_len={self.eng.cfg.max_len}"
            )
        deadline_at = (time.monotonic() + deadline_s
                       if deadline_s is not None else math.inf)
        self._slo[rid] = slo_order_key(slo_class, priority, deadline_at, self._seq)
        self._seq += 1
        self.queue.append((rid, inp, max_new))

    def cancel(self, rid: int) -> bool:
        if rid in self.results:
            return False
        before = len(self.queue)
        self.queue = [q for q in self.queue if q[0] != rid]
        hit = len(self.queue) < before
        for s in np.nonzero(self._rid == rid)[0]:
            self._rid[s] = -1
            self._rem[s] = 0
            hit = True
        self._max_new.pop(rid, None)
        self._slo.pop(rid, None)
        return hit

    # -- CacheBackend surface -------------------------------------------------
    def fits(self, prompt_len: int, max_new: int) -> bool:
        return prompt_len + max_new <= self.eng.cfg.max_len

    def prefix_match_len(self, prompt) -> int:
        return 0

    @property
    def supports_frontiers(self) -> bool:
        return False

    def extract_frontier(self, rid: int):
        return None

    def extract_frontiers(self) -> List:
        return []

    def decoding_lens(self) -> Dict[int, int]:
        return {}

    # -- introspection --------------------------------------------------------
    @property
    def idle(self) -> bool:
        return (not self.queue and not self._instant
                and not np.any(self._rid >= 0))

    @property
    def load(self) -> int:
        return len(self.queue) + int(np.sum(self._rid >= 0))

    def inflight_rids(self) -> List[int]:
        active = [int(r) for r in self._rid if r >= 0]
        return active + [rid for rid, _, _ in self.queue]

    # -- the loop body --------------------------------------------------------
    def _pop_next(self) -> Tuple[int, np.ndarray, int]:
        best = min(range(len(self.queue)),
                   key=lambda i: self._slo[self.queue[i][0]])
        return self.queue.pop(best)

    def pump(self) -> PumpReport:
        """One job cycle: admit into free slots, then ONE denoise call (a
        graph replay on the card) advancing every active job
        ``steps_per_pump`` denoising steps.  Jobs whose step budget hits
        zero complete, emitting their whole digest in this report
        (non-streaming)."""
        eng, cfg, st = self.eng, self.eng.cfg, self.state
        report = PumpReport()
        t0 = time.perf_counter()
        for rid in self._instant:
            report.completed[rid] = self.results[rid]
        self._instant = []

        for s in np.nonzero(self._rid < 0)[0]:
            if not self.queue:
                break
            rid, inp, max_new = self._pop_next()
            lat0, cond = eng.seed_job(inp)
            st.lat[int(s)].copy_(torch.from_numpy(lat0))
            st.cond[int(s)].copy_(torch.from_numpy(cond))
            self._rid[s] = rid
            self._rem[s] = cfg.denoise_steps
            self._max_new[rid] = max_new
            report.admitted.append(rid)
        report.admit_s = time.perf_counter() - t0

        active = self._rid >= 0
        report.occupancy = float(np.mean(active))
        if not np.any(active):
            report.wall_s = time.perf_counter() - t0
            return report

        t_disp = time.perf_counter()
        st.rem.fill(self._rem)
        eng._denoise_call(st, cfg.steps_per_pump)
        t_sync = time.perf_counter()
        report.dispatch_s = t_sync - t_disp
        self._rem = np.maximum(self._rem - cfg.steps_per_pump, 0)
        done = np.nonzero(active & (self._rem == 0))[0]
        if done.size:
            lat_host = st.lat[torch.as_tensor(done, device=st.lat.device)].cpu().numpy()
            for j, s in enumerate(done):
                rid = int(self._rid[s])
                toks = eng.digest(lat_host[j], self._max_new[rid])
                self.results[rid] = toks
                report.completed[rid] = toks
                report.tokens[rid] = [int(v) for v in toks]
                report.emitted[rid] = int(toks.size)
                report.useful_tokens += int(toks.size)
                self._rid[s] = -1
                self._max_new.pop(rid, None)
                self._slo.pop(rid, None)
        report.sync_s = time.perf_counter() - t_sync
        report.wall_s = time.perf_counter() - t0
        return report


__all__ = ["DiffusionConfig", "DiffusionEngine", "DiffusionSession", "JobState", "denoise"]
