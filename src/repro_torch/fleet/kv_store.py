"""Fleet-global durable KV store: checkpointed decode frontiers that
outlive replicas.

The per-replica prefix caches (``serving.paged_kv.BlockAllocator``) die
with their replica — which is exactly when they are most needed: a request
requeued after a kill pays full re-prefill, burning the compute the cost
mode is trying to save.  ``KVStore`` is the fleet-level second tier: the
runtime checkpoints every decoding request's ``KVFrontier`` here (periodic
per-pump flushes, plus an explicit drain on preemption notice), and the
requeue path re-attaches the stored frontier so the retry resumes decode
instead of re-prefilling — zero recomputed prefill tokens, token-exact
output.

Entries are keyed by the EXACT prompt token tuple.  That is sufficient —
not a shortcut — because fleet engines run greedy with shared parameters:
one prompt has one output stream, so a stored frontier is valid for any
request carrying that prompt (each requester's own ``max_new`` governs;
a frontier longer than the ask instant-completes, a shorter one resumes).
Block-aligned partial sharing stays the per-replica allocator's job.

Capacity is bounded in TOKENS (frontier device bytes scale with tokens),
with LRU eviction; a put replaces an existing entry only when it covers at
least as many tokens, so concurrent checkpoints never regress a frontier.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs import Tracer
from repro_torch.serving.paged_kv import KVFrontier


@dataclass
class KVStoreStats:
    puts: int = 0                 # accepted checkpoints (insert or advance)
    stale_puts: int = 0           # rejected: stored frontier already >= offered
    hits: int = 0
    misses: int = 0
    evictions: int = 0            # LRU entries dropped under capacity pressure
    rejected: int = 0             # frontier alone exceeds capacity_tokens


class KVStore:
    """Capacity-bounded, LRU-evicting map of prompt -> ``KVFrontier``."""

    def __init__(self, capacity_tokens: int = 1 << 16,
                 max_entries: int = 1024, *,
                 tracer: Optional[Tracer] = None):
        if capacity_tokens < 1:
            raise ValueError(f"capacity_tokens must be positive, got {capacity_tokens}")
        self.capacity_tokens = int(capacity_tokens)
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[Tuple[int, ...], KVFrontier]" = OrderedDict()
        self._tokens = 0
        self.stats = KVStoreStats()
        # kv.* events are high-frequency (every periodic flush): sampled
        self.tracer = tracer if tracer is not None else Tracer.disabled()

    # -- capacity ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def occupancy_tokens(self) -> int:
        return self._tokens

    @property
    def occupancy(self) -> float:
        return self._tokens / self.capacity_tokens

    # -- checkpoint / restore ------------------------------------------------
    def put(self, frontier: KVFrontier) -> bool:
        """Checkpoint a frontier.  Keeps the LONGER of the offered and any
        stored frontier for the prompt (checkpoints only ever advance);
        evicts LRU entries to fit.  False when rejected (stale, or alone
        larger than the whole store)."""
        key = tuple(frontier.prompt)
        n = frontier.tokens
        if n > self.capacity_tokens:
            self.stats.rejected += 1
            return False
        old = self._entries.get(key)
        if old is not None:
            if old.tokens >= n:
                self._entries.move_to_end(key)   # still the freshest state
                self.stats.stale_puts += 1
                return False
            self._tokens -= old.tokens
            del self._entries[key]
        while self._entries and (
            self._tokens + n > self.capacity_tokens
            or len(self._entries) >= self.max_entries
        ):
            _, evicted = self._entries.popitem(last=False)
            self._tokens -= evicted.tokens
            self.stats.evictions += 1
            self.tracer.event("kv.evict", cat="kv", sampled=True,
                              tokens=evicted.tokens)
        self._entries[key] = frontier
        self._tokens += n
        self.stats.puts += 1
        self.tracer.event("kv.put", cat="kv", sampled=True, tokens=n,
                          occupancy_tokens=self._tokens)
        return True

    def get(self, prompt: Sequence[int]) -> Optional[KVFrontier]:
        """The stored frontier for an exact prompt (refreshes its LRU
        position), or None."""
        key = prompt if type(prompt) is tuple else tuple(int(t) for t in prompt)
        fr = self._entries.get(key)
        if fr is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        self.tracer.event("kv.hit", cat="kv", sampled=True, tokens=fr.tokens)
        return fr

    def match_len(self, prompt: Sequence[int]) -> int:
        """Tokens a hit would recover (routing/affinity probe): read-only,
        no stats, no LRU touch."""
        key = prompt if type(prompt) is tuple else tuple(int(t) for t in prompt)
        fr = self._entries.get(key)
        return fr.tokens if fr is not None else 0

    def drop(self, prompt: Sequence[int]) -> bool:
        """Remove one entry (e.g. its request completed or was cancelled)."""
        key = prompt if type(prompt) is tuple else tuple(int(t) for t in prompt)
        fr = self._entries.pop(key, None)
        if fr is None:
            return False
        self._tokens -= fr.tokens
        return True

    # -- telemetry -----------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        s = self.stats
        return {
            "entries": float(len(self._entries)),
            "occupancy_tokens": float(self._tokens),
            "occupancy": float(self.occupancy),
            "puts": float(s.puts),
            "stale_puts": float(s.stale_puts),
            "hits": float(s.hits),
            "misses": float(s.misses),
            "evictions": float(s.evictions),
            "rejected": float(s.rejected),
        }
