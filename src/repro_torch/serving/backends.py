"""Cache backends: the protocol behind a serving slot's resumable state.

The port's own copy of the JAX package's ``serving/backends.py``.  A
session holds a request's decode state in one of three ways, one per
model class:

* **contiguous stripes** -- each slot owns a ``max_len`` stripe of a
  (L, B, S, Hkv, Dh) KV buffer (``EngineConfig.paged_kv=False`` on a
  dense model);
* **paged pool** -- ``paged_kv.BlockAllocator``: slots hold block tables
  over a shared page pool, prompt prefixes are shared across requests,
  and frontiers leave as ``KVFrontier`` page copies;
* **scan state** -- rwkv6 and the hybrid zamba2: the decode state is a
  per-slot set of leaves whose size does not grow with the sequence (the
  hybrid's shared-attention KV stripe aside), so a frontier is one copy of
  the slot's leaves.

``CacheBackend`` names what a fleet calls on a session (the capacity
predicate, the prefix-affinity score, frontier checkpoint and restore);
``QueueSession`` satisfies it for all three layouts.  ``StateFrontier`` is
the scan-state twin of ``paged_kv.KVFrontier``: the same ``.prompt``,
``.generated`` and ``.tokens``, so a store holds either without knowing
which.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Protocol, Tuple, runtime_checkable


@runtime_checkable
class CacheBackend(Protocol):
    """What a dispatcher or fleet needs from a session's cache machinery."""

    paged: bool                       # block-table pool backend?

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Can a request of this shape ever be admitted here?"""
        ...

    def prefix_match_len(self, prompt) -> int:
        """Reusable-prefix length (0 for backends with nothing to share)."""
        ...

    @property
    def supports_frontiers(self) -> bool:
        """Whether decoding requests can leave as resumable frontiers (KV
        pages or scan state)."""
        ...

    def extract_frontier(self, rid: int) -> Optional[Any]:
        """Copy one decoding request's resumable state out, or None."""
        ...

    def extract_frontiers(self) -> List[Tuple[int, Any]]:
        """Checkpoint every decoding request."""
        ...

    def decoding_lens(self) -> Dict[int, int]:
        """rid -> current frontier length, from the host's bookkeeping."""
        ...


@dataclass
class StateFrontier:
    """One scan-state request's resumable decode state, taken out of a
    session: the prompt, the tokens generated so far (folded into the
    state), the carried next token, and a host copy of the slot's cache
    leaves with the batch axis kept as a singleton (rwkv6: state (L, 1, H,
    N, N) and shift rows (L, 1, d); zamba2: conv tails, Mamba-2 states and
    the shared-attention K/V stripes (G, 1, max_len, Hkv, Dh)), so a
    restore writes it as admission writes a prefill.  Resuming decode from
    it matches the uninterrupted run (greedy)."""

    prompt: Tuple[int, ...]
    generated: Tuple[int, ...]    # emitted tokens folded into the state
    carry_tok: int                # next token to decode (not yet folded in)
    state: Any                    # NamedTuple of numpy leaves, batch axis kept (= 1)
    page_size: int = 1            # scan state advances a token at a time

    @property
    def tokens(self) -> int:
        """Content length the state covers (prompt + generated)."""
        return len(self.prompt) + len(self.generated)


__all__ = ["CacheBackend", "StateFrontier"]
