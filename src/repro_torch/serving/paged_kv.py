"""Block-level KV page accounting: refcounts, prefix cache, LRU, COW.

The port's own copy of the JAX package's ``serving/paged_kv.py``
(numpy only).  The device side of the paged KV cache is a
(L, P, page_size, Hkv, D) pool plus per-slot (n_blocks,) block tables;
everything that makes paging useful is host-side bookkeeping and lives
here:

* ``BlockAllocator`` hands out fixed-size pages with refcounts.  A page is
  *free* (allocatable), *live* (refcount > 0), or *cached* (refcount 0 but
  still holding prompt KV that a future request may reuse — parked in an
  LRU and evicted only under allocation pressure).
* The **prefix cache** maps block-aligned prompt prefixes to the pages that
  already hold their KV.  Keys are the literal token tuples (exact compare,
  so two different prefixes never alias).
* A **full-prompt cache** also remembers, per complete prompt, the whole
  page list *and the final prefill logits* (fp32: numpy has no bf16, and
  bf16 -> fp32 is exact, so the argmax is unchanged), so an identical
  prompt skips prefill entirely and still samples the same first token.
* **Copy-on-write**: pages shared through the cache are written by at most
  one owner.  When a request's first KV write would land in a page another
  request still reads, the engine asks for ``cow()`` — a fresh page the
  device copies the old one into — and repoints its block table.

The allocator never touches device memory: the engine performs the page
writes and copies and tells the allocator what it decided.

A **durable-KV frontier** (``KVFrontier``) is one decoding request taken
out of a session: its tokens so far, its carried next token and a host
copy of the pages that hold its KV.  ``extract_kv`` validates the pages
to copy, ``inject_kv`` allocates the fresh pages a restore writes into.
The host payload is numpy: a bf16 pool's leaves are held as float32
(numpy has no bfloat16; every bf16 value is a float32 value, so the cast
back to the pool's dtype on restore is exact), an fp32 pool's as they
are.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

TRASH_PAGE = 0   # page 0 is the write sink for idle/overrun slots; never allocated


@dataclass
class KVFrontier:
    """One request's resumable decode state, taken out of a session: the
    prompt, the tokens generated so far (their KV is in the pages), the
    carried next token (sampled, its KV not yet written), and host copies
    of the pages covering the frontier -- leaves shaped (L, n_blocks,
    page_size, Hkv, Dh), the pool's layout minus the pool axis.  Injected
    into fresh pages of any session with the same weights and page size,
    decode resumes from ``tokens`` as the uninterrupted run would (greedy)."""

    prompt: Tuple[int, ...]
    generated: Tuple[int, ...]    # emitted tokens whose KV the pages hold
    carry_tok: int                # next token to decode (KV not yet written)
    pages_kv: Any                 # NamedTuple of numpy leaves (L, nb, ps, Hkv, Dh)
    page_size: int

    @property
    def tokens(self) -> int:
        """Content length the pages cover (prompt + generated)."""
        return len(self.prompt) + len(self.generated)


@dataclass
class PromptEntry:
    """Everything needed to admit an identical prompt with zero prefill."""

    tokens: Tuple[int, ...]
    pages: Tuple[int, ...]        # all prompt blocks, partial last included
    logits: np.ndarray            # (V,) fp32 last-position prefill logits


@dataclass
class PrefixStats:
    """Cache-effectiveness counters."""

    full_hits: int = 0            # prompt matched end-to-end: no prefill at all
    prefix_hits: int = 0          # block-aligned partial match: suffix-only work
    misses: int = 0
    reused_tokens: int = 0        # prompt tokens whose KV came from the cache
    prefilled_tokens: int = 0     # prompt tokens that went through the model
    evictions: int = 0
    cow_copies: int = 0


class BlockAllocator:
    """Fixed-pool page allocator with prefix reuse.

    ``num_pages`` includes the reserved trash page; ``usable`` pages are
    ``num_pages - 1``.  All methods are O(pages touched).
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 enable_reuse: bool = True, max_prompt_entries: int = 1024):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is the trash page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # False turns the prefix cache off: nothing is published, nothing
        # matches, and a freed page goes straight back to the free list
        self.enable_reuse = enable_reuse
        # prompt entries carry full (V,) logits; this cap bounds that host
        # memory independently of pool size (oldest entry evicted first, its
        # block-level entries and pages untouched)
        self.max_prompt_entries = max_prompt_entries
        self.refcount = np.zeros(num_pages, dtype=np.int64)
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # prefix tuple (block-aligned) -> page holding its LAST block
        self._blocks: Dict[Tuple[int, ...], int] = {}
        # full prompt tuple -> PromptEntry (insertion-ordered for the cap)
        self._prompts: "OrderedDict[Tuple[int, ...], PromptEntry]" = OrderedDict()
        # page -> cache keys referencing it (("b", prefix) | ("p", tokens))
        self._page_keys: Dict[int, Set[tuple]] = {}
        self.stats = PrefixStats()

    # -- capacity ------------------------------------------------------------
    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def live_pages(self) -> int:
        return int(np.sum(self.refcount[1:] > 0))

    @property
    def cached_pages(self) -> int:
        return len(self._lru)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        """Fraction of usable pages pinned by live requests."""
        return self.live_pages / self.usable if self.usable else 0.0

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    # -- page lifecycle ------------------------------------------------------
    def alloc(self) -> Optional[int]:
        """One refcount-1 page, evicting the LRU cached page if needed.
        None when every usable page is pinned by a live request."""
        if self._free:
            page = self._free.pop()
        elif self._lru:
            page, _ = self._lru.popitem(last=False)     # oldest cached page
            self.stats.evictions += 1
            for key in list(self._page_keys.get(page, ())):
                self._drop_key(key)
        else:
            return None
        self.refcount[page] = 1
        return page

    def ref(self, page: int) -> None:
        if page == TRASH_PAGE:
            raise ValueError("cannot ref the trash page")
        if self.refcount[page] == 0:
            self._lru.pop(page, None)                   # cached -> live again
        self.refcount[page] += 1

    def deref(self, page: int) -> None:
        """Release one reference.  A page that still backs cache entries is
        parked in the LRU (reusable until evicted); otherwise it frees."""
        if self.refcount[page] <= 0:
            raise ValueError(f"deref of unreferenced page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            if self._page_keys.get(page):
                self._lru[page] = None
            else:
                self._free.append(page)

    def cow(self, page: int) -> Optional[int]:
        """Copy-on-write: trade one reference on ``page`` for a fresh
        exclusive page (the caller copies the contents on the device).
        None (and no state change) when the pool is exhausted."""
        fresh = self.alloc()
        if fresh is None:
            return None
        self.deref(page)
        self.stats.cow_copies += 1
        return fresh

    # -- durable-KV extraction / injection -----------------------------------
    def extract_kv(self, pages: Sequence[int]) -> Tuple[int, ...]:
        """Validate a page range for a frontier: every page live and none the
        trash page.  Returns the pages unchanged; the engine copies their
        contents.  The allocator is untouched (extraction is a read)."""
        out = []
        for p in pages:
            p = int(p)
            if p == TRASH_PAGE:
                raise ValueError("cannot extract the trash page")
            if self.refcount[p] <= 0:
                raise ValueError(f"extract of unreferenced page {p}")
            out.append(p)
        return tuple(out)

    def inject_kv(self, n_blocks: int) -> Optional[List[int]]:
        """``n_blocks`` fresh refcount-1 pages for an injected frontier, all
        or nothing: the capacity check comes first, so a grab that cannot
        fully succeed evicts no cached page on its way to failing.  None,
        with no state change, under pool pressure."""
        if n_blocks > self.free_pages + self.cached_pages:
            return None
        pages: List[int] = []
        for _ in range(n_blocks):
            p = self.alloc()
            if p is None:                 # unreachable after the check
                for q in pages:
                    self.deref(q)
                return None
            pages.append(p)
        return pages

    # -- prefix cache --------------------------------------------------------
    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached block-aligned *proper* prefix of ``tokens``.

        Returns (matched_token_count, pages).  The match is capped below
        ``len(tokens)`` so the caller always has at least one suffix token
        to feed through the model for first-token logits (a complete match
        is served by ``lookup_prompt`` instead, which carries the logits).
        """
        if not self.enable_reuse:
            return 0, []
        toks = tokens if type(tokens) is tuple else tuple(int(t) for t in tokens)
        ps = self.page_size
        limit = (len(toks) - 1) // ps                   # proper-prefix cap
        pages: List[int] = []
        for i in range(limit):
            page = self._blocks.get(toks[: (i + 1) * ps])
            if page is None:
                break
            pages.append(page)
        return len(pages) * ps, pages

    def lookup_prompt(self, tokens: Sequence[int]) -> Optional[PromptEntry]:
        if not self.enable_reuse:
            return None
        toks = tokens if type(tokens) is tuple else tuple(int(t) for t in tokens)
        return self._prompts.get(toks)

    def match_len(self, tokens: Sequence[int]) -> int:
        """Reusable prefix length (dispatcher affinity score); read-only."""
        if not self.enable_reuse:
            return 0
        toks = tokens if type(tokens) is tuple else tuple(int(t) for t in tokens)
        if toks in self._prompts:
            return len(toks)
        return self.match_prefix(toks)[0]

    def publish(self, tokens: Sequence[int], pages: Sequence[int],
                logits: np.ndarray) -> None:
        """Register a freshly prefilled prompt: one block entry per FULL
        block plus a full-prompt entry (all blocks + final logits).  First
        writer wins — an existing entry for the same prefix is kept, so
        pages referenced by the cache are never silently swapped."""
        if not self.enable_reuse:
            return
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        for i in range(len(toks) // ps):
            key = ("b", toks[: (i + 1) * ps])
            if key[1] in self._blocks:
                continue
            self._blocks[key[1]] = int(pages[i])
            self._page_keys.setdefault(int(pages[i]), set()).add(key)
        if toks not in self._prompts:
            entry = PromptEntry(tokens=toks, pages=tuple(int(p) for p in pages),
                                logits=np.asarray(logits, np.float32).copy())
            self._prompts[toks] = entry
            key = ("p", toks)
            for p in entry.pages:
                self._page_keys.setdefault(p, set()).add(key)
            while len(self._prompts) > self.max_prompt_entries:
                oldest = next(iter(self._prompts))
                self._drop_key(("p", oldest))

    # -- internals -----------------------------------------------------------
    def _drop_key(self, key: tuple) -> None:
        """Remove one cache entry and release any pages it alone kept cached."""
        kind, toks = key
        if kind == "b":
            pages = (self._blocks.pop(toks, None),)
        else:
            entry = self._prompts.pop(toks, None)
            pages = entry.pages if entry is not None else ()
        for p in pages:
            if p is None:
                continue
            keys = self._page_keys.get(p)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._page_keys[p]
                    if self.refcount[p] == 0 and p in self._lru:
                        del self._lru[p]
                        self._free.append(p)
