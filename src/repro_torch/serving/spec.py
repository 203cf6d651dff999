"""Speculative decoding: the drafter and the fused verification rule.

Counterpart of the JAX package's ``serving/spec.py``.  Speculation has two
halves, split host/device:

* **Drafting** (host): a ``Drafter`` proposes up to k continuation tokens
  for a decoding slot from its whole history (prompt, generated tokens and
  the carried next token).  The default ``NgramDrafter`` is prompt-lookup
  decoding: match the last n tokens against an earlier occurrence and
  propose what followed it.
* **Verification** (device): the drafts ride one mixed step (a drafted slot
  advances ``new_len = 1 + d`` tokens, the carry and d drafts), and
  ``step_mixed(all_logits=True)`` gives the next-token logits at every
  column.  ``verify_tokens`` reduces those (B, Q, V) logits on the device to
  the (3, B, Q) int32 verdict, so a round reads back O(B·Q) values, never
  the vocabulary axis.

The verdict, for a row whose draft count was d (drafts in token columns
1..d, so column j's logits judge draft j+1):

* ``verdict[0, b, j]`` -- 1 iff draft j (token column j+1) was accepted;
* ``verdict[1, b, j]`` -- the replacement token if j is the first rejected
  position (greedy: the argmax; temperature: the residual draw);
* ``verdict[2, b, j]`` -- the bonus token if all d drafts were accepted and
  j == d (greedy: the argmax; temperature: a plain draw).

The host walks the accept flags to the first 0, emits the carry and the
accepted drafts, and takes the next carry from row 1 or row 2.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import torch


@runtime_checkable
class Drafter(Protocol):
    """Anything that proposes draft tokens from a slot's token history."""

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` candidate continuations of ``context`` (fewer, or []
        when it has nothing to say: a miss costs nothing, the slot decodes
        one token that round)."""
        ...


class NgramDrafter:
    """Prompt-lookup drafting: match the last n tokens of the history
    against an earlier occurrence and propose what followed it.

    Tries the longest n-gram first (``n`` down to ``min_n``) and takes the
    most recent earlier match.  A match at offset i makes the history
    locally periodic with period ``p = (L - n) - i``, so the proposal
    extends that period for the full k tokens instead of stopping where the
    matched continuation runs off the end of the history: the verify step
    costs the same for a short draft as for a full one (its column count is
    the fixed quantum ``spec_quantum(k)``).
    """

    def __init__(self, n: int = 3, min_n: int = 1):
        if n < 1:
            raise ValueError(f"ngram n must be >= 1, got {n}")
        self.n = int(n)
        self.min_n = max(1, min(int(min_n), self.n))

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        L = len(ctx)
        if k <= 0 or L < self.min_n + 1:
            return []
        for n in range(min(self.n, L - 1), self.min_n - 1, -1):
            suffix = ctx[-n:]
            # the most recent earlier occurrence, right to left, leaving out
            # the trivial match at the very end
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] == suffix:
                    p = (L - n) - i           # the implied local period, >= 1
                    out: List[int] = []
                    for j in range(k):
                        idx = L + j - p
                        out.append(ctx[idx] if idx < L else out[idx - L])
                    return out
        return []


def spec_quantum(k: int) -> int:
    """The pow-2 token-column width a draft depth implies: k drafts plus the
    carried token, padded up.  It is the one chunk width spec rounds
    dispatch, so speculation adds one (Q, attention-window) column of
    buckets to the mixed-step grid."""
    if k <= 0:
        return 1
    return 1 << int(k).bit_length()


def categorical_draw(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from ``probs`` (last axis), as ``torch.multinomial``
    makes it (argmax of p / E, E ~ Exp(1)) but without its host-side checks,
    so a CUDA graph can hold it.  A zero-probability index is never drawn."""
    race = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


def verify_tokens(logits: torch.Tensor, drafts: torch.Tensor, temperature: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Reduce all-position logits to the (3, B, Q) int32 verdict.

    ``logits`` (B, Q, V) from ``step_mixed(all_logits=True)``; ``drafts``
    (B, Q) with ``drafts[b, j]`` the token in column j+1 (the candidate
    judged by column j's logits; the last column is padding, its flag never
    read).  Rows of the verdict: accept flag, replacement, bonus (module
    docstring).

    * Greedy (``temperature <= 0``): accept draft j iff it equals the argmax
      of column j (the first maximum, as ``jnp.argmax``); replacement and
      bonus are that argmax.  Nothing is drawn, so ``generator`` is unused.
    * ``temperature > 0``: speculative rejection sampling with a point-mass
      proposal: accept draft t with probability p(t) (u ~ U(0, 1) against
      p(t)); the replacement is a draw from p with the draft's index set to
      0 (renormalised by the draw itself), the bonus a draw from p.  The
      emitted token's marginal is p.  Every draw comes from ``generator``
      (u, then the residual's race, then the bonus's), with no host-side
      check, so a graph can hold it; the streams follow torch's generator,
      not jax.random.
    """
    if temperature <= 0.0:
        pred = torch.argmax(logits, dim=-1).to(torch.int32)
        accept = (pred == drafts).to(torch.int32)
        return torch.stack([accept, pred, pred])
    idx = drafts.to(torch.int64)[..., None]
    p = torch.softmax(logits.float() / temperature, dim=-1)
    p_draft = p.gather(-1, idx)[..., 0]
    u = torch.rand(p_draft.shape, generator=generator, device=p.device)
    accept = (u < p_draft).to(torch.int32)
    resid = categorical_draw(p.scatter(-1, idx, 0.0), generator)
    bonus = categorical_draw(p, generator)
    return torch.stack([accept, resid, bonus])
