"""Request-granularity weighted dispatch (the live ALB).

The analytic router splits a scalar RPS by the controller's weights; here
every individual request is placed on a concrete replica:

  * prefix affinity first: a request whose prompt prefix is already cached
    in some replica's paged KV goes to the replica holding the LONGEST
    match (ties to the least-loaded) — a prefix hit skips prefill, which
    beats any load-balance gain once the match is substantial.  Matches
    shorter than ``min_affinity_tokens`` fall through to the weighted
    path (a one-page opener must not override the controller), and
    affinity placements still charge the tier's deficit so realized
    traffic keeps tracking the weights.  Replicas without paging score 0,
    so contiguous fleets fall straight through to the weighted path;
  * otherwise tier choice follows the controller weights (largest-deficit
    rounding, so realized traffic tracks the weights without randomness);
  * replica choice within a tier is least-loaded-first over replicas whose
    bounded queue has room;
  * a request whose weighted tier is full SPILLS to any tier with headroom
    (the paper's "reduce the weight of units lacking capacity");
  * if nowhere has room it stays in the backlog and retries next tick —
    requests are only dropped after ``max_retries`` replica failures;
  * optional hedging duplicates a fraction of requests onto a second tier,
    first completion wins and cancels the twin (straggler mitigation).
    Requests already past their deadline are never hedged — hedging buys
    tail latency, and theirs is already lost;
  * the backlog is SLO-ordered before placement (the same
    ``slo_order_key`` rule the engine session uses for admission):
    interactive before batch, higher priority first, soonest deadline
    first, FIFO within ties — so a batch burst cannot head-of-line block
    interactive traffic at the dispatch layer either.

On replica death ``on_failure`` requeues the victim's in-flight rids at the
FRONT of the backlog (oldest work first) with a retry tick; ``cancel``
withdraws a request wherever it is (backlog, primary, hedge twin).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.replica import Replica
from repro_torch.fleet.workload import Request
from repro_torch.obs import Tracer
from repro_torch.serving.api import slo_order_key


class Dispatcher:
    def __init__(self, tiers: Sequence[str], *, max_retries: int = 16,
                 hedge_fraction: float = 0.0, prefix_affinity: bool = True,
                 min_affinity_tokens: int = 16,
                 arch_of: Optional[Dict[str, str]] = None):
        self.tiers = list(tiers)
        # tier name -> arch it serves (model-aware routing): a request with
        # a nonempty ``model`` is only ever placed on tiers whose arch
        # matches.  Tiers absent from the map accept anything (legacy
        # single-model construction).
        self.arch_of: Dict[str, str] = dict(arch_of or {})
        # flight recorder (runtime-owned; disabled stub when standalone)
        self.tracer: Tracer = Tracer.disabled()
        self.max_retries = max_retries
        self.hedge_fraction = hedge_fraction
        self.prefix_affinity = prefix_affinity
        self.min_affinity_tokens = min_affinity_tokens
        self.backlog: Deque[Request] = deque()
        # rid -> (request, primary replica, optional hedge replica)
        self.inflight: Dict[int, Tuple[Request, Replica, Optional[Replica]]] = {}
        self.dropped: List[Request] = []
        self.drop_reasons: Dict[int, str] = {}   # rid -> why it was dropped
        self.dispatched_per_tier: Dict[str, int] = {t: 0 for t in tiers}
        self.affinity_placements = 0      # requests routed by cached prefix
        self._deficit = np.zeros(len(tiers), dtype=np.float64)
        self._hedge_debt = 0.0

    # -- intake -------------------------------------------------------------
    def submit(self, reqs: Iterable[Request]) -> None:
        self.backlog.extend(reqs)

    @property
    def quiet(self) -> bool:
        return not self.backlog and not self.inflight

    # -- placement ----------------------------------------------------------
    def _compatible(self, req: Request, tier: str) -> bool:
        """Model-aware routing gate: a request that names a model may only
        land on tiers serving that arch.  Empty ``model`` (single-model
        fleets, legacy traces) and unmapped tiers accept everything."""
        if not req.model:
            return True
        return self.arch_of.get(tier, req.model) == req.model

    @staticmethod
    def _masked_weights(weights: np.ndarray, has_room: np.ndarray) -> np.ndarray:
        """The one place the weighted policy masks/normalizes: weights of
        full/dead tiers are zeroed; a zero sum means 'spill, charge no
        deficit' for both the weighted pick and affinity accounting."""
        w = np.where(has_room, np.maximum(weights, 0.0), 0.0)
        s = w.sum()
        return w / s if s > 0 else w

    def _pick_tier(self, weights: np.ndarray,
                   has_room: np.ndarray) -> Optional[int]:
        """Largest-deficit weighted choice among tiers with room."""
        w = self._masked_weights(weights, has_room)
        if w.sum() <= 0:
            # weights point only at full/dead tiers: spill anywhere with room
            candidates = np.nonzero(has_room)[0]
            return int(candidates[0]) if len(candidates) else None
        self._deficit += w
        order = np.argsort(-self._deficit)
        for i in order:
            if has_room[i]:
                self._deficit[i] -= 1.0
                return int(i)
        return None

    @staticmethod
    def _best_replica(replicas: List[Replica],
                      req: Optional[Request] = None) -> Optional[Replica]:
        """Least-loaded accepting replica; with ``req``, only replicas whose
        engine/page budget can actually hold that request (an undersized
        paged pool must read as 'no room', not blow up at submit)."""
        accepting = [r for r in replicas
                     if r.accepting and (req is None or r.fits(req))]
        if not accepting:
            return None
        return min(accepting, key=lambda r: r.load)

    def _affinity_replica(
        self, req: Request, replicas_by_tier: Dict[str, List[Replica]]
    ) -> Optional[Tuple[Replica, int]]:
        """(replica, tier_index) holding the longest cached prefix of
        ``req``'s prompt, or None when nothing useful is cached anywhere."""
        if not self.prefix_affinity:
            return None
        # contiguous fleets short-circuit before any prompt boxing: replicas
        # without a paged session can never score above 0
        if not any(rep.session is not None and rep.session.paged
                   for reps in replicas_by_tier.values() for rep in reps):
            return None
        best: Optional[Tuple[Replica, int]] = None
        best_key = (0, 0)                 # (match_len, -load): longest, then idlest
        # Request.token_key() boxes the prompt once over its whole lifetime
        # (backlogged requests are re-scored every tick)
        toks = req.token_key()
        for ti, tier in enumerate(self.tiers):
            if not self._compatible(req, tier):
                continue      # affinity never crosses a model boundary
            for rep in replicas_by_tier.get(tier, []):
                if not rep.accepting or not rep.fits(req):
                    continue
                mlen = rep.prefix_match_len(toks)
                if mlen < self.min_affinity_tokens:
                    continue
                key = (mlen, -rep.load)
                if key > best_key:
                    best, best_key = (rep, ti), key
        return best

    def _account_placement(self, ti: int, weights: np.ndarray,
                           has_room: np.ndarray) -> None:
        """Charge one placement against tier ``ti``'s deficit exactly as a
        weighted pick of ``ti`` would (shared masking via _masked_weights;
        the zero-weight spill case charges nothing), so affinity placements
        keep realized traffic tracking the controller weights."""
        w = self._masked_weights(weights, has_room)
        if w.sum() > 0:
            self._deficit += w
            self._deficit[ti] -= 1.0

    def _order_backlog(self) -> None:
        """SLO-order the backlog in place: interactive before batch, then
        priority, then soonest deadline.  The sort is stable, so FIFO (and
        requeued-work-first after a failure) is preserved within ties."""
        if len(self.backlog) > 1:
            self.backlog = deque(sorted(
                self.backlog,
                key=lambda r: slo_order_key(r.slo_class, r.priority,
                                            r.deadline_t),
            ))

    def dispatch(self, weights: np.ndarray,
                 replicas_by_tier: Dict[str, List[Replica]],
                 now: float = 0.0) -> int:
        """Place as much of the backlog as current capacity allows.

        Returns the number of requests placed this tick; whatever could not
        be placed stays in the backlog (zero silent drops).  ``now`` is
        control-loop time, used only for deadline checks (hedge skipping).
        """
        weights = np.asarray(weights, dtype=np.float64)
        self._order_backlog()
        placed = 0
        rotated: set = set()        # unfittable rids already cycled this call
        while self.backlog:
            req = self.backlog[0]
            has_room = np.array(
                [self._compatible(req, t)
                 and self._best_replica(replicas_by_tier.get(t, []), req)
                 is not None
                 for t in self.tiers]
            )
            affinity = self._affinity_replica(req, replicas_by_tier)
            if affinity is not None:
                rep, ti = affinity
                self._account_placement(ti, weights, has_room)
            else:
                ti = self._pick_tier(weights, has_room)
                if ti is None:
                    # "no room" can mean two things.  Tiers full right now:
                    # leave the head request in place and retry next tick.
                    # Request structurally unfittable on every LIVE replica
                    # (engine max_len / page budget too small): rotate it to
                    # the back so it cannot head-of-line block the backlog,
                    # and drop it after max_retries failed placements.
                    live = [r for t in self.tiers
                            if self._compatible(req, t)
                            for r in replicas_by_tier.get(t, []) if r.live]
                    if live and not any(r.fits(req) for r in live):
                        self.backlog.popleft()
                        if req.rid in rotated:
                            # one retry per tick: a fitting replica may be
                            # warming — the budget must span ticks, not burn
                            # out inside this call
                            self.backlog.append(req)
                            break
                        rotated.add(req.rid)
                        retried = req.retried()
                        if retried.retries > self.max_retries:
                            self.dropped.append(retried)
                            self.drop_reasons[req.rid] = (
                                "unfittable on any live replica "
                                f"(prompt_len={req.prompt_len}, "
                                f"max_new={req.max_new})")
                            self.tracer.event(
                                "req.failed", t=now, cat="req", rid=req.rid,
                                reason=self.drop_reasons[req.rid])
                        else:
                            self.backlog.append(retried)
                        continue
                    break                 # full everywhere: retry next tick
                rep = self._best_replica(replicas_by_tier[self.tiers[ti]], req)
            self.backlog.popleft()
            tier = self.tiers[ti]
            if rep is None or not rep.submit(req):
                # room was guaranteed above; a refusal here is a logic bug
                raise RuntimeError(f"tier {tier} refused request {req.rid}")
            hedge = self._maybe_hedge(req, ti, weights, replicas_by_tier, now)
            self.inflight[req.rid] = (req, rep, hedge)
            self.dispatched_per_tier[tier] += 1
            self.tracer.event("req.dispatched", t=now, cat="req", rid=req.rid,
                              tier=tier, replica=rep.name, load=rep.load,
                              affinity=affinity is not None,
                              retries=req.retries, model=req.model)
            if hedge is not None:
                self.tracer.event("req.hedged", t=now, cat="req", rid=req.rid,
                                  tier=hedge.tier, replica=hedge.name)
            if affinity is not None:
                self.affinity_placements += 1
            placed += 1
        return placed

    def _maybe_hedge(self, req: Request, primary_ti: int, weights: np.ndarray,
                     replicas_by_tier: Dict[str, List[Replica]],
                     now: float = 0.0) -> Optional[Replica]:
        if self.hedge_fraction <= 0.0:
            return None
        if req.past_deadline(now):
            # hedging spends capacity to pull in the latency tail; a
            # request already past its deadline cannot buy that back —
            # serve it once, don't duplicate it (no debt accrued either)
            return None
        self._hedge_debt += self.hedge_fraction
        if self._hedge_debt < 1.0:
            return None
        for ti, tier in enumerate(self.tiers):
            if ti == primary_ti or not self._compatible(req, tier):
                continue
            rep = self._best_replica(replicas_by_tier.get(tier, []), req)
            if rep is not None and rep.submit(req):
                self._hedge_debt -= 1.0
                return rep
        return None

    # -- cancellation --------------------------------------------------------
    def cancel(self, rid: int) -> bool:
        """Withdraw a request wherever it currently is: drop it from the
        backlog, and/or cancel it on the primary and hedge replicas (the
        streaming client's ``RequestHandle.cancel`` lands here).  Returns
        False when the request is unknown (already completed/dropped)."""
        before = len(self.backlog)
        self.backlog = deque(r for r in self.backlog if r.rid != rid)
        hit = len(self.backlog) < before
        entry = self.inflight.pop(rid, None)
        if entry is not None:
            _, primary, hedge = entry
            for rep in (primary, hedge):
                if rep is not None and rep.session is not None:
                    rep.session.cancel(rid)
            hit = True
        if hit:
            self.tracer.event("req.cancelled", cat="req", rid=rid)
        return hit

    # -- completion / failure ----------------------------------------------
    def on_complete(self, rid: int, source: Replica) -> Optional[Tuple[Request, Replica]]:
        """First completion wins; the hedge twin (if any) is cancelled.
        Returns (request, serving_replica) or None for a duplicate/cancelled
        completion."""
        entry = self.inflight.pop(rid, None)
        if entry is None:
            return None                   # hedge twin finished after winner
        req, primary, hedge = entry
        loser = hedge if source is primary else primary
        if loser is not None and loser is not source and loser.session is not None:
            loser.session.cancel(rid)
        return req, source

    def on_failure(self, victim: Replica, rids: List[int]) -> Tuple[List[Request], List[Request]]:
        """Requeue a dead replica's in-flight work.  Returns
        (requeued, dropped) request lists."""
        requeued: List[Request] = []
        dropped: List[Request] = []
        for rid in rids:
            entry = self.inflight.get(rid)
            if entry is None:
                continue
            req, primary, hedge = entry
            survivor = hedge if primary is victim else primary
            if survivor is not None and survivor is not victim and survivor.live:
                # hedge twin still running: strip the dead leg, keep going
                self.inflight[rid] = (req, survivor, None)
                continue
            del self.inflight[rid]
            retried = req.retried()
            if retried.retries > self.max_retries:
                self.dropped.append(retried)
                self.drop_reasons[rid] = (
                    f"max retries exceeded: {retried.retries} replica "
                    f"failures (max_retries={self.max_retries})")
                dropped.append(retried)
                self.tracer.event("req.failed", cat="req", rid=rid,
                                  replica=victim.name,
                                  reason=self.drop_reasons[rid])
            else:
                requeued.append(retried)
                self.tracer.event("req.requeued", cat="req", rid=rid,
                                  replica=victim.name, tier=victim.tier,
                                  retries=retried.retries, model=req.model)
        # oldest work to the front so retried requests cut the line
        for req in reversed(requeued):
            self.backlog.appendleft(req)
        return requeued, dropped
