"""Hypothesis property tests on durable-KV recovery invariants.

Two layers:

* pure ``KVStore`` properties — random op sequences can never break the
  store's accounting (occupancy == sum of entries, capacity respected,
  frontiers only ever advance);
* fleet-level cancel-vs-kill races — random cancellation schedules racing
  replica crashes keep the recovery invariants: survivors token-exact,
  cancelled streams are prefixes of the true output, no leaked KV pages,
  no orphaned store accounting.

The seeded-race drill in ``test_durable_kv.py`` is the executable fallback
where hypothesis is unavailable (this whole module skips).
"""
import pytest

pytest.importorskip("hypothesis")

import hypothesis.strategies as st
import jax
import numpy as np
from hypothesis import example, given, settings

from repro.configs import get_config
from repro.fleet.client import FleetClient
from repro.fleet.kv_store import KVStore
from repro.fleet.runtime import build_recovery_fleet
from repro.models import Model
from repro.serving import EngineConfig, ServingEngine
from repro.serving.api import RequestStatus
from repro.serving.paged_kv import KVFrontier

# ---------------------------------------------------------------------------
# KVStore accounting properties (no engine)
# ---------------------------------------------------------------------------

_prompts = st.lists(st.integers(0, 50), min_size=1, max_size=8)


@st.composite
def store_ops(draw):
    """A random op sequence over a small store."""
    ops = []
    for _ in range(draw(st.integers(1, 40))):
        kind = draw(st.sampled_from(["put", "get", "drop"]))
        prompt = tuple(draw(_prompts))
        if kind == "put":
            gen = tuple(draw(st.lists(st.integers(0, 9), max_size=6)))
            ops.append(("put", prompt, gen))
        else:
            ops.append((kind, prompt, ()))
    return ops


@given(store_ops(), st.integers(8, 64), st.integers(1, 6))
@settings(max_examples=200, deadline=None)
# an LRU eviction forgets a prompt; a shorter put of it is then accepted
@example(ops=[("put", (0, 0), (1, 2, 3, 4)), ("put", (1,) * 8, ()),
              ("put", (0, 0), ()), ("get", (0, 0), ())],
         capacity=8, max_entries=6)
def test_store_accounting_never_breaks(ops, capacity, max_entries):
    st_ = KVStore(capacity_tokens=capacity, max_entries=max_entries)
    longest = {}                      # prompt -> longest accepted frontier
    for kind, prompt, gen in ops:
        if kind == "put":
            fr = KVFrontier(prompt=prompt, generated=gen, carry_tok=0,
                            pages_kv=None, page_size=16)
            if st_.put(fr):
                longest[prompt] = max(longest.get(prompt, 0), fr.tokens)
            # what eviction dropped is forgotten, so it may come back shorter
            longest = {p: n for p, n in longest.items() if p in st_._entries}
        elif kind == "get":
            got = st_.get(prompt)
            if got is not None:
                # a stored frontier never regresses below an accepted put
                # while the store still holds it
                assert got.tokens >= longest.get(prompt, 0)
        else:
            st_.drop(prompt)
            longest.pop(prompt, None)
        # the accounting invariants hold after EVERY op
        assert st_.occupancy_tokens == sum(
            f.tokens for f in st_._entries.values())
        assert st_.occupancy_tokens <= st_.capacity_tokens
        assert len(st_) <= st_.max_entries


# ---------------------------------------------------------------------------
# fleet-level cancel-vs-kill race properties
# ---------------------------------------------------------------------------

PLEN = 96
MAX_NEW = (8, 12)
PAGE = 16
MAX_LEN = -(-(PLEN + MAX_NEW[1]) // PAGE) * PAGE
NUM_PAGES = 1 + 2 * 3 * (MAX_LEN // PAGE)
_WORKLOAD_SEED = 0                    # fixed workload => one cached reference


@pytest.fixture(scope="module")
def spot():
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    eng = ServingEngine(model, params, EngineConfig(
        max_len=MAX_LEN, decode_batch=3, temperature=0.0, decode_chunk=4,
        mixed_step=True, prefill_chunk=64, paged_kv=True, page_size=PAGE,
        num_pages=NUM_PAGES, prefix_reuse=True))
    return eng, {}


@pytest.mark.slow
@given(cancel_seed=st.integers(0, 2**31 - 1),
       kill_t=st.floats(1.0, 4.0),
       p_cancel=st.floats(0.1, 0.6))
@settings(max_examples=5, deadline=None)
def test_cancel_kill_race_properties(spot, cancel_seed, kill_t, p_cancel):
    eng, ref_cache = spot
    rt = build_recovery_fleet(
        prompt_len=PLEN, max_new=MAX_NEW, page_size=PAGE, kv_store=True,
        kill_ts=(float(kill_t),), preempt_t=None, seed=_WORKLOAD_SEED)
    rt._engines["spot"] = eng
    requests = list(rt.workload)
    if not ref_cache:                 # greedy: one reference serves all runs
        refs = eng.serve_queue([(r.prompt, r.max_new) for r in requests])
        ref_cache.update({r.rid: refs[i] for i, r in enumerate(requests)})
    client = FleetClient(rt)
    handles = client.adopt_workload()
    rng = np.random.default_rng(cancel_seed)
    cancelled = set()
    while not client.idle and rt.ticks < rt.cfg.max_ticks:
        client.tick()
        live = [h for h in handles if not h.done]
        if live and rng.random() < p_cancel:
            h = live[int(rng.integers(len(live)))]
            if client.cancel(h):
                cancelled.add(h.rid)

    for h in handles:
        assert h.done
        got = np.asarray(h.take(), np.int64)
        ref = ref_cache[h.rid]
        if h.rid in cancelled:
            assert h.status is RequestStatus.CANCELLED
            np.testing.assert_array_equal(got, ref[:len(got)])
        else:
            assert h.status is RequestStatus.COMPLETED
            np.testing.assert_array_equal(got, ref)
    # no leaked KV pages on any surviving session
    for reps in rt.replicas.values():
        for rep in reps:
            if rep.session is not None and rep.session.allocator is not None:
                assert rep.session.allocator.live_pages == 0
    # no orphaned store accounting
    kv = rt.kv_store
    assert kv.occupancy_tokens == sum(
        f.tokens for f in kv._entries.values())
    assert kv.occupancy_tokens <= kv.capacity_tokens
