"""Recovery in the port's fleet against the JAX fleet (CPU).

* ``build_recovery_fleet`` (the durable-KV drill of ``tests/test_durable_kv.py``
  at its 96-token geometry: mid-decode kills, a preemption notice, the
  crash-loop guard) with the fleet KV store on and off, in lockstep with
  JAX (``torch_fleet_lockstep.assert_lockstep``): recovered and recomputed
  prefill tokens, store counters, outputs and event streams equal;
* the spot and serverless procurement classes of ``tests/test_economics.py``:
  seeded cold starts and stochastic reclaims give the same event sequence
  in both packages, over a day-cycle fleet; the idle- and loaded-victim
  preemption paths;
* a wedged replica found by the heartbeat, with no scripted failure;
* ``tests/test_recovery_props.py`` mirrored for the port's ``KVStore`` (the
  accounting property, its model forgetting what eviction dropped, op for op against
  the JAX store) and its cancel-vs-kill race, plus the ``FAILED`` handle
  after too many kills.
"""
import dataclasses

import pytest

pytest.importorskip("hypothesis")

import hypothesis.strategies as st
import numpy as np
from hypothesis import example, given, settings
from torch_fleet_lockstep import (  # noqa: F401  (fixtures: models, _one_thread)
    _adopt,
    _events,
    _fleets,
    _one_thread,
    assert_lockstep,
    models,
)

from repro.fleet import runtime as jrt
from repro.fleet.client import FleetClient as JaxFleetClient
from repro.fleet.kv_store import KVStore as JaxKVStore
from repro.serving.paged_kv import KVFrontier as JaxKVFrontier
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.fleet import runtime as prt
from repro_torch.fleet.client import FleetClient
from repro_torch.fleet.kv_store import KVStore
from repro_torch.fleet.replica import ReplicaState
from repro_torch.fleet.workload import Request
from repro_torch.serving.api import RequestStatus
from repro_torch.serving.paged_kv import KVFrontier

PLEN = 96
MAX_NEW = (8, 12)
PAGE = 16


def _drill(models, **kw):
    kw.setdefault("prompt_len", PLEN)
    kw.setdefault("max_new", MAX_NEW)
    kw.setdefault("page_size", PAGE)
    return _fleets(models, "build_recovery_fleet", **kw)


@pytest.mark.parametrize("store", [True, False], ids=["store", "no_store"])
def test_recovery_drill_lockstep_with_jax(models, store):
    j, p = _drill(models, kv_store=store, kill_ts=(2.0, 2.0), seed=0)
    if store:
        j.cfg.crash_backoff_base_s = p.cfg.crash_backoff_base_s = 1.0
    jr, pr = j.run(), p.run()
    assert_lockstep(j, p, jr, pr)
    s, tel = pr.summary(), pr.telemetry["spot"]
    assert not pr.requests.dropped and pr.requests.total_retries() >= 1
    if store:
        assert s["recomputed_prefill_tokens"] == 0 and s["recovered_tokens"] > 0
        assert pr.kv_store["puts"] > 0 and pr.kv_store["hits"] > 0
        assert tel["kv_flush_tokens"] > 0 and tel["crash_backoffs"] >= 1
    else:
        assert s["recomputed_prefill_tokens"] > 0 and s["recovered_tokens"] == 0
        assert pr.kv_store is None


def test_preemption_drain_lockstep_with_jax(models):
    """A preemption notice drains the victim's KV before the deadline
    kill; victims resume with zero re-prefill, as in JAX."""
    j, p = _drill(models, kv_store=True, kill_ts=(), preempt_t=2.0, preempt_deadline_s=1.0,
                  max_new=(12, 16), seed=1)
    jr, pr = j.run(), p.run()
    assert_lockstep(j, p, jr, pr)
    assert pr.telemetry["spot"]["kv_flush_tokens"] > 0
    assert pr.summary()["recovered_tokens"] > 0
    assert pr.summary()["recomputed_prefill_tokens"] == 0


def test_wedged_replica_found_by_heartbeat(models):
    """A hung replica (READY, no beats, no work) is killed by the missed-pump
    detector with no scripted failure; its work requeues, as in JAX."""
    runs = []
    for rt in _drill(models, kv_store=True, kill_ts=(), preempt_t=None, seed=3):
        rt.heartbeats.deadline_s = 2.0
        rt.warmup()
        while not rt.dispatcher.inflight:
            rt.tick()
        carrier = rt.dispatcher.inflight[next(iter(rt.dispatcher.inflight))][1]
        carrier.wedge()
        runs.append((rt, rt.run(), carrier))
    (j, jr, jc), (p, pr, pc) = runs
    assert_lockstep(j, p, jr, pr)
    assert pc.state == ReplicaState.FAILED
    assert p.tracer.select(name="ctl.wedge_death")
    assert pr.requests.total_retries() >= 1 and not pr.requests.dropped


def test_heartbeat_monitor():
    hb = HeartbeatMonitor(deadline_s=2.0)
    hb.beat(1, 0.0)
    hb.beat(2, 1.0)
    assert hb.dead(2.5) == [1] and hb.alive(2.5) == [2]
    hb.forget(1)
    assert hb.dead(10.0) == [2] and hb.alive(10.0) == []


# ---------------------------------------------------------------------------
# procurement classes: seeded cold starts, reclaims, warm pools
# ---------------------------------------------------------------------------


def test_spot_and_serverless_day_fleet_lockstep(models):
    """The day-cycle fleet (a spot tier with lognormal cold starts and a
    per-tick reclaim hazard, a serverless burst tier, a warm standby pool):
    the same seeded draws give the same event sequence."""
    j, p = _fleets(models, "build_day_fleet", n_days=1, period_s=60.0, peak_rps=2.5,
                   preemption_rate=3.0, warm_pool=1, spot_cold_start_s=3.0)
    for rt in (j, p):
        for spec in rt.tiers:
            spec.cold_start_sigma = 0.4
        rt._econ = {t.name: t.economics() for t in rt.tiers}
        rt.pools["spot"].delay_sampler = rt._make_cold_start_sampler(rt.tiers[0], 0)
    jr, pr = j.run(), p.run()
    assert_lockstep(j, p, jr, pr)
    econ = pr.economics()
    assert econ["spot"]["preemptions"] > 0 and econ["spot"]["cold_starts"] > 0
    assert econ["burst"]["cold_starts"] > 0
    assert p.tracer.select(name="replica.cold_start")
    assert pr.economics() == jr.economics()
    assert pr.total_cost_usd == jr.total_cost_usd > 0


def test_cold_start_sampler_matches_jax():
    draws = []
    for mod, kw in ((jrt, {}), (prt, dict(device="cpu"))):
        tier = mod.TierSpec(name="spot", tier_class="spot", initial_replicas=0)
        rt = mod.FleetRuntime([tier], [], mod.FleetConfig(seed=3), **kw)
        draws.append([rt.pools["spot"].delay_sampler() for _ in range(16)]
                     + [rt.telemetry.tier_cold_starts["spot"],
                        [e["delay_s"] for e in rt.tracer.select(name="replica.cold_start")]])
    assert draws[1] == draws[0]
    assert len(set(draws[1][:16])) > 1


@pytest.mark.parametrize("victim", ["idle_ready", "warm_standby", "loaded"])
def test_preemption_paths_match_jax(models, victim):
    """An idle victim releases at once (no notice, no flush, no requeue); a
    loaded one gets the notice and drains, as in JAX."""
    out = []
    for mod, kw in ((jrt, {}), (prt, dict(device="cpu"))):
        tier = mod.TierSpec(name="spot", tier_class="spot", preemption_rate=0.0,
                            cold_start_s=2.0, cold_start_sigma=0.0, initial_replicas=0,
                            base_capacity=4)
        rt = mod.FleetRuntime([tier], [], mod.FleetConfig(seed=0, kv_store=True), **kw)
        if mod is jrt:
            _adopt(models, rt, prt.FleetRuntime([], [], device="cpu"))
        else:
            _adopt(models, jrt.FleetRuntime([], []), rt)
        pool = rt.pools["spot"]
        rep = rt._new_replica(tier)
        if victim == "warm_standby":
            rep.warm()
            pool.warm = 1
        else:
            rep.activate(0.0)
            pool.ready = 1
        rt.replicas["spot"].append(rep)
        if victim == "loaded":
            prompt = np.arange(1, 9, dtype=np.int32)[None, :]
            req = (Request if mod is prt else mod.Request)(rid=0, arrival_t=0.0, prompt=prompt,
                                                          max_new=4)
            assert rep.submit(req)
        rt._preempt(tier, rep, deadline_t=2.0)
        out.append((rep.state.value, rep.preempt_deadline, pool.ready, pool.warm,
                    _events(rt), rt.telemetry.tier_idle_released["spot"],
                    rt.telemetry.tier_preemptions["spot"]))
    assert out[1] == out[0]
    names = [e["name"] for e in out[1][4]]
    assert ("ctl.preempt_notice" in names) is (victim == "loaded")
    assert "req.requeued" not in names


# ---------------------------------------------------------------------------
# the port's KVStore: tests/test_recovery_props.py mirrored
# ---------------------------------------------------------------------------

_prompts = st.lists(st.integers(0, 50), min_size=1, max_size=8)


@st.composite
def store_ops(draw):
    ops = []
    for _ in range(draw(st.integers(1, 40))):
        kind = draw(st.sampled_from(["put", "get", "drop", "match"]))
        prompt = tuple(draw(_prompts))
        gen = tuple(draw(st.lists(st.integers(0, 9), max_size=6))) if kind == "put" else ()
        ops.append((kind, prompt, gen))
    return ops


def _apply(store, frontier_cls, ops):
    out = []
    for kind, prompt, gen in ops:
        if kind == "put":
            out.append(store.put(frontier_cls(prompt=prompt, generated=gen, carry_tok=0,
                                              pages_kv=None, page_size=16)))
        elif kind == "get":
            got = store.get(prompt)
            out.append(None if got is None else (got.prompt, got.generated))
        elif kind == "match":
            out.append(store.match_len(prompt))
        else:
            out.append(store.drop(prompt))
        out.append((store.occupancy_tokens, len(store), list(store._entries)))
    return out + [store.snapshot()]


@given(store_ops(), st.integers(8, 64), st.integers(1, 6))
@settings(max_examples=200, deadline=None)
# an LRU eviction forgets a prompt; a shorter put of it is then accepted
@example(ops=[("put", (0, 0), (1, 2, 3, 4)), ("put", (1,) * 8, ()),
              ("put", (0, 0), ()), ("get", (0, 0), ())],
         capacity=8, max_entries=6)
def test_store_accounting_never_breaks(ops, capacity, max_entries):
    """The accounting invariants after every op, with the model that
    forgets what eviction dropped; and op for op the JAX store's results."""
    st_ = KVStore(capacity_tokens=capacity, max_entries=max_entries)
    longest = {}                      # prompt -> longest accepted frontier
    for kind, prompt, gen in ops:
        if kind == "put":
            fr = KVFrontier(prompt=prompt, generated=gen, carry_tok=0, pages_kv=None,
                            page_size=16)
            if st_.put(fr):
                longest[prompt] = max(longest.get(prompt, 0), fr.tokens)
            longest = {q: n for q, n in longest.items() if q in st_._entries}
        elif kind == "get":
            got = st_.get(prompt)
            if got is not None:
                assert got.tokens >= longest.get(prompt, 0)
        elif kind == "match":
            assert st_.match_len(prompt) == (longest.get(prompt, 0) and
                                             st_._entries[prompt].tokens)
        else:
            st_.drop(prompt)
            longest.pop(prompt, None)
        assert st_.occupancy_tokens == sum(f.tokens for f in st_._entries.values())
        assert st_.occupancy_tokens <= st_.capacity_tokens
        assert len(st_) <= st_.max_entries
    assert _apply(KVStore(capacity, max_entries), KVFrontier, ops) == \
        _apply(JaxKVStore(capacity, max_entries), JaxKVFrontier, ops)


@pytest.mark.parametrize("seed,kill_t,p_cancel", [(0, 1.5, 0.35), (7, 3.0, 0.45), (11, 2.0, 0.5)])
def test_cancel_kill_race_lockstep(models, seed, kill_t, p_cancel):
    """Seeded cancels racing a replica kill, through both packages' clients:
    the same handles end the same way with the same tokens; survivors equal
    the uninterrupted streams, cancelled ones are prefixes of them; no
    surviving session holds a page; the store's accounting holds."""
    j, p = _drill(models, kv_store=True, kill_ts=(kill_t,), preempt_t=None, seed=0)
    out = []
    for rt, client_cls in ((j, JaxFleetClient), (p, FleetClient)):
        client = client_cls(rt)
        handles = client.adopt_workload()
        rng = np.random.default_rng(seed)
        cancelled = set()
        while not client.idle and rt.ticks < rt.cfg.max_ticks:
            client.tick()
            live = [h for h in handles if not h.done]
            if live and rng.random() < p_cancel:
                h = live[int(rng.integers(len(live)))]
                if client.cancel(h):
                    cancelled.add(h.rid)
        for reps in rt.replicas.values():
            for rep in reps:
                if rep.session is not None and rep.session.allocator is not None:
                    assert rep.session.allocator.live_pages == 0
        kv = rt.kv_store
        assert kv.occupancy_tokens == sum(f.tokens for f in kv._entries.values())
        out.append((sorted(cancelled), [(h.rid, h.status.value, h.take()) for h in handles]))
    assert out[1] == out[0]
    assert out[1][0] and len(out[1][0]) < len(out[1][1])
    _, full = _drill(models, kv_store=False, kill_ts=(), preempt_t=None, seed=0)
    ref = full.run().outputs
    for rid, status, toks in out[1][1]:
        want = ref[rid].tolist()
        assert (toks == want) if status == RequestStatus.COMPLETED.value else \
            (status == RequestStatus.CANCELLED.value and toks == want[:len(toks)])


def test_three_kills_fail_the_handle(models):
    """More deaths than ``max_retries`` fail the handle with a reason."""
    out = []
    for mod, client_cls in ((jrt, JaxFleetClient), (prt, FleetClient)):
        tier = mod.TierSpec(name="spot", max_len=112, decode_batch=3, decode_chunk=4,
                            queue_limit=6, base_capacity=1, initial_replicas=1,
                            provision_delay_s=1.0, paged_kv=True, page_size=PAGE,
                            num_pages=43, prefill_chunk=64)
        kills = [mod.FailureEvent(t=float(t), tier="spot") for t in (1.0, 4.0, 7.0)]
        kw = {} if mod is jrt else dict(device="cpu")
        rt = mod.FleetRuntime([tier], [], mod.FleetConfig(max_retries=2, seed=0),
                              failures=kills, **kw)
        if mod is jrt:
            _adopt(models, rt, prt.FleetRuntime([], [], device="cpu"))
        else:
            _adopt(models, jrt.FleetRuntime([], []), rt)
        client = client_cls(rt)
        from repro.serving.api import InferenceRequest as JaxInferenceRequest
        from repro_torch.serving.api import InferenceRequest

        req_cls = JaxInferenceRequest if mod is jrt else InferenceRequest
        prompt = np.random.default_rng(7).integers(1, 512, (1, 8))
        h = client.submit(req_cls(prompt=prompt, max_new=90))
        client.drain()
        out.append((h.status.value, h.failure_reason, h.rid in rt.request_log.dropped,
                    [dataclasses.asdict(d) for d in rt.decisions]))
    assert out[1] == out[0]
    assert out[1][0] == RequestStatus.FAILED.value and "max retries" in out[1][1]
