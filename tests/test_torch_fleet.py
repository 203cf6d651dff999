"""The port's fleet (``repro_torch.fleet``) in lockstep with the JAX fleet.

One trace runs through a JAX ``FleetRuntime`` and the port's on the CPU,
the port's engines on weights converted from the JAX params (its
``_model_cache`` takes the converted model, so every tier's engine is
built from its own ``TierSpec`` as in JAX).  The fleets run on the same
control-loop clock, so they must agree on:

* the mode trace, every ``DecisionRecord`` and every ``TickRecord``;
* every request's record (tier, replica, retries, timestamps, tokens) and
  the dropped set;
* byte-identical outputs;
* the tracer's event stream, with the wall-time fields ``WALL_EVENT``
  dropped, and the telemetry snapshot and summary, with the wall-time keys
  ``WALL_TELEMETRY`` and ``WALL_SUMMARY`` dropped (they measure pumps on
  the host clock, which differs between frameworks; no field is removed
  from the port).

Fleets: the demo fleet without and with the cheap-tier outage, paged,
hedged, the saturated fleet (``tests/test_fleet_runtime.py``'s
scale-down drill), a speculating
saturated fleet (the controller's k retunes), and the shared-prefix fleet
with prefix reuse on and off.  Plus ``FleetClient`` streaming through the
outage, ``EngineClient``'s tracer events, ``prefix_reuse=False`` sessions
in lockstep with JAX, and the unit mirrors of ``tests/test_fleet_runtime.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_fleet_lockstep import (  # noqa: F401  (fixtures: models, _one_thread)
    WALL_EVENT,
    _one_thread,
    _adopt,
    _events,
    _fleets,
    _jax_engine,
    assert_lockstep,
    models,
)

from repro.core.capacity import CapacityPool as JaxCapacityPool
from repro.fleet import runtime as jrt
from repro.fleet.client import FleetClient as JaxFleetClient
from repro.fleet.dispatcher import Dispatcher as JaxDispatcher
from repro.fleet.replica import Replica as JaxReplica
from repro.fleet.telemetry import TelemetryBus as JaxTelemetryBus
from repro.fleet.workload import Request as JaxRequest
from repro.fleet.workload import burst_of as jax_burst_of
from repro.fleet.workload import poisson_trace as jax_poisson_trace
from repro.fleet.workload import shared_prefix_trace as jax_shared_prefix_trace
from repro.obs import Tracer as JaxTracer
from repro.serving import QueueSession as JaxQueueSession
from repro.serving.api import EngineClient as JaxEngineClient
from repro.serving.api import InferenceRequest as JaxInferenceRequest
from repro_torch.core import policy
from repro_torch.core.capacity import CapacityPool
from repro_torch.core.metrics import RequestLog, RequestRecord
from repro_torch.core.simulator import steady
from repro_torch.fleet import runtime as prt
from repro_torch.fleet.client import FleetClient
from repro_torch.fleet.dispatcher import Dispatcher
from repro_torch.fleet.replica import Replica, ReplicaState
from repro_torch.fleet.runtime import FleetRuntime, TierSpec
from repro_torch.fleet.telemetry import Ewma, TelemetryBus
from repro_torch.fleet.workload import Request, burst_of, poisson_trace, shared_prefix_trace
from repro_torch.models import Model
from repro_torch.obs import Tracer
from repro_torch.serving import EngineConfig, QueueSession, ServingEngine
from repro_torch.serving.api import EngineClient, InferenceRequest

FLEETS = {
    "demo": ("build_demo_fleet", dict(n_requests=16, rate=2.0)),
    "outage": ("build_demo_fleet", dict(n_requests=40, rate=2.0, outage=(6.0, 16.0))),
    "outage_paged": ("build_demo_fleet",
                     dict(n_requests=40, rate=2.0, outage=(6.0, 16.0), paged=True)),
    "hedged": ("build_demo_fleet", dict(n_requests=24, rate=3.0, hedge_fraction=0.5)),
    "saturated": ("build_saturated_fleet", dict(n_requests=12, n_replicas=2, decode_batch=2)),
    "speculating": ("build_saturated_fleet",
                    dict(n_requests=10, n_replicas=1, decode_batch=4, spec_k=3,
                         max_new=(12, 20))),
    "prefix": ("build_prefix_fleet", dict(prefix_len=40, requests_per_persona=4,
                                          page_size=16)),
    "prefix_off": ("build_prefix_fleet", dict(prefix_len=40, requests_per_persona=4,
                                              page_size=16, prefix_reuse=False)),
}


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_lockstep_with_jax(models, name):
    builder, kw = FLEETS[name]
    j, p = _fleets(models, builder, **kw)
    jr, pr = j.run(), p.run()
    assert_lockstep(j, p, jr, pr)
    assert not pr.requests.dropped and len(pr.requests.records) == len(p.workload)
    if name.startswith("outage"):
        # the drill of tests/test_fleet_runtime.py, held by the port as well
        assert pr.requests.total_retries() >= 1
        modes = {r.t: r.mode for r in pr.metrics.records}
        out = [m for t, m in modes.items() if 8.0 <= t < 16.0]
        assert np.mean(np.array(out) == policy.CAPACITY_OPTIMIZED) > 0.6
        assert pr.mode_sequence()[0] == policy.COST_OPTIMIZED
        for rec in pr.requests.records:
            if 8.0 <= rec.complete_t <= 16.0:
                assert rec.tier == "premium"
    if name == "outage":
        # through the kills, the outputs of one bare session
        requests = list(p.workload)
        eng = ServingEngine(models["port"], EngineConfig(max_len=64, decode_batch=4,
                                                         decode_chunk=4), device="cpu")
        for r, ref in zip(requests, _bare(eng, requests, QueueSession)):
            np.testing.assert_array_equal(pr.outputs[r.rid], ref)
    if name == "saturated":
        assert pr.requests.total_retries() == 0
        assert not p.tracer.select(name="replica.failed")
    if name == "speculating":
        tel = pr.telemetry["flat"]
        assert tel["drafted_tokens"] > 0
        assert p.tracer.select(name="ctl.speculation")
    if name == "prefix":
        assert pr.telemetry["paged"]["cache_hit_rate"] > 0
    if name == "prefix_off":
        assert pr.telemetry["paged"]["cache_hit_rate"] == 0


def _bare(engine, requests, session_cls):
    """Uninterrupted outputs of one bare session (greedy: THE answer)."""
    sess = session_cls(engine)
    for i, r in enumerate(requests):
        sess.submit(i, r.prompt, r.max_new)
    while not sess.idle:
        sess.pump()
    return [np.asarray(sess.results[i]) for i in range(len(requests))]


def test_fleet_client_streams_through_the_outage(models):
    """``FleetClient`` in both packages: every handle streams the same
    tokens at the same control-loop times, through the requeues."""
    j, p = _fleets(models, "build_demo_fleet", n_requests=40, rate=2.0, outage=(6.0, 16.0))
    jc, pc = JaxFleetClient(j), FleetClient(p)
    jh, ph = jc.adopt_workload(), pc.adopt_workload()
    extra = np.arange(1, 9, dtype=np.int64)
    jh.append(jc.submit(JaxInferenceRequest(prompt=extra, max_new=6)))
    ph.append(pc.submit(InferenceRequest(prompt=extra, max_new=6)))
    seen = {}
    while not pc.idle:
        jc.tick()
        pc.tick()
        for a, b in zip(jh, ph):
            assert b.take() == a.take()
            assert (b.status.value, b.first_token_t) == (a.status.value, a.first_token_t)
        seen.update({h.rid: h.status.value for h in ph})
    assert jc.idle
    assert set(seen.values()) == {"completed"}
    for a, b in zip(jh, ph):
        assert dataclasses.asdict(b.record) == dataclasses.asdict(a.record)
        assert (b.tier, b.replica, b.retries) == (a.tier, a.replica, a.retries)
    assert any(b.retries for b in ph)
    assert _events(p) == _events(j)


def test_fleet_client_cancel_and_drop(models):
    """Cancel before arrival and mid-decode, and a drop after max retries,
    as the JAX client reports them."""
    out = []
    for pkg, client_cls, req_cls, mod in ((0, JaxFleetClient, JaxInferenceRequest, jrt),
                                          (1, FleetClient, InferenceRequest, prt)):
        tier = mod.TierSpec(name="t", max_len=64, decode_batch=2, decode_chunk=4,
                            queue_limit=4, base_capacity=1, initial_replicas=1,
                            provision_delay_s=1.0)
        kills = [mod.FailureEvent(t=float(t), tier="t") for t in (1.0, 3.0, 5.0)]
        kw = {} if pkg == 0 else dict(device="cpu")
        rt = mod.FleetRuntime([tier], [], mod.FleetConfig(max_retries=2), failures=kills, **kw)
        if pkg == 0:
            _adopt(models, rt, prt.FleetRuntime([], [], device="cpu"))
        else:
            _adopt(models, jrt.FleetRuntime([], []), rt)
        c = client_cls(rt)
        prompt = np.arange(3, 11, dtype=np.int64)
        hs = [c.submit(req_cls(prompt=prompt + i, max_new=40)) for i in range(3)]
        c.cancel(hs[2])
        c.drain()
        out.append([(h.status.value, h.failure_reason, h.take()) for h in hs]
                   + [sorted(rt.request_log.dropped)])
    assert out[1] == out[0]
    assert out[1][0][0] == "failed" and "max retries" in out[1][0][1]
    assert out[1][2][0] == "cancelled"


def test_engine_client_tracer_events_match_jax(models):
    """``EngineClient(tracer=)``, ``submit(rid=)`` and its events
    (``engine.speculate`` among them) as the JAX client emits them; the
    wall clock's ``t`` and the wall fields are dropped."""
    spec = TierSpec(name="x", max_len=96, decode_batch=3, decode_chunk=4, spec_k=3)
    jeng = _jax_engine(models, spec)
    peng = ServingEngine(models["port"], EngineConfig(max_len=96, decode_batch=3,
                                                      decode_chunk=4, spec_k=3), device="cpu")
    rng = np.random.default_rng(2)
    base = rng.integers(0, 512, 6)
    prompts = [np.tile(base, 4)[:20 + i] for i in range(4)]     # periodic: drafts accept
    traces = []
    for client_cls, req_cls, tracer_cls, eng in (
            (JaxEngineClient, JaxInferenceRequest, JaxTracer, jeng),
            (EngineClient, InferenceRequest, Tracer, peng)):
        tr = tracer_cls()
        kw = {} if client_cls is JaxEngineClient else dict(device="cpu")
        c = client_cls(eng, tracer=tr, **kw)
        hs = [c.submit(req_cls(prompt=p, max_new=24), rid=10 + i) for i, p in enumerate(prompts)]
        c.cancel(hs[3])
        c.drain()
        assert [h.rid for h in hs] == [10, 11, 12, 13]
        traces.append(([h.take() for h in hs],
                       [{k: v for k, v in e.items() if k not in WALL_EVENT + ("t",)}
                        for e in tr.to_list()]))
    assert traces[1] == traces[0]
    names = {e["name"] for e in traces[1][1]}
    assert {"req.queued", "engine.pump", "engine.speculate", "req.first_token",
            "req.completed", "req.cancelled"} <= names


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "legacy"])
def test_prefix_reuse_off_sessions_lockstep(models, mixed):
    """``EngineConfig.prefix_reuse=False`` (the allocator's
    ``enable_reuse=False``): no prefix hit, pump by pump with the JAX
    session, and the streams those of reuse on."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 512, 32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, 5)])[None] for _ in range(4)]
    prompts += [prompts[0]]                         # an identical prompt too
    streams = {}
    for reuse in (True, False):
        spec = TierSpec(name="x", max_len=64, decode_batch=2, decode_chunk=4, mixed_step=mixed,
                        paged_kv=True, page_size=8, prefix_reuse=reuse)
        jsess = JaxQueueSession(_jax_engine(models, spec))
        psess = QueueSession(ServingEngine(models["port"], EngineConfig(
            max_len=64, decode_batch=2, decode_chunk=4, mixed_step=mixed, paged_kv=True,
            page_size=8, prefix_reuse=reuse), device="cpu"))
        assert psess.allocator.enable_reuse is reuse
        for i, pr in enumerate(prompts):
            jsess.submit(i, pr, 6)
            psess.submit(i, pr, 6)
        hits = 0
        while not jsess.idle:
            jr, pr_ = jsess.pump(), psess.pump()
            for f in ("admitted", "emitted", "prefix_hits", "prefix_misses", "reused_tokens",
                      "prefilled_tokens", "cached_pages"):
                assert getattr(pr_, f) == getattr(jr, f), f
            hits += pr_.prefix_hits
            assert psess.prefix_match_len(prompts[0]) == jsess.prefix_match_len(prompts[0])
        assert psess.idle
        assert dataclasses.asdict(psess.allocator.stats) == dataclasses.asdict(jsess.allocator.stats)
        assert (hits > 0) is reuse
        streams[reuse] = [psess.results[i].tolist() for i in range(len(prompts))]
        assert streams[reuse] == [np.asarray(jsess.results[i]).tolist()
                                  for i in range(len(prompts))]
    assert streams[False] == streams[True]


# ---------------------------------------------------------------------------
# construction: the device, the arches
# ---------------------------------------------------------------------------


def test_fleet_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetRuntime([TierSpec(name="a")], [])
    with pytest.raises(RuntimeError, match="CUDA"):
        prt.build_demo_fleet(n_requests=2)


def test_fleet_arches_fail_fast():
    with pytest.raises(KeyError, match="unknown serving arch"):
        FleetRuntime([TierSpec(name="a", arch="nope")], [], device="cpu")
    with pytest.raises(ValueError, match="job"):
        FleetRuntime([TierSpec(name="a", arch="sd21")], [], device="cpu")
    with pytest.raises(ValueError, match="job"):
        prt.build_multimodel_day_fleet(device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        FleetRuntime([TierSpec(name="a"), TierSpec(name="a")], [], device="cpu")


def test_tier_models_shared_by_arch_seed_and_overrides():
    tiers = [TierSpec(name="a"), TierSpec(name="b", decode_batch=4),
             TierSpec(name="c", param_seed=1)]
    rt = FleetRuntime(tiers, [], prt.FleetConfig(warmup=False), device="cpu")
    ea, eb, ec = (rt._engine_for(t) for t in tiers)
    assert ea.model is eb.model and ea.model is not ec.model
    assert ea.device == torch.device("cpu") and not ea.graphs
    assert not torch.equal(ea.model.embed, ec.model.embed)
    assert torch.equal(ea.model.embed, Model(ea.model.cfg, device="cpu").init_(
        torch.Generator().manual_seed(0)).embed)


# ---------------------------------------------------------------------------
# unit mirrors of tests/test_fleet_runtime.py, each against the JAX piece
# ---------------------------------------------------------------------------


def test_capacity_pool_matches_jax():
    def script(cls):
        p = cls(base_capacity=20, provision_delay_s=10.0)
        out = [p.request(0.0, 10), p.inflight, p.request(1.0, 4), p.inflight, p.tick(20.0)]
        out += [p.request(21.0, 8), p.tick(40.0), p.request(41.0, 12), p.request(42.0, 9),
                p.inflight, p.tick(60.0), p.request(61.0, 2), p.ready, p.inflight]
        p.warm = 2
        out += [p.request(62.0, 5), p.stock_warm(62.0, 3), p.warm_inflight, p.tick(80.0),
                p.cancel_pending(1), p.release_standby(1), p.ready, p.warm]
        return out
    assert script(CapacityPool) == script(JaxCapacityPool)


def _request(cfg, rid, *, plen=8, max_new=6, cls=Request):
    rng = np.random.default_rng(rid)
    return cls(rid=rid, arrival_t=0.0, max_new=max_new,
               prompt=rng.integers(0, cfg.vocab_size, (1, plen)))


def test_queue_session_late_submissions_and_cancel(models):
    """Requests submitted across pump boundaries decode as one batch does;
    ``inflight_rids`` lists slot occupants first; cancel of a queued and
    of an active request; an idle pump is a no-op."""
    cfg = models["cfg"]
    eng = ServingEngine(models["port"], EngineConfig(max_len=64, decode_batch=2,
                                                     decode_chunk=4), device="cpu")
    reqs = [_request(cfg, i, max_new=n) for i, n in enumerate((5, 7, 4, 6))]
    sess = QueueSession(eng)
    sess.submit(0, reqs[0].prompt, 5)
    sess.pump()
    for r in reqs[1:3]:
        sess.submit(r.rid, r.prompt, r.max_new)
    sess.pump()
    sess.submit(3, reqs[3].prompt, 6)
    while not sess.idle:
        sess.pump()
    ref = _bare(eng, reqs, QueueSession)
    for i in range(4):
        np.testing.assert_array_equal(sess.results[i], ref[i])

    sess = QueueSession(eng)
    for r in reqs:
        sess.submit(r.rid, r.prompt, 8)
    sess.pump()
    inflight = sess.inflight_rids()
    assert set(inflight) == {0, 1, 2, 3} and set(inflight[:2]) == {0, 1}
    assert sess.cancel(2) and sess.cancel(0)
    while not sess.idle:
        sess.pump()
    assert set(sess.results) == {1, 3} and not sess.cancel(1)
    rep = sess.pump()
    assert rep.chunk_steps == 0 and not rep.completed


def test_replica_lifecycle_matches_jax(models):
    cfg = models["cfg"]
    spec = TierSpec(name="t", max_len=64, decode_batch=2, decode_chunk=4)
    out = []
    for rcls, qcls, eng in ((JaxReplica, JaxRequest, _jax_engine(models, spec)),
                            (Replica, Request, ServingEngine(
                                models["port"], EngineConfig(max_len=64, decode_batch=2,
                                                             decode_chunk=4), device="cpu"))):
        trace = []
        rep = rcls("t/r1", "t", eng, queue_limit=3)
        trace += [rep.state.value, rep.accepting]
        rep.warm()
        trace += [rep.state.value, rep.accepting]
        rep.activate(1.0)
        trace += [rep.submit(_request(cfg, i, cls=qcls)) for i in range(4)]
        rep.drain()
        trace += [rep.state.value, rep.accepting]
        while rep.state.value == "draining":
            r = rep.pump()
            if r is None:
                break
            trace.append(sorted((k, v.tolist()) for k, v in r.completed.items()))
        trace.append(rep.state.value)
        rep2 = rcls("t/r2", "t", eng, queue_limit=3)
        rep2.activate(0.0)
        trace += [rep2.submit(_request(cfg, i, cls=qcls)) for i in range(3)]
        rep2.pump()
        trace += [sorted(rep2.fail()), rep2.state.value, rep2.session is None]
        rep3 = rcls("t/r3", "t", eng, queue_limit=3)
        rep3.warm()
        rep3.drain()
        trace.append(rep3.state.value)
        out.append(trace)
    assert out[1] == out[0]
    assert out[1][-1] == ReplicaState.TERMINATED.value


def test_dispatcher_spill_requeue_and_drop_match_jax(models):
    cfg = models["cfg"]
    spec = TierSpec(name="t", max_len=64, decode_batch=2, decode_chunk=4)
    out = []
    for dcls, rcls, qcls, eng in (
            (JaxDispatcher, JaxReplica, JaxRequest, _jax_engine(models, spec)),
            (Dispatcher, Replica, Request, ServingEngine(
                models["port"], EngineConfig(max_len=64, decode_batch=2, decode_chunk=4),
                device="cpu"))):
        a, b = rcls("a/r1", "a", eng, queue_limit=2), rcls("b/r1", "b", eng, queue_limit=2)
        a.activate(0.0)
        b.activate(0.0)
        d = dcls(["a", "b"], max_retries=1)
        d.submit([_request(cfg, i, cls=qcls) for i in range(6)])
        trace = [d.dispatch(np.array([1.0, 0.0]), {"a": [a], "b": [b]}), a.load, b.load,
                 len(d.backlog), d.quiet]
        rids = a.fail()
        requeued, dropped = d.on_failure(a, rids)
        trace += [[r.rid for r in requeued], [r.rid for r in dropped],
                  [r.rid for r in list(d.backlog)[:2]], [r.retries for r in requeued]]
        a2 = rcls("a/r2", "a", eng, queue_limit=2)
        a2.activate(0.0)
        trace.append(d.dispatch(np.array([0.5, 0.5]), {"a": [a2], "b": [b]}))
        requeued, dropped = d.on_failure(a2, a2.fail())
        trace += [[r.rid for r in requeued], [r.rid for r in dropped], dict(d.drop_reasons)]
        out.append(trace)
    assert out[1] == out[0]
    assert out[1][0] == 4 and out[1][-2]          # spilled, and dropped after max retries


def test_telemetry_and_measured_t_max_match_jax():
    e = Ewma(alpha=0.5)
    assert e.value is None and e.get(7.0) == 7.0
    assert e.update(4.0) == 4.0 and e.update(8.0) == 6.0

    class FakeReport:
        completed = {0: None, 1: None}
        useful_tokens = 8
        wasted_tokens = 0
        occupancy = 1.0
        wall_s = 0.01

    nominal = np.array([5.0, 3.0])
    out = []
    for cls in (JaxTelemetryBus, TelemetryBus):
        bus = cls(["a", "b"], alpha=0.5)
        trace = [bus.measured_t_max(nominal).tolist()]
        for tick in range(4):
            bus.record_ready("a", 1 + tick % 2)
            if tick != 2:
                bus.record_pump("a", "a/r1", FakeReport(), queue_depth=tick)
            bus.roll(tick_s=1.0)
            trace.append(bus.measured_t_max(nominal).tolist())
        out.append(trace)
    assert out[1] == out[0]
    assert out[1][1][0] == pytest.approx(2.0) and out[1][1][1] == 3.0


def test_request_log_metrics():
    log = RequestLog()
    log.append(RequestRecord(rid=0, arrival_t=0.0, first_token_t=1.0, complete_t=5.0,
                             prompt_len=8, tokens=5, retries=1, tier="a"))
    log.append(RequestRecord(rid=1, arrival_t=2.0, first_token_t=2.5, complete_t=4.0,
                             prompt_len=8, tokens=1, tier="b", slo_class="batch"))
    assert log.records[0].ttft_s == 1.0 and log.records[0].tpot_s == pytest.approx(1.0)
    assert log.goodput_tokens() == 6 and log.goodput_tokens_per_s() == pytest.approx(6 / 5.0)
    assert log.total_retries() == 1
    assert log.ttft_percentile(50.0, slo_class="batch") == pytest.approx(0.5)
    assert log.per_tier_counts() == {"a": 1, "b": 1}
    assert log.summary()["requests_completed"] == 2.0


def test_workload_generators_match_jax():
    from repro.core.simulator import steady as jax_steady

    def same(a, b):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert (x.rid, x.arrival_t, x.max_new, x.slo_class, x.model) == \
                (y.rid, y.arrival_t, y.max_new, y.slo_class, y.model)
            np.testing.assert_array_equal(x.prompt, y.prompt)

    same(poisson_trace(steady(4.0), 10.0, vocab_size=64, seed=7),
         jax_poisson_trace(jax_steady(4.0), 10.0, vocab_size=64, seed=7))
    same(burst_of(9, vocab_size=64, seed=3), jax_burst_of(9, vocab_size=64, seed=3))
    same(shared_prefix_trace(2, 3, vocab_size=64, seed=1),
         jax_shared_prefix_trace(2, 3, vocab_size=64, seed=1))
