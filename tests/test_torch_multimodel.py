"""The port's heterogeneous multi-model fleet against the JAX package's (CPU).

``build_multimodel_day_fleet(period_s=60)``: a paged qwen3-0.6b tier, an
rwkv6-7b scan tier and the sd21 job tier behind one control loop, both
packages on one trace, the port's ``_model_cache`` holding the models
converted from the JAX params (seed 0, ``reduce()``).  The fleets must
agree as ``torch_fleet_lockstep.assert_lockstep`` holds them (mode trace,
decisions, tick and request records, tracer events and telemetry with the
wall fields dropped, LLM and scan outputs byte for byte), with one
exception: the job tier's digests, drawn from the port's own weights and
noise (``serving/diffusion.py``), match JAX's in rids and lengths and
equal a standalone port engine's digest of each prompt.  The trace holds
JAX's capacity trades: the jobs tier borrows from llm at 63 and 72 s and
from scan at 72 s, and both leases return at 75 s.

Plus mirrors of ``tests/test_multimodel.py`` on the port: model-aware
routing (3), capacity trading (2, each also against JAX's events) and the
rwkv6 scan tier (3: the session token-exact against JAX's ``serve_queue``,
a ``StateFrontier`` resumed byte-identically, and the kill drill in
lockstep with JAX).
"""
import jax
import numpy as np
import pytest
import torch
from torch_fleet_lockstep import _events, _one_thread, assert_lockstep  # noqa: F401

from repro.configs import get_config as jax_get_config
from repro.fleet import runtime as jrt
from repro.fleet.workload import burst_of as jax_burst_of
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.fleet import runtime as prt
from repro_torch.fleet.dispatcher import Dispatcher
from repro_torch.fleet.runtime import FleetRuntime, TierSpec
from repro_torch.fleet.workload import Request, burst_of
from repro_torch.models import Model
from repro_torch.serving import (
    DiffusionConfig,
    DiffusionEngine,
    EngineConfig,
    ServingEngine,
    StateFrontier,
)

ARCHES = ("qwen3-0.6b", "rwkv6-7b")
PLEN = 12
MAX_NEW = (12, 16)
MAX_LEN = 32


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX model, JAX params, port model) at ``reduce()``, seed 0."""
    out = {}
    for arch in ARCHES:
        jmodel = JaxModel(jax_get_config(arch).reduce())
        jparams = jmodel.init(jax.random.key(0))
        cfg = get_config(arch).reduce()
        model = Model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
        out[arch] = (jmodel, jparams, model)
    return out


def _adopt(models, j, p):
    """Both runtimes serve the same weights: JAX's own draws, converted."""
    for spec in p.tiers:
        if spec.arch in models:
            key = (spec.arch, spec.param_seed, tuple(sorted((spec.model_overrides or {}).items())))
            jmodel, jparams, model = models[spec.arch]
            j._model_cache[key] = (jmodel, jparams)
            p._model_cache[key] = model
    return j, p


# ---------------------------------------------------------------------------
# the day fleet in lockstep with JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def day(models):
    j, p = _adopt(models, jrt.build_multimodel_day_fleet(period_s=60),
                  prt.build_multimodel_day_fleet(period_s=60, device="cpu"))
    requests = list(p.workload)
    return j, p, j.run(), p.run(), requests


def test_day_fleet_lockstep_with_jax(day):
    j, p, jr, pr, requests = day
    job_rids = {r.rid for r in requests if r.model == "sd21"}
    assert len(job_rids) == 12 and len(requests) == 183
    assert_lockstep(j, p, jr, pr, job_rids=job_rids)
    assert not pr.requests.dropped and len(pr.requests.records) == len(requests)
    tier_of = {r.rid: r.tier for r in pr.requests.records}
    assert {tier_of[rid] for rid in job_rids} == {"jobs"}
    assert {tier_of[r.rid] for r in requests if r.model == "qwen3-0.6b"} == {"llm"}
    assert {tier_of[r.rid] for r in requests if r.model == "rwkv6-7b"} == {"scan"}
    # each job's digest is the port's own: a standalone engine's of its prompt
    eng = DiffusionEngine(DiffusionConfig(batch=4, max_len=64, seed=0), device="cpu")
    for r in requests:
        if r.rid in job_rids:
            sess = eng.new_session()
            sess.submit(r.rid, r.prompt, r.max_new)
            while not sess.idle:
                sess.pump()
            assert pr.outputs[r.rid].tobytes() == sess.results[r.rid].tobytes()


def test_day_fleet_trades_capacity_as_jax(day):
    j, p, jr, pr, _ = day
    trades = [(e["t"], e["action"], e["tier"], e["donor"])
              for e in p.tracer.to_list() if e["name"] == "ctl.capacity_trade"]
    assert trades == [(63.0, "borrow", "jobs", "llm"), (72.0, "borrow", "jobs", "llm"),
                      (72.0, "borrow", "jobs", "scan"), (75.0, "return", "jobs", "llm"),
                      (75.0, "return", "jobs", "scan")]
    assert trades == [(e["t"], e["action"], e["tier"], e["donor"])
                      for e in j.tracer.to_list() if e["name"] == "ctl.capacity_trade"]
    assert not p._leases
    assert {n: pool.base_capacity for n, pool in p.pools.items()} == \
        {"llm": 6, "scan": 3, "jobs": 1}
    # the job engine is the fleet's: no mixed trace, nothing captured on the CPU
    eng = p._engines["jobs"]
    assert eng.is_job_engine and eng.mixed_traces == 0 and eng.captures == (0, 0.0)
    assert not p.tracer.select(name="engine.compile")


def test_job_tier_builds_alone():
    rt = FleetRuntime([TierSpec(name="j", arch="sd21")], [], device="cpu")
    eng = rt._engine_for(rt.tiers[0])
    assert isinstance(eng, DiffusionEngine) and eng.device == torch.device("cpu")
    assert (eng.cfg.batch, eng.cfg.max_len, eng.cfg.seed) == (2, 64, 0)
    rt.warmup()


# ---------------------------------------------------------------------------
# model-aware routing (dispatcher-level, no engines)
# ---------------------------------------------------------------------------


class _StubReplica:
    """The exact surface Dispatcher touches, without an engine."""

    def __init__(self, name, tier):
        self.name, self.tier = name, tier
        self.accepting = True
        self.live = True
        self.session = None
        self.taken = []

    @property
    def load(self):
        return len(self.taken)

    def fits(self, req):
        return True

    def prefix_match_len(self, toks):
        return 0

    def submit(self, req):
        self.taken.append(req)
        return True


def _req(rid, model="", plen=4):
    prompt = (np.arange(plen, dtype=np.int64) + rid).reshape(1, plen)
    return Request(rid=rid, arrival_t=0.0, prompt=prompt, max_new=4, model=model)


ARCH_OF = {"llm": "qwen3-0.6b", "scan": "rwkv6-7b"}


def _two_tiers():
    llm, scan = _StubReplica("llm/r1", "llm"), _StubReplica("scan/r1", "scan")
    return llm, scan, {"llm": [llm], "scan": [scan]}


def test_dispatcher_never_misroutes():
    disp = Dispatcher(["llm", "scan"], arch_of=ARCH_OF)
    llm, scan, reps = _two_tiers()
    models_ = ["qwen3-0.6b", "rwkv6-7b", "", "rwkv6-7b", "qwen3-0.6b"]
    disp.submit(_req(i, model=m) for i, m in enumerate(models_))
    placed = disp.dispatch(np.array([1.0, 0.0]), reps)
    assert placed == len(models_)
    assert {r.rid for r in scan.taken} == {1, 3}
    assert all(r.model != "rwkv6-7b" for r in llm.taken)


def test_dispatcher_full_model_tier_backlogs_instead_of_spilling():
    disp = Dispatcher(["llm", "scan"], arch_of=ARCH_OF)
    llm, scan, reps = _two_tiers()
    scan.accepting = False
    disp.submit([_req(0, model="rwkv6-7b")])
    assert disp.dispatch(np.array([0.0, 1.0]), reps) == 0
    assert len(disp.backlog) == 1 and not llm.taken and not disp.dropped
    scan.accepting = True
    assert disp.dispatch(np.array([0.0, 1.0]), reps) == 1
    assert [r.rid for r in scan.taken] == [0]


def test_dispatcher_hedge_respects_model_boundary():
    disp = Dispatcher(["llm", "scan"], arch_of=ARCH_OF, hedge_fraction=1.0)
    llm, scan, reps = _two_tiers()
    disp.submit([_req(0, model="qwen3-0.6b"), _req(1, model="qwen3-0.6b")])
    assert disp.dispatch(np.array([1.0, 1.0]), reps) == 2
    assert not scan.taken
    assert all(hedge is None for _, _, hedge in disp.inflight.values())


# ---------------------------------------------------------------------------
# cross-model capacity trading (pool accounting, no engines run)
# ---------------------------------------------------------------------------


def _heat(rt, hot, cold, rounds=8):
    for _ in range(rounds):
        rt.telemetry.record_model_demand(hot, 5.0)
        for m in cold:
            rt.telemetry.record_model_demand(m, 0.0)


def _both_fleets():
    return jrt.build_multimodel_day_fleet(), prt.build_multimodel_day_fleet(device="cpu")


def test_capacity_trade_leases_conserve_and_return():
    runs = _both_fleets()
    for rt in runs:
        base0 = {n: p.base_capacity for n, p in rt.pools.items()}
        total0 = sum(base0.values())
        _heat(rt, "sd21", ("qwen3-0.6b", "rwkv6-7b"))
        rt._trade_capacity(0.0, {"llm": 0, "scan": 0, "jobs": base0["jobs"] + 3})
        assert rt.pools["jobs"].base_capacity == base0["jobs"] + 3
        assert sum(p.base_capacity for p in rt.pools.values()) == total0
        assert sum(rt._leases.values()) == 3
        trades = [e for e in rt.tracer.to_list() if e["name"] == "ctl.capacity_trade"]
        assert trades and all(e["action"] == "borrow" for e in trades)
        assert all(e["model"] != e["donor_model"] for e in trades)
        rt._trade_capacity(1.0, {"llm": 0, "scan": 0, "jobs": 0})
        assert {n: p.base_capacity for n, p in rt.pools.items()} == base0
        assert not rt._leases
        assert rt.telemetry.tier_borrowed["jobs"] == 0
        assert sum(rt.telemetry.tier_lent.values()) == 0
    assert _events(runs[1]) == _events(runs[0])


def test_capacity_trade_requires_colder_donor():
    runs = _both_fleets()
    for rt in runs:
        base0 = {n: p.base_capacity for n, p in rt.pools.items()}
        for _ in range(8):
            for m in ("sd21", "qwen3-0.6b", "rwkv6-7b"):
                rt.telemetry.record_model_demand(m, 2.0)
        rt._trade_capacity(0.0, {"llm": 0, "scan": 0, "jobs": 9})
        assert {n: p.base_capacity for n, p in rt.pools.items()} == base0
        assert not rt._leases
    assert _events(runs[1]) == _events(runs[0])


# ---------------------------------------------------------------------------
# the rwkv6 scan tier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan(models):
    """The JAX and port rwkv6 engines of ``tests/test_multimodel.py``'s
    geometry, on the same weights."""
    jmodel, jparams, model = models["rwkv6-7b"]
    kw = dict(max_len=MAX_LEN, decode_batch=2, temperature=0.0, decode_chunk=4, mixed_step=False)
    return (model.cfg, JaxServingEngine(jmodel, jparams, JaxEngineConfig(**kw)),
            ServingEngine(model, EngineConfig(**kw), device="cpu"))


def test_scan_session_token_exact(scan):
    """rwkv6 through the port's session (submissions straddling pump
    boundaries) decodes the JAX engine's batch ``serve_queue`` tokens."""
    cfg, jeng, eng = scan
    sess = eng.new_session()
    assert sess.scan_state and not sess.paged and sess.supports_frontiers
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, cfg.vocab_size, (1, 8)), n) for n in (5, 7, 4)]
    sess.submit(0, *reqs[0])
    sess.pump()
    sess.submit(1, *reqs[1])
    sess.submit(2, *reqs[2])
    while not sess.idle:
        sess.pump()
    ref = jeng.serve_queue(reqs)
    for rid in range(3):
        np.testing.assert_array_equal(sess.results[rid], ref[rid])


def test_scan_frontier_extract_and_resume(scan):
    cfg, jeng, eng = scan
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab_size, (1, 10))
    max_new = 9
    sess = eng.new_session()
    sess.submit(0, prompt, max_new)
    sess.pump()
    fr = sess.extract_frontier(0)
    assert isinstance(fr, StateFrontier) and fr.page_size == 1
    assert tuple(fr.prompt) == tuple(int(x) for x in prompt[0])
    assert 1 <= len(fr.generated) < max_new
    assert fr.tokens == prompt.shape[1] + len(fr.generated)
    assert all(leaf.size for leaf in fr.state)
    resumed = eng.new_session()
    resumed.submit(0, prompt, max_new, frontier=fr)
    while not resumed.idle:
        resumed.pump()
    np.testing.assert_array_equal(resumed.results[0], jeng.serve_queue([(prompt, max_new)])[0])


def _scan_fleet(module, burst, engine, *, kill_ts=(2.0,), seed=3):
    vocab = get_config("rwkv6-7b").reduce().vocab_size
    workload = burst(6, vocab_size=vocab, prompt_len=PLEN, max_new=MAX_NEW, seed=seed)
    tier = module.TierSpec(name="scan", arch="rwkv6-7b", cost_per_hour=1.0, nominal_t_max=2.0,
                           max_len=MAX_LEN, decode_batch=2, decode_chunk=4, queue_limit=4,
                           base_capacity=3, initial_replicas=3, provision_delay_s=1.0,
                           paged_kv=False, mixed_step=False, cold_start_s=1.0,
                           cold_start_sigma=0.0, preemption_rate=0.0)
    cfg = module.FleetConfig(seed=seed, kv_store=True, kv_checkpoint_interval=1, max_retries=8)
    failures = [module.FailureEvent(t=kt, tier="scan") for kt in kill_ts]
    kw = {} if module is jrt else dict(device="cpu")
    rt = module.FleetRuntime([tier], workload, cfg, failures=failures, **kw)
    rt._engines["scan"] = engine
    return rt


def test_scan_kill_drill_zero_recompute(scan):
    """Kill a scan replica mid-decode: victims requeue, resume from their
    checkpointed ``StateFrontier`` with zero recomputed prefill, and the
    streams equal the uninterrupted engine's; in lockstep with JAX."""
    cfg, jeng, eng = scan
    j, p = _scan_fleet(jrt, jax_burst_of, jeng), _scan_fleet(prt, burst_of, eng)
    requests = list(p.workload)
    jr, report = j.run(), p.run()
    assert_lockstep(j, p, jr, report)
    assert len(report.requests.records) == len(requests)
    assert not report.requests.dropped
    assert report.requests.total_retries() >= 1
    s = report.summary()
    assert s["recovered_tokens"] > 0 and s["recomputed_prefill_tokens"] == 0
    assert report.kv_store["puts"] > 0 and report.kv_store["hits"] > 0
    ref = jeng.serve_queue([(r.prompt, r.max_new) for r in requests])
    for i, r in enumerate(requests):
        np.testing.assert_array_equal(report.outputs[r.rid], ref[i])

