"""The port's job tier (``repro_torch.serving.diffusion``) against the JAX
package's, on the CPU.

The JAX ``DiffusionEngine`` draws its weights and each job's noise from
``jax.random``, which the port cannot reproduce, so each lockstep case
gives both engines the same inputs: the port loads JAX's ``w_mix`` and
``w_cond`` (``convert.diffusion_params_from_jax``), and the test's JAX
engine instance has its ``seed_job`` replaced by the port's host draws.
Then, pump by pump: admitted and completed sets, the remaining-steps
mirror, the report's fields (wall times aside) and every slot's latent and
conditioning within atol 2e-5.  ``digest`` reads the 7th significant digit
of a float32, so two frameworks' latents 1e-6 apart give different digest
tokens: ``digest`` is held to JAX's exactly on the same array, and within
the port a job's digest must be identical across sessions, slots,
batchmates, admission orders and a cancel-then-resubmit (the fleet's
requeue relies on it).

Plus mirrors of ``tests/test_multimodel.py``'s diffusion and registry
tests, the errors of ``submit``, the ``sd21`` deployment units field by
field, and ``core.allocation``'s four solvers against JAX's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import JOB_ARCHES as JAX_JOB_ARCHES
from repro.configs import resolve_serving_arch as jax_resolve_serving_arch
from repro.configs import sd21 as jax_sd21
from repro.core import allocation as jax_allocation
from repro.serving.diffusion import DiffusionConfig as JaxDiffusionConfig
from repro.serving.diffusion import DiffusionEngine as JaxDiffusionEngine
from repro_torch.configs import (
    JOB_ARCHES,
    get_config,
    resolve_serving_arch,
    serving_family,
)
from repro_torch.configs import sd21
from repro_torch.convert import diffusion_params_from_jax
from repro_torch.core import allocation
from repro_torch.serving import (
    CacheBackend,
    DiffusionConfig,
    DiffusionEngine,
    DiffusionSession,
)
from repro_torch.serving.diffusion import denoise

ATOL = 2e-5
# the engine's defaults (the fleet's jobs tier geometry aside), and a small
# one whose step budget is not a whole number of pumps
CONFIGS = {
    "default": dict(),
    "odd": dict(batch=3, denoise_steps=7, steps_per_pump=3, latent_dim=8, max_len=64, seed=1),
}
REPORT_FIELDS = ("admitted", "emitted", "useful_tokens", "wasted_tokens", "occupancy",
                 "chunk_steps", "prefill_chunks", "mixed_steps", "recovered_tokens",
                 "recomputed_prefill_tokens")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**kw):
    """A JAX and a port engine of one config on the same weights and noise."""
    jeng = JaxDiffusionEngine(JaxDiffusionConfig(**kw))
    peng = DiffusionEngine(DiffusionConfig(**kw), device="cpu")
    peng.load_params(diffusion_params_from_jax(np.asarray(jeng.w_mix), np.asarray(jeng.w_cond)))
    jeng.seed_job = lambda prompt: tuple(jnp.asarray(a) for a in peng.seed_job(prompt))
    return jeng, peng


def _prompts(n, seed, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 20, (1, int(rng.integers(lo, hi + 1)))) for _ in range(n)]


# ---------------------------------------------------------------------------
# the engine against JAX, pump by pump
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_lockstep_with_jax(name):
    kw = CONFIGS[name]
    jeng, peng = _pair(**kw)
    cfg = peng.cfg
    D = cfg.latent_dim
    js, ps = jeng.new_session(), peng.new_session()
    prompts = _prompts(2 * cfg.batch + 3, seed=5)
    sizes = [1 + (i * 7) % min(2 * D * D, cfg.max_len - 12) for i in range(len(prompts))]
    classes = ["job", "batch", "interactive"]
    arrivals = {0: range(0, cfg.batch + 2), 1: range(cfg.batch + 2, len(prompts) - 2)}
    late = range(len(prompts) - 2, len(prompts))
    pump, done = 0, {}
    while True:
        for i in list(arrivals.get(pump, ())) + (list(late) if pump == 3 else []):
            for s in (js, ps):
                s.submit(i, prompts[i], sizes[i], slo_class=classes[i % 3], priority=i % 2)
        if pump == 2:
            victim = int(next(r for r in ps._rid if r >= 0))
            assert js.cancel(victim) and ps.cancel(victim)
            done[victim] = None
        if js.idle and ps.idle and pump > 3:
            break
        jr, pr = js.pump(), ps.pump()
        for f in REPORT_FIELDS:
            assert getattr(pr, f) == getattr(jr, f), (pump, f)
        assert sorted(pr.completed) == sorted(jr.completed)
        assert sorted(pr.tokens) == sorted(jr.tokens)
        for rid, toks in pr.completed.items():
            assert toks.dtype == np.int64 and toks.shape == (sizes[rid],)
            assert toks.shape == np.asarray(jr.completed[rid]).shape
            done[rid] = toks
        np.testing.assert_array_equal(ps._rem, js._rem)
        np.testing.assert_array_equal(ps._rid, js._rid)
        np.testing.assert_allclose(ps.state.lat.numpy(), np.asarray(js.lat), rtol=0, atol=ATOL)
        np.testing.assert_allclose(ps.state.cond.numpy(), np.asarray(js.cond), rtol=0, atol=0)
        assert ps.load == js.load and ps.inflight_rids() == js.inflight_rids()
        pump += 1
    assert set(done) == set(range(len(prompts)))
    assert sorted(ps.results) == sorted(js.results)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_denoise_matches_jax_scan(name):
    """The step function alone, on random latents and a ragged ``rem``
    (some slots frozen from the start, some running out mid-call)."""
    jeng, peng = _pair(**CONFIGS[name])
    cfg = peng.cfg
    B, D = cfg.batch, cfg.latent_dim
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((B, D, D), dtype=np.float32)
    cond = rng.standard_normal((B, D), dtype=np.float32)
    rem = (np.arange(B) % (cfg.steps_per_pump + 2)).astype(np.int32)
    jl, jr = jeng._steps(jnp.asarray(lat), jnp.asarray(cond), jnp.asarray(rem),
                         cfg.steps_per_pump)
    pl, pr = denoise(torch.tensor(lat), torch.tensor(cond), torch.tensor(rem), peng.w_mix,
                     peng.w_cond, cfg.steps_per_pump)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    frozen = rem == 0
    np.testing.assert_array_equal(pl.numpy()[frozen], lat[frozen])


@pytest.mark.parametrize("max_new", [1, 5, 255, 256, 257, 1000])
def test_digest_equals_jax_on_the_same_array(max_new):
    jeng, peng = _pair()
    rng = np.random.default_rng(max_new)
    for scale in (1e-3, 1.0, 5.0):
        lat = (scale * rng.standard_normal((16, 16))).astype(np.float32)
        got, want = peng.digest(lat, max_new), jeng.digest(lat, max_new)
        assert got.dtype == want.dtype == np.int64 and got.shape == (max_new,)
        assert got.tobytes() == want.tobytes()


def test_seed_job_is_a_pure_host_function():
    eng = DiffusionEngine(DiffusionConfig(), device="cpu")
    other = DiffusionEngine(DiffusionConfig(seed=1), device="cpu")
    p = np.array([[3, 1, 4, 1, 5]])
    lat, cond = eng.seed_job(p)
    assert lat.dtype == cond.dtype == np.float32 and lat.shape == (16, 16) and cond.shape == (16,)
    lat2, cond2 = eng.seed_job(p.copy().astype(np.int32))
    assert lat.tobytes() == lat2.tobytes() and cond.tobytes() == cond2.tobytes()
    assert not np.array_equal(other.seed_job(p)[0], lat)
    assert not np.array_equal(eng.seed_job(p[:, :4])[0], lat)
    # tokens are read mod 2^31, as the JAX engine folds them in
    np.testing.assert_array_equal(eng.seed_job(np.array([[2**31 + 3]]))[0],
                                  eng.seed_job(np.array([[3]]))[0])


def test_weights_drawn_on_the_host_from_the_seed():
    a = DiffusionEngine(DiffusionConfig(seed=3), device="cpu")
    b = DiffusionEngine(DiffusionConfig(seed=3), device="cpu")
    c = DiffusionEngine(DiffusionConfig(seed=4), device="cpu")
    assert torch.equal(a.w_mix, b.w_mix) and torch.equal(a.w_cond, b.w_cond)
    assert not torch.equal(a.w_mix, c.w_mix)
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(a.w_mix, torch.randn((16, 16), generator=gen) / 4.0)
    with pytest.raises(ValueError, match="not"):
        diffusion_params_from_jax(np.zeros((4, 4)), np.zeros(3))


# ---------------------------------------------------------------------------
# the port's own invariants: a job's digest is its own
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def peng():
    return DiffusionEngine(DiffusionConfig(batch=4, denoise_steps=9, steps_per_pump=4,
                                           max_len=512), device="cpu")


def _results(eng, jobs, *, cancel_at=None):
    sess = eng.new_session()
    for rid, prompt, n in jobs:
        sess.submit(rid, prompt, n)
    pumps = 0
    while not sess.idle:
        if cancel_at is not None and pumps == cancel_at[0]:
            assert sess.cancel(cancel_at[1])
            sess.submit(cancel_at[1], *next((p, n) for r, p, n in jobs if r == cancel_at[1]))
        sess.pump()
        pumps += 1
    return sess.results


def test_digests_identical_across_sessions_orders_slots_and_batchmates(peng):
    D2 = peng.cfg.latent_dim ** 2
    prompts = _prompts(9, seed=8)
    jobs = [(i, p, D2 + i) for i, p in enumerate(prompts)]
    ref = _results(peng, jobs)
    runs = [
        _results(peng, jobs),                                   # another session
        _results(peng, jobs[::-1]),                             # reverse order: other slots
        _results(peng, jobs[1::2] + jobs[0::2]),                # other batchmates
        _results(peng, jobs, cancel_at=(1, 2)),                 # cancelled, then resubmitted
    ]
    runs += [_results(peng, [job]) for job in jobs[:3]]          # alone, slot 0
    for got in runs:
        for rid, toks in got.items():
            assert toks.tobytes() == ref[rid].tobytes(), rid
    assert len({ref[i][:D2].tobytes() for i in range(len(jobs))}) == len(jobs)


def test_slot_latent_independent_of_batchmates(peng):
    """One job's latent, bit for bit, in every slot with random or no
    batchmates (the step's product has no kernel choice to vary)."""
    cfg = peng.cfg
    B, D = cfg.batch, cfg.latent_dim
    lat0, cond0 = peng.seed_job(np.array([[7, 7, 7]]))
    rng = np.random.default_rng(4)
    outs = []
    for slot in range(B):
        lat = torch.tensor(rng.standard_normal((B, D, D), dtype=np.float32))
        cond = torch.tensor(rng.standard_normal((B, D), dtype=np.float32))
        rem = torch.tensor(rng.integers(0, 9, B), dtype=torch.int32)
        lat[slot], cond[slot], rem[slot] = torch.tensor(lat0), torch.tensor(cond0), 9
        out, _ = denoise(lat, cond, rem, peng.w_mix, peng.w_cond, 9)
        outs.append(out[slot].numpy().tobytes())
    assert len(set(outs)) == 1


# ---------------------------------------------------------------------------
# mirrors of tests/test_multimodel.py's diffusion tests, and the surface
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def djob():
    return DiffusionEngine(DiffusionConfig(
        batch=2, denoise_steps=4, steps_per_pump=2, latent_dim=8,
        max_len=32, seed=0), device="cpu")


def _run_jobs(eng, jobs):
    sess = eng.new_session()
    for rid, prompt, max_new, slo in jobs:
        sess.submit(rid, prompt, max_new, slo_class=slo)
    while not sess.idle:
        sess.pump()
    return sess.results


def test_diffusion_jobs_deterministic(djob):
    assert djob.is_job_engine
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 1000, (1, 6)) for _ in range(3)]
    jobs = [(i, p, 5, "job") for i, p in enumerate(prompts)]
    a, b = _run_jobs(djob, jobs), _run_jobs(djob, jobs)
    for rid, _, max_new, _ in jobs:
        assert a[rid].shape == (max_new,)
        np.testing.assert_array_equal(a[rid], b[rid])
    assert not np.array_equal(a[0], a[1])


def test_diffusion_session_admits_job_class_first(djob):
    sess = djob.new_session()
    assert not sess.supports_frontiers and not sess.paged
    prompt = np.zeros((1, 4), np.int64)
    sess.submit(0, prompt, 4, slo_class="batch")
    sess.submit(1, prompt, 4, slo_class="batch")
    sess.submit(2, prompt, 4, slo_class="job")
    rep = sess.pump()
    assert 2 in rep.admitted
    while not sess.idle:
        sess.pump()
    assert set(sess.results) == {0, 1, 2}


def test_submit_edges_match_jax():
    jeng, peng = _pair(**CONFIGS["odd"])
    js, ps = jeng.new_session(), peng.new_session()
    p = np.zeros((1, 10), np.int64)
    for s in (js, ps):
        s.submit(0, p, 0)                                  # completes at once
        with pytest.raises(ValueError, match="already in session"):
            s.submit(0, p, 3)
        with pytest.raises(ValueError, match="exceeds max_len=64"):
            s.submit(1, p, 55)
        s.submit(1, p, 54)
        with pytest.raises(ValueError, match="already in session"):
            s.submit(1, p, 2)
        assert not s.idle and s.load == 1 and s.inflight_rids() == [1]
    jr, pr = js.pump(), ps.pump()
    assert list(pr.completed) == list(jr.completed) == [0]
    assert pr.completed[0].dtype == np.int64 and pr.completed[0].size == 0
    assert pr.admitted == jr.admitted == [1]
    for s in (js, ps):
        assert not s.cancel(0) and s.cancel(1) and not s.cancel(1) and s.idle
        assert s.fits(10, 54) and not s.fits(10, 55)


def test_backend_surface_and_device():
    eng = DiffusionEngine(DiffusionConfig(batch=2), device="cpu")
    sess = eng.new_session()
    assert isinstance(sess, DiffusionSession) and isinstance(sess, CacheBackend)
    assert (sess.prefix_match_len(np.zeros((1, 3))), sess.extract_frontier(0),
            sess.extract_frontiers(), sess.decoding_lens()) == (0, None, [], {})
    assert not (sess.paged or sess.scan_state or sess.mixed or eng.paged or eng.mixed)
    assert sess.allocator is None and sess.spec_k == 0 and sess.token_budget == 1
    assert eng.mixed_traces == 0 and eng.captures == (0, 0.0) and not eng.graphs
    assert eng.warm() == 0 and eng.new_session().idle
    assert eng.w_mix.device == torch.device("cpu")
    with pytest.raises(ValueError, match="graphs=True"):
        DiffusionEngine(DiffusionConfig(), device="cpu", graphs=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DiffusionEngine(DiffusionConfig())


# ---------------------------------------------------------------------------
# registry, deployment units, allocation
# ---------------------------------------------------------------------------


def test_registry_resolves_every_serving_arch():
    assert resolve_serving_arch("qwen3-0.6b").vocab_size > 0
    assert resolve_serving_arch("rwkv6-7b").family == "rwkv"
    assert serving_family("sd21") == "job" and serving_family("rwkv6-7b") == "rwkv"
    assert serving_family("qwen3-0.6b") == get_config("qwen3-0.6b").family
    assert JOB_ARCHES == JAX_JOB_ARCHES == ("sd21",)
    got, want = resolve_serving_arch("sd21"), jax_resolve_serving_arch("sd21")
    assert [dataclasses.asdict(d) for d in got] == [dataclasses.asdict(d) for d in want]
    for d, w in zip(got, want):
        assert (d.cost_per_inference, d.dollars_per_request) == \
            (w.cost_per_inference, w.dollars_per_request)
    assert sd21.PAPER_COST_PER_INFERENCE == jax_sd21.PAPER_COST_PER_INFERENCE
    assert sd21.PAPER_T_ADJUSTED == jax_sd21.PAPER_T_ADJUSTED
    with pytest.raises(KeyError, match=r"unknown serving arch 'gpt-17t'.*sd21"):
        resolve_serving_arch("gpt-17t")
    with pytest.raises(KeyError):
        serving_family("gpt-17t")


def _alloc_equal(a, b):
    assert a.replicas.dtype == np.asarray(b.replicas).dtype
    np.testing.assert_array_equal(a.replicas, b.replicas)
    assert (a.supply, a.feasible) == (b.supply, b.feasible)
    assert a.cost_rate == b.cost_rate or (np.isnan(a.cost_rate) and np.isnan(b.cost_rate))


def _instances():
    dus = sd21.paper_deployment_units()
    cost = [d.cost_per_hour for d in dus]
    t = [d.t_max for d in dus]
    for pool, demand in (([2, 2, 2, 2, 2], 300.0), ([1, 0, 3, 1, 2], 250.0),
                         ([4, 4, 4, 4, 4], 0.0), ([1, 1, 1, 1, 1], 1e4)):
        yield cost, t, pool, demand
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(2, 5))
        yield (list(rng.uniform(0.5, 50.0, n)), list(rng.uniform(0.5, 50.0, n)),
               list(rng.integers(0, 6, n)), float(rng.uniform(0.0, 100.0)))


def test_allocation_solvers_equal_jax():
    for cost, t, pool, demand in _instances():
        for name in ("optimal_fractional", "optimal_integral"):
            _alloc_equal(getattr(allocation, name)(cost, t, pool, demand),
                         getattr(jax_allocation, name)(cost, t, pool, demand))
        _alloc_equal(allocation.brute_force_integral(cost, t, pool, demand, cap=5),
                     jax_allocation.brute_force_integral(cost, t, pool, demand, cap=5))
        w = np.asarray(t) / np.sum(t)
        _alloc_equal(allocation.heuristic_allocation(w, np.asarray(t), np.asarray(pool), demand),
                     jax_allocation.heuristic_allocation(w, np.asarray(t), np.asarray(pool),
                                                         demand))
