"""Speculative decoding in the port against the JAX package (CPU).

``tests/test_spec_decode.py``'s ``tiny`` model: qwen3-0.6b.reduce() at a
16-token vocabulary (fp32), whose greedy streams on random weights loop
quickly, so the prompt-lookup drafter lands hits and drafts are accepted.
The port's weights come from the JAX params (``convert.py``).

* the drafter and ``spec_quantum`` equal JAX's (hypothesis-drawn
  histories, depths and n-gram lengths, misses and degenerate inputs);
* the greedy verdict equals JAX ``verify_tokens`` element for element
  (planted accepted drafts, exact ties);
* at temperature > 0 the emitted token's marginal (the draft if accepted,
  else the residual draw) and the bonus draw match softmax(JAX logits / T)
  by a chi-square test, p > 1e-3, at a fixed seed, as
  ``tests/test_torch_sampling.py`` holds the other draws; a verifier at
  1.1 T fails it;
* a speculating ``QueueSession`` (``spec_k = 4``) in lockstep with the JAX
  one, contiguous and paged with a full-prompt hit: streams, every report's
  counters (drafted, accepted, spec rounds, useful, wasted) pump by pump,
  the acceptance EWMA and ``mixed_traces``;
* the port against itself as ``tests/test_spec_decode.py`` holds JAX:
  spec on == spec off, kill and requeue through ``inflight_rids``, cancel
  between rounds releasing pages, only accepted tokens delivered, the
  per-request opt-out, and the property sweep at k 1, 3, 4, 8;
* ``warm_spec_traces`` against JAX's count, and a warmed engine adding no
  bucket; legacy and rwkv6 sessions ignoring ``spec_k``, as JAX's do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from scipy.stats import chisquare

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import NgramDrafter as JaxNgramDrafter
from repro.serving import QueueSession as JaxQueueSession
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import spec_quantum as jax_spec_quantum
from repro.serving import verify_tokens as jax_verify_tokens
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.serving import (
    Drafter,
    EngineClient,
    EngineConfig,
    InferenceRequest,
    NgramDrafter,
    QueueSession,
    ServingEngine,
    spec_quantum,
    verify_tokens,
)

N_DRAWS = 32768
MIN_EXPECTED = 5
P_MIN = 1e-3
# the reduced model's logits spread ~0.24: a verifier at 1.1 T fails at
# these temperatures with N_DRAWS (p < 1e-26 at both)
TEMPERATURES = [0.1, 0.2]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's steps here are tiny: one intra-op thread runs them faster
    than a pool, and keeps this file from oversubscribing the cores that
    parallel test workers share.  Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b").reduce(), vocab_size=16)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduce(), vocab_size=16)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, cfg, model


def _ecfg(cls, **kw):
    base = dict(max_len=64, decode_batch=3, temperature=0.0, decode_chunk=4, mixed_step=True,
                prefill_chunk=8, spec_k=4)
    base.update(kw)
    return cls(**base)


def _engine(model, **kw):
    return ServingEngine(model, _ecfg(EngineConfig, **kw), device="cpu")


def _drain(sess):
    while not sess.idle:
        sess.pump()
    return sess.results


def _run(eng, reqs, *, spec_k, rid_base=0):
    """One fresh session over ``eng`` at the given draft depth."""
    sess = QueueSession(eng)
    sess.spec_k = spec_k
    for i, (inp, n) in enumerate(reqs):
        sess.submit(rid_base + i, inp, n)
    _drain(sess)
    return {i: sess.results[rid_base + i] for i in range(len(reqs))}


# ---------------------------------------------------------------------------
# the drafter and the column quantum
# ---------------------------------------------------------------------------


@settings(max_examples=300, deadline=None)
@given(ctx=st.lists(st.integers(0, 3), max_size=24), n=st.integers(1, 5),
       min_n=st.integers(-1, 6), k=st.integers(-1, 9))
@example(ctx=[1, 2, 3, 1, 2, 3], n=3, min_n=1, k=5)        # period 3, extended
@example(ctx=[7, 9, 9, 9], n=3, min_n=1, k=4)              # period 1
@example(ctx=[1, 2, 3, 4, 5], n=3, min_n=2, k=4)           # a miss
@example(ctx=[5, 8, 5, 5], n=1, min_n=1, k=3)              # the most recent match
@example(ctx=[1], n=3, min_n=2, k=4)                       # too short for min_n
@example(ctx=[], n=3, min_n=1, k=4)
def test_drafter_equals_jax(ctx, n, min_n, k):
    ours = NgramDrafter(n, min_n)
    assert isinstance(ours, Drafter)
    assert (ours.n, ours.min_n) == (JaxNgramDrafter(n, min_n).n, JaxNgramDrafter(n, min_n).min_n)
    assert ours.propose(ctx, k) == JaxNgramDrafter(n, min_n).propose(ctx, k)


def test_drafter_refuses_n_below_one():
    for cls in (NgramDrafter, JaxNgramDrafter):
        with pytest.raises(ValueError, match="n must be >= 1"):
            cls(n=0)


def test_spec_quantum_equals_jax():
    for k in range(-2, 34):
        assert spec_quantum(k) == jax_spec_quantum(k), k


# ---------------------------------------------------------------------------
# verify_tokens against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_verdict_equals_jax(seed):
    """Random (B, Q, V) logits with exact ties (two or three indices sharing
    a column's maximum); drafts planted to match the first maximum, a later
    tied one, or a random token."""
    rng = np.random.default_rng(seed)
    B, Q, V = 5, 8, 16
    logits = rng.standard_normal((B, Q, V)).astype(np.float32)
    for b in range(B):
        for j in range(Q):
            if rng.random() < 0.5:
                tied = rng.choice(V, size=int(rng.integers(2, 4)), replace=False)
                logits[b, j, tied] = logits[b, j].max() + 1.0
    first = logits.argmax(-1)
    last = V - 1 - logits[..., ::-1].argmax(-1)
    pick = rng.integers(0, 3, (B, Q))
    drafts = np.where(pick == 0, first, np.where(pick == 1, last, rng.integers(0, V, (B, Q))))
    drafts = drafts.astype(np.int32)
    want, _ = jax_verify_tokens(jnp.asarray(logits), drafts, jax.random.key(0), 0.0)
    got = verify_tokens(torch.from_numpy(logits), torch.from_numpy(drafts), 0.0)
    assert got.dtype == torch.int32 and got.shape == (3, B, Q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (first != last).any() and got.numpy()[0].any() and not got.numpy()[0].all()


@pytest.fixture(scope="module")
def reduced_logits():
    """The JAX reduced qwen3's (vocab 512) last-position prefill logits of a
    9-token prompt, as ``tests/test_torch_sampling.py`` takes them."""
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    jmodel = JaxModel(jcfg)
    jeng = JaxServingEngine(jmodel, jmodel.init(jax.random.key(0)), JaxEngineConfig(max_len=32))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 9))
    return np.array(jeng.prefill({"inputs": jnp.asarray(prompt)})[0])[0]


def _p_value(draws: np.ndarray, logits: np.ndarray, temperature: float) -> float:
    """Chi-square p of ``draws`` against softmax(logits / T), bins of
    expected count < MIN_EXPECTED pooled."""
    z = logits.astype(np.float64) / temperature
    p = np.exp(z - z.max())
    want = len(draws) * p / p.sum()
    got = np.bincount(draws, minlength=len(p)).astype(np.float64)
    big = want >= MIN_EXPECTED
    f_obs, f_exp = got[big], want[big]
    if not big.all():
        f_obs, f_exp = np.append(f_obs, got[~big].sum()), np.append(f_exp, want[~big].sum())
    assert big.sum() >= 50, "too few bins for the test to mean anything"
    return chisquare(f_obs, f_exp * f_obs.sum() / f_exp.sum()).pvalue


def _emitted_and_bonus(logits: np.ndarray, draft: int, temperature: float):
    """N_DRAWS rows of one column holding ``logits`` and judging ``draft``:
    the emitted token (the draft if accepted, else the replacement) and
    the bonus draw (a plain draw from the same column) of every row."""
    lg = torch.from_numpy(logits)[None, None].expand(N_DRAWS, 1, -1).contiguous()
    drafts = torch.full((N_DRAWS, 1), draft, dtype=torch.int32)
    v = verify_tokens(lg, drafts, temperature, torch.Generator().manual_seed(5)).numpy()[:, :, 0]
    assert (v[1] != draft).all(), "the residual drew the rejected draft"
    return np.where(v[0] == 1, draft, v[1]), v[2]


@pytest.mark.parametrize("rank", ["top", "median"])
@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_temperature_verdict_matches_softmax(reduced_logits, temperature, rank):
    logits = reduced_logits
    draft = int(np.argsort(logits)[-1 if rank == "top" else len(logits) // 2])
    emitted, bonus = _emitted_and_bonus(logits, draft, temperature)
    assert _p_value(emitted, logits, temperature) > P_MIN
    assert _p_value(bonus, logits, temperature) > P_MIN
    # the same test sees a verifier at the wrong temperature
    emitted, bonus = _emitted_and_bonus(logits, draft, 1.1 * temperature)
    assert _p_value(emitted, logits, temperature) < P_MIN
    assert _p_value(bonus, logits, temperature) < P_MIN


# ---------------------------------------------------------------------------
# the session in lockstep with the JAX QueueSession
# ---------------------------------------------------------------------------

REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "prefill_chunks",
                 "mixed_steps", "useful_tokens", "wasted_tokens", "drafted_tokens",
                 "accepted_tokens", "spec_rounds", "prefix_hits", "prefix_misses",
                 "reused_tokens", "prefilled_tokens")


def _lockstep_requests(vocab):
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, vocab, (1, 6 + 2 * i)), 20) for i in range(3)]
    reqs.append((reqs[0][0], 12))           # paged: a full-prompt hit
    reqs.append((rng.integers(0, vocab, (1, 17)), 9))
    return reqs


@pytest.mark.parametrize("paged", [False, True])
def test_session_lockstep_with_jax(tiny, paged):
    jmodel, jparams, cfg, model = tiny
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, paged_kv=paged))
    eng = _engine(model, paged_kv=paged)
    js, ts = JaxQueueSession(jeng), QueueSession(eng)
    assert ts.spec_k == js.spec_k == 4
    for rid, (inp, n) in enumerate(_lockstep_requests(cfg.vocab_size)):
        js.submit(rid, inp, n)
        ts.submit(rid, inp, n)
    pumps = 0
    while not (js.idle and ts.idle):
        jr, tr = js.pump(), ts.pump()
        pumps += 1
        for f in REPORT_FIELDS:
            assert getattr(tr, f) == getattr(jr, f), (pumps, f)
        assert sorted(tr.completed) == sorted(jr.completed)
        if js.spec_accept_ewma is None:
            assert ts.spec_accept_ewma is None
        else:
            assert ts.spec_accept_ewma == pytest.approx(js.spec_accept_ewma, abs=1e-12)
    assert sorted(ts.results) == sorted(js.results)
    for rid in js.results:
        np.testing.assert_array_equal(ts.results[rid], js.results[rid])
    for f in ("drafted_tokens", "accepted_tokens", "spec_rounds", "useful_tokens",
              "wasted_tokens", "mixed_steps", "chunks"):
        assert getattr(eng.telemetry, f) == getattr(jeng.telemetry, f), f
    assert eng.telemetry.accepted_tokens > 0 and eng.telemetry.spec_rounds > 0
    assert eng.telemetry.spec_accept_rate == jeng.telemetry.spec_accept_rate
    assert eng.mixed_traces == jeng.mixed_traces
    if paged:
        assert ts.allocator.stats.full_hits >= 1 and ts.allocator.live_pages == 0


# ---------------------------------------------------------------------------
# the port against itself, as tests/test_spec_decode.py holds JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_spec_token_exact_with_prefix_hit(tiny, paged):
    """Spec on and off over one engine: the same streams, including a
    full-prompt hit on the paged path."""
    *_, cfg, model = tiny
    rng = np.random.default_rng(0)
    eng = _engine(model, paged_kv=paged)
    reqs = [(rng.integers(0, cfg.vocab_size, (1, 6 + 2 * i)), 20) for i in range(3)]
    reqs.append((reqs[0][0], 12))
    ref = _run(eng, reqs, spec_k=0)
    out = _run(eng, reqs, spec_k=4, rid_base=100)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(out[i], ref[i])
    assert eng.telemetry.drafted_tokens > 0 and eng.telemetry.accepted_tokens > 0


@pytest.mark.parametrize("paged", [False, True])
def test_spec_kill_and_requeue_token_exact(tiny, paged):
    """Drop a speculating session after one pump and requeue its
    ``inflight_rids`` on a fresh session: the streams equal an undisturbed
    spec-off run."""
    *_, cfg, model = tiny
    rng = np.random.default_rng(1)
    eng = _engine(model, paged_kv=paged)
    reqs = {rid: (rng.integers(0, cfg.vocab_size, (1, 8 + rid)), 16 + rid) for rid in range(4)}
    ref = _run(eng, [reqs[r] for r in sorted(reqs)], spec_k=0)
    sess = QueueSession(eng)
    for rid, (inp, n) in reqs.items():
        sess.submit(rid, inp, n)
    sess.pump()
    done = dict(sess.results)
    lost = sess.inflight_rids()
    assert lost and eng.telemetry.spec_rounds > 0
    # slot occupants first (decoding, then mid-prefill), then the queue
    assert lost[:len(lost) - len(sess.queue)] == (
        [int(r) for r in sess.slots.request_id if r >= 0]
        + [p["rid"] for _, p in sorted(sess._prefilling.items())])
    sess2 = QueueSession(eng)
    for rid in lost:
        sess2.submit(rid, *reqs[rid])
    _drain(sess2)
    for i, rid in enumerate(sorted(reqs)):
        np.testing.assert_array_equal(done.get(rid, sess2.results.get(rid)), ref[i])


def test_spec_cancel_between_rounds_releases_pages(tiny):
    *_, cfg, model = tiny
    rng = np.random.default_rng(2)
    eng = _engine(model, paged_kv=True, decode_batch=2)
    reqs = [(rng.integers(0, cfg.vocab_size, (1, 8)), 24),
            (rng.integers(0, cfg.vocab_size, (1, 10)), 24)]
    ref = _run(eng, reqs, spec_k=0)
    sess = QueueSession(eng)
    for rid, (inp, n) in enumerate(reqs):
        sess.submit(rid, inp, n)
    sess.pump()
    live_before = sess.allocator.live_pages
    assert live_before > 0 and eng.telemetry.spec_rounds > 0
    assert sess.cancel(0)
    assert sess.allocator.live_pages < live_before
    assert 0 not in sess._prompt_of
    _drain(sess)
    assert 0 not in sess.results
    np.testing.assert_array_equal(sess.results[1], ref[1])
    assert sess.allocator.live_pages == 0


def test_spec_counters_only_accepted_are_delivered(tiny):
    *_, cfg, model = tiny
    rng = np.random.default_rng(3)
    eng = _engine(model, paged_kv=True, decode_batch=2)
    sess = QueueSession(eng)
    sess.submit(0, rng.integers(0, cfg.vocab_size, (1, 8)), 24)
    reports = []
    while not sess.idle:
        reports.append(sess.pump())
    tel = eng.telemetry
    assert tel.spec_rounds >= 1
    assert 0 < tel.accepted_tokens <= tel.drafted_tokens
    assert tel.spec_accept_rate == pytest.approx(tel.accepted_tokens / tel.drafted_tokens)
    assert sess.results[0].size == 24 and tel.useful_tokens == 24
    for f in ("drafted_tokens", "accepted_tokens", "spec_rounds", "spec_s", "draft_s"):
        assert sum(getattr(r, f) for r in reports) == pytest.approx(getattr(tel, f)), f
    assert 0.0 < tel.draft_s < tel.spec_s < tel.decode_s
    assert sess.spec_accept_ewma is not None and 0.0 <= sess.spec_accept_ewma <= 1.0
    assert not sess._prompt_of and not sess._no_spec


def test_spec_per_request_opt_out(tiny):
    """``speculate=False`` (on the session, and through ``InferenceRequest``)
    keeps a request to plain decode: no draft, the spec-off streams."""
    *_, cfg, model = tiny
    rng = np.random.default_rng(4)
    eng = _engine(model, decode_batch=2)
    reqs = [(rng.integers(0, cfg.vocab_size, (1, 7)), 16),
            (rng.integers(0, cfg.vocab_size, (1, 9)), 16)]
    ref = _run(eng, reqs, spec_k=0)
    sess = QueueSession(eng)
    assert sess.spec_k == 4
    for rid, (inp, n) in enumerate(reqs):
        sess.submit(rid, inp, n, speculate=False)
    _drain(sess)
    for rid in range(len(reqs)):
        np.testing.assert_array_equal(sess.results[rid], ref[rid])
    assert eng.telemetry.drafted_tokens == 0
    cli = EngineClient(eng, device="cpu")
    hs = [cli.submit(InferenceRequest(prompt=p[0], max_new=n, speculate=False)) for p, n in reqs]
    assert cli.session._no_spec == {0, 1}
    for h, rid in zip(hs, range(len(reqs))):
        np.testing.assert_array_equal(h.result(), ref[rid])
    assert eng.telemetry.drafted_tokens == 0 and not cli.session._no_spec


@settings(max_examples=10, deadline=None)
@given(plens=st.lists(st.integers(2, 21), min_size=1, max_size=2),
       news=st.lists(st.integers(1, 24), min_size=2, max_size=2),
       k=st.sampled_from([1, 3, 4, 8]), seed=st.integers(0, 3))
@example(plens=[6, 13], news=[17, 3], k=1, seed=0)       # quantum 2
@example(plens=[8, 8], news=[19, 19], k=3, seed=1)       # k + 1 is the quantum
@example(plens=[5, 21], news=[23, 2], k=4, seed=2)       # quantum 8, ragged budgets
@example(plens=[9], news=[31], k=8, seed=3)              # quantum 16, a lone slot
def test_spec_exactness_property(tiny, plens, news, k, seed):
    """Prompt lengths, budgets and draft depths drawn: the speculating
    session equals spec off token for token and the pool drains clean."""
    *_, cfg, model = tiny
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, cfg.vocab_size, (1, p)), n) for p, n in zip(plens, news)]
    eng = _engine(model, paged_kv=True, decode_batch=2, spec_k=k)
    ref = _run(eng, reqs, spec_k=0, rid_base=1000)
    sess = QueueSession(eng)
    for i, (inp, n) in enumerate(reqs):
        sess.submit(i, inp, n)
    _drain(sess)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(sess.results[i], ref[i])
    assert sess.allocator.live_pages == 0
    assert {b[1] for b in eng._buckets if b[0] == "spec"} == {spec_quantum(k)}


# ---------------------------------------------------------------------------
# the warm grid, and the sessions that ignore spec_k
# ---------------------------------------------------------------------------


def test_warm_spec_grid_counts_as_jax(tiny):
    """``warm_spec_traces([4])`` prepares as many buckets as JAX compiles
    traces (Qs 8, windows 8-64), and 10 at the default config (Qs 8,
    windows 8-4096).  A workload on an engine warmed for its mixed and
    verify steps prepares no new bucket."""
    jmodel, jparams, cfg, model = tiny
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig))
    eng = _engine(model)
    assert eng.warm_spec_traces([4]) == jeng.warm_spec_traces([4]) == 4
    assert eng.warm_spec_traces([4, 5]) == 0                   # one quantum, already there
    assert eng.warm_mixed_traces([8]) == len(eng._windows(eng.chunk_quantum(8)))
    warmed = eng.mixed_traces
    reqs = _lockstep_requests(cfg.vocab_size)
    out = _run(eng, reqs, spec_k=4)
    assert eng.mixed_traces == warmed and eng.telemetry.spec_rounds > 0
    ref = _run(_engine(model), reqs, spec_k=0)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(out[i], ref[i])
    full = ServingEngine(model, EngineConfig(spec_k=4), device="cpu")
    assert full.warm_spec_traces([full.cfg.spec_k]) == 10 == len(full._windows(8))


def test_verify_step_needs_its_chunk_buffer(tiny):
    *_, model = tiny
    eng = _engine(model)
    st_ = eng._session_state()
    st_.chunk(8).fill(np.zeros((3, 8)))
    st_.stage(np.zeros(3), np.ones(3), np.zeros(3), np.zeros(3))
    with pytest.raises(ValueError, match="no chunk buffer of width 4"):
        eng._spec_call(st_, 4, 8)
    assert eng._spec_call(st_, 8, 8).shape == (3, 3, 8)


def test_legacy_session_ignores_spec_k(tiny):
    """``mixed_step=False`` sessions never speculate (as JAX's legacy pump):
    spec_k 4 gives the spec-off streams and drafts nothing, both layouts."""
    *_, cfg, model = tiny
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, cfg.vocab_size, (1, p)), n) for p, n in ((7, 12), (11, 9), (7, 5))]
    for paged in (False, True):
        eng = _engine(model, mixed_step=False, paged_kv=paged)
        assert not eng.mixed and eng.warm_spec_traces([4]) == 0
        ref = _run(eng, reqs, spec_k=0)
        out = _run(eng, reqs, spec_k=4, rid_base=50)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(out[i], ref[i])
        assert eng.telemetry.drafted_tokens == 0 and eng.mixed_traces == 0


def test_rwkv_session_ignores_spec_k():
    """rwkv6 has no mixed step, so its session takes legacy admission and
    ``spec_k`` changes nothing."""
    cfg = get_config("rwkv6-7b").reduce()
    model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, (1, p)), 6) for p in (5, 9, 4)]
    eng = ServingEngine(model, EngineConfig(max_len=32, decode_batch=2, decode_chunk=3,
                                            spec_k=4), device="cpu")
    assert not eng.mixed and eng.warm_spec_traces([4]) == 0
    ref = _run(eng, reqs, spec_k=0)
    out = _run(eng, reqs, spec_k=4, rid_base=50)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(out[i], ref[i])
    assert eng.telemetry.drafted_tokens == 0
