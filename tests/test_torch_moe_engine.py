"""arctic-480b's ``reduce()`` (4 experts top-2 and a dense residual, fp32,
CPU) served by the port's ``QueueSession`` pump by pump in lockstep with
the JAX one, at the default capacity factor 1.25, where experts overflow
and every token of a step (idle slots and padding columns included)
competes for capacity: mixed admission, contiguous and paged, with
``spec_k`` 0 and 4.  Reports and streams must be equal.

Durable KV on the paged engine: frontiers extracted mid-decode, the
sessions killed, and the requests resumed in fresh sessions with zero
prefill, the port's and the JAX session in lockstep pump by pump.  The
resumed streams are held to JAX's, not to the uninterrupted run: under MoE
a request's batchmates compete with it for expert capacity, so resuming
among other batchmates may change its stream in both packages alike.

One JAX and one port engine per layout, built with ``spec_k`` 4 and shared
by both depths (a session's ``spec_k`` is live), so each jit trace is
compiled once.  Weights come from the JAX ``Model.init`` through
``convert.params_from_jax``; prompts from a numpy seed.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "arctic-480b"
REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "prefill_chunks",
                 "mixed_steps", "useful_tokens", "wasted_tokens", "prefix_hits",
                 "prefix_misses", "reused_tokens", "prefilled_tokens", "cached_pages",
                 "drafted_tokens", "accepted_tokens", "recovered_tokens",
                 "recomputed_prefill_tokens")


def _ecfg(cls, **kw):
    base = dict(max_len=64, decode_batch=3, temperature=0.0, decode_chunk=4, prefill_chunk=8,
                page_size=8, spec_k=4)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def engines():
    """paged -> (JAX engine, port engine), built once."""
    jcfg, cfg = jax_get_config(ARCH).reduce(), get_config(ARCH).reduce()
    assert jcfg.capacity_factor == cfg.capacity_factor == 1.25
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    built = {}

    def get(paged):
        if paged not in built:
            built[paged] = (JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, paged_kv=paged)),
                            ServingEngine(model, _ecfg(EngineConfig, paged_kv=paged), device="cpu"))
        return built[paged]

    return get


def _requests(vocab):
    """Seven requests: a shared 16-token prefix (two suffixes and an exact
    repeat, for the paged runs' prefix and full hits), a periodic prompt (the
    drafter's matches) and cold prompts of 8-30 tokens."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, 16)
    shared = [np.concatenate([system, rng.integers(0, vocab, n)]) for n in (3, 9)]
    periodic = np.tile(rng.integers(0, vocab, 5), 4)
    prompts = shared + [shared[0].copy(), periodic] + [rng.integers(0, vocab, n)
                                                       for n in (12, 30, 8)]
    return [(p.astype(np.int32)[None], n) for p, n in zip(prompts, (6, 9, 5, 12, 3, 8, 1))]


def _pump_both(js, ts, pumps=0):
    jr, tr = js.pump(), ts.pump()
    for f in REPORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), (f, pumps)
    assert sorted(tr.completed) == sorted(jr.completed)
    for rid in jr.completed:
        np.testing.assert_array_equal(tr.completed[rid], jr.completed[rid])
    return tr


def _same_results(js, ts):
    assert sorted(ts.results) == sorted(js.results)
    for rid in js.results:
        np.testing.assert_array_equal(ts.results[rid], js.results[rid])


@pytest.mark.parametrize("paged,spec_k", [(False, 0), (True, 0), (False, 4), (True, 4)])
def test_arctic_session_token_exact_with_jax(engines, paged, spec_k):
    jeng, teng = engines(paged)
    assert teng.mixed
    js, ts = jeng.new_session(), teng.new_session()
    js.spec_k = ts.spec_k = spec_k
    requests = _requests(teng.model.cfg.vocab_size)
    for rid, (p, n) in enumerate(requests):
        js.submit(rid, p, n)
        ts.submit(rid, p, n)
    pumps = drafted = 0
    while not (js.idle and ts.idle):
        tr = _pump_both(js, ts, pumps)
        pumps += 1
        drafted += tr.drafted_tokens
    _same_results(js, ts)
    assert sorted(ts.results) == list(range(len(requests)))
    assert (drafted > 0) == (spec_k > 0)
    if paged:
        assert ts.allocator.stats.prefix_hits >= 1 and ts.allocator.stats.full_hits >= 1


def test_arctic_frontiers_resume_in_lockstep_with_jax(engines):
    """Four requests on the paged engine's three slots: once three decode,
    their frontiers equal JAX's (tokens exactly, payloads within 1e-4 below
    the frontier); then both sessions die and fresh ones resume the three
    with zero prefill beside the queued one and three new requests, pump
    by pump (reports, block tables, allocator stats, streams); the
    recovered tokens are the frontiers'."""
    jeng, teng = engines(True)
    js, ts = jeng.new_session(), teng.new_session()
    js.spec_k = ts.spec_k = 0
    requests = _requests(teng.model.cfg.vocab_size)
    for s in (js, ts):
        for rid, (p, n) in enumerate(requests[:4]):
            s.submit(rid, p, n + 8)
    while len(ts.decoding_lens()) < 3:
        _pump_both(js, ts)
    jfs, tfs = dict(js.extract_frontiers()), dict(ts.extract_frontiers())
    assert sorted(tfs) == sorted(jfs) == [0, 1, 2]
    assert ts.decoding_lens() == js.decoding_lens()
    for rid, tf in tfs.items():
        jf = jfs[rid]
        assert (tf.prompt, tf.generated, tf.carry_tok, tf.page_size, tf.tokens) == \
            (tuple(jf.prompt), tuple(jf.generated), int(jf.carry_tok), jf.page_size, jf.tokens)
        assert tf.tokens == ts.decoding_lens()[rid]
        for t, j in zip(tf.pages_kv, jf.pages_kv):
            flat = lambda a: np.asarray(a).reshape(a.shape[0], -1, *a.shape[3:])[:, :tf.tokens]
            np.testing.assert_allclose(flat(t), flat(j), atol=1e-4)
    for s in (js, ts):
        for rid in range(4):
            s.cancel(rid)

    js2, ts2 = jeng.new_session(), teng.new_session()
    js2.spec_k = ts2.spec_k = 0
    for s, frs in ((js2, jfs), (ts2, tfs)):
        for rid, (p, n) in enumerate(requests[:4]):
            s.submit(rid, p, n + 8, frontier=frs.get(rid), recompute=True)
        for rid, (p, n) in enumerate(requests[4:], start=4):
            s.submit(rid, p, n)
    assert sorted(ts2._frontiers) == sorted(js2._frontiers) == sorted(tfs)
    recovered = 0
    while not (js2.idle and ts2.idle):
        recovered += _pump_both(js2, ts2).recovered_tokens
        np.testing.assert_array_equal(ts2.tables, js2.tables)
        assert dataclasses.asdict(ts2.allocator.stats) == dataclasses.asdict(js2.allocator.stats)
    assert recovered == sum(f.tokens for f in tfs.values())
    _same_results(js2, ts2)
    for rid, tf in tfs.items():
        assert list(ts2.results[rid][:len(tf.generated)]) == list(tf.generated)
    assert ts2.allocator.live_pages == 0 and not ts2._frontiers
