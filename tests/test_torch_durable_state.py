"""Durable KV in the port's scan-state sessions against the JAX package (CPU).

rwkv6-7b.reduce() and zamba2-2.7b.reduce() (fp32), as
``tests/test_multimodel.py``'s scan engine serves them: max_len 32, 2
slots, decode chunk 4, legacy admission; the port's weights from the JAX
params (``convert.py``).

* a mid-decode ``StateFrontier`` (page size 1, the batch axis kept) resumed
  in a fresh session with zero prefill, the port's and the JAX session in
  lockstep pump by pump: streams, every report's counters
  (``recovered_tokens``, ``recomputed_prefill_tokens`` among them),
  ``decoding_lens`` and the telemetry; the frontiers' tokens equal, their
  leaves within atol 1e-4 -- rwkv6's states and shift rows and zamba2's
  conv tails and Mamba-2 states whole, zamba2's attention stripes on the
  positions below the frontier (past it they hold garbage that differs);
  the resumed stream equals the uninterrupted JAX stream, a retry marked
  ``recompute`` is counted, a ``KVFrontier`` is ignored;
* a frontier covering the ask completes at submit; a state that does not
  fit the slot raises;
* frontiers cross between the packages through numpy only, both ways,
  token-exact.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.rwkv6 import RWKVLayerCache as JaxRWKVLayerCache
from repro.models.zamba2 import Zamba2Cache as JaxZamba2Cache
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.backends import StateFrontier as JaxStateFrontier
from repro_torch.configs import get_config
from repro_torch.convert import frontier_fields, frontier_from_fields, params_from_jax
from repro_torch.models import Model
from repro_torch.serving import (
    CacheBackend,
    EngineConfig,
    KVFrontier,
    ServingEngine,
    StateFrontier,
)

ATOL = 1e-4
ARCHES = pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
JAX_PAYLOAD = {"rwkv6-7b": JaxRWKVLayerCache, "zamba2-2.7b": JaxZamba2Cache}


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, cfg) by arch, built once each."""

    @functools.cache
    def get(arch: str):
        jcfg = jax_get_config(arch).reduce()
        jmodel = JaxModel(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        cfg = get_config(arch).reduce()
        model = Model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
        kw = dict(max_len=32, decode_batch=2, temperature=0.0, decode_chunk=4,
                  mixed_step=False)
        return (JaxServingEngine(jmodel, jparams, JaxEngineConfig(**kw)),
                ServingEngine(model, EngineConfig(**kw), device="cpu"), cfg)

    return get


REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "useful_tokens",
                 "wasted_tokens", "occupancy", "recovered_tokens", "recomputed_prefill_tokens")
TELEMETRY_FIELDS = ("prefills", "chunks", "useful_tokens", "wasted_tokens",
                    "completed_requests", "recovered_tokens", "recomputed_prefill_tokens")


def _pump_both(js, ts):
    jr, tr = js.pump(), ts.pump()
    for f in REPORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    assert sorted(tr.completed) == sorted(jr.completed)
    for rid in jr.completed:
        np.testing.assert_array_equal(tr.completed[rid], jr.completed[rid])
    assert ts.decoding_lens() == js.decoding_lens()
    return jr, tr


def _drain_both(js, ts):
    while not (js.idle and ts.idle):
        _pump_both(js, ts)
    assert sorted(ts.results) == sorted(js.results)
    for rid in js.results:
        np.testing.assert_array_equal(ts.results[rid], js.results[rid])


def _telemetry(eng):
    return {f: getattr(eng.telemetry, f) for f in TELEMETRY_FIELDS}


def _same_state(tf: StateFrontier, jf) -> None:
    assert (tf.prompt, tf.generated, tf.carry_tok, tf.page_size, tf.tokens) == \
        (tuple(jf.prompt), tuple(jf.generated), int(jf.carry_tok), jf.page_size, jf.tokens)
    assert tf.page_size == 1
    for name, t in tf.state._asdict().items():
        j = np.asarray(getattr(jf.state, name))
        assert t.shape == j.shape and t.shape[1] == 1 and t.dtype == np.float32, name
        if name.startswith("attn_"):                  # zamba2's stripe, below the frontier
            t, j = t[:, :, :tf.tokens], j[:, :, :tf.tokens]
        np.testing.assert_allclose(t, j, atol=ATOL, err_msg=name)


@ARCHES
def test_scan_frontier_lockstep_with_jax(engines, arch):
    """``tests/test_multimodel.py::test_scan_frontier_extract_and_resume``
    in both packages, pump by pump, with a second request decoding beside
    it; the fresh session also takes a retry marked ``recompute`` and a
    request carrying a ``KVFrontier``, ignored."""
    jeng, teng, cfg = engines(arch)
    rng = np.random.default_rng(12)
    p0, p1 = rng.integers(0, cfg.vocab_size, (1, 10)), rng.integers(0, cfg.vocab_size, (1, 13))
    ref = jeng.serve_queue([(p0, 9), (p1, 7)])

    js, ts = jeng.new_session(), teng.new_session()
    assert isinstance(ts, CacheBackend) and ts.scan_state and ts.supports_frontiers
    for s in (js, ts):
        s.submit(0, p0, 9)
        s.submit(1, p1, 7)
    _pump_both(js, ts)
    jfs, tfs = dict(js.extract_frontiers()), dict(ts.extract_frontiers())
    assert sorted(tfs) == sorted(jfs) == [0, 1]
    for rid in tfs:
        assert isinstance(tfs[rid], StateFrontier)
        assert 1 <= len(tfs[rid].generated) < 7
        _same_state(tfs[rid], jfs[rid])
    for s in (js, ts):
        assert s.extract_frontier(99) is None
        s.cancel(0)
        s.cancel(1)

    js2, ts2 = jeng.new_session(), teng.new_session()
    tel0 = (_telemetry(jeng), _telemetry(teng))
    kv = KVFrontier(prompt=tuple(int(t) for t in p1[0]), generated=(), carry_tok=0,
                    pages_kv=None, page_size=1)
    for s, frs in ((js2, jfs), (ts2, tfs)):
        s.submit(0, p0, 9, frontier=frs[0], recompute=True)
        s.submit(1, p1, 7, recompute=True)
    ts2.submit(2, p1, 7, frontier=kv)
    js2.submit(2, p1, 7)
    assert sorted(ts2._frontiers) == sorted(js2._frontiers) == [0]
    _, tr = _pump_both(js2, ts2)
    assert tr.tokens[0][:len(tfs[0].generated)] == list(tfs[0].generated)
    assert tr.recovered_tokens == tfs[0].tokens
    assert tr.recomputed_prefill_tokens == p1.shape[1]
    _drain_both(js2, ts2)
    np.testing.assert_array_equal(ts2.results[0], ref[0])
    for rid in (1, 2):
        np.testing.assert_array_equal(ts2.results[rid], ref[1])
    moved = [{f: _telemetry(e)[f] - t0[f] for f in TELEMETRY_FIELDS}
             for e, t0 in zip((jeng, teng), tel0)]
    assert moved[1] == moved[0] and moved[1]["prefills"] == 2
    assert not ts2._frontiers and not ts2._recompute and not ts2._prompt_of


@ARCHES
def test_scan_frontier_covering_the_ask_and_misfit(engines, arch):
    jeng, teng, cfg = engines(arch)
    prompt = np.random.default_rng(13).integers(0, cfg.vocab_size, (1, 10))
    ref = jeng.serve_queue([(prompt, 9)])[0]
    ts = teng.new_session()
    ts.submit(0, prompt, 9)
    ts.pump()
    fr = ts.extract_frontier(0)
    ts2 = teng.new_session()
    ts2.submit(1, prompt, 3, frontier=fr)
    assert 1 in ts2.results
    rep = ts2.pump()
    assert 1 in rep.completed and rep.recovered_tokens == prompt.shape[1] + 3
    np.testing.assert_array_equal(ts2.results[1], ref[:3])
    bad = type(fr.state)(*(leaf[:1] for leaf in fr.state))         # one layer only
    ts2.submit(2, prompt, 9, frontier=StateFrontier(fr.prompt, fr.generated, fr.carry_tok, bad))
    with pytest.raises(ValueError, match="does not fit"):
        ts2.pump()


@ARCHES
def test_scan_frontier_crosses_between_packages(engines, arch):
    jeng, teng, cfg = engines(arch)
    rng = np.random.default_rng(14)
    p0, p1 = rng.integers(0, cfg.vocab_size, (1, 11)), rng.integers(0, cfg.vocab_size, (1, 9))
    refs = jeng.serve_queue([(p0, 9), (p1, 8)])
    js, ts = jeng.new_session(), teng.new_session()
    js.submit(0, p0, 9)
    ts.submit(1, p1, 8)
    js.pump()
    ts.pump()
    to_port = frontier_from_fields(frontier_fields(js.extract_frontier(0)))
    to_jax = frontier_from_fields(frontier_fields(ts.extract_frontier(1)), JaxStateFrontier,
                                  JAX_PAYLOAD[arch])
    assert isinstance(to_port, StateFrontier) and isinstance(to_jax, JaxStateFrontier)
    ts2, js2 = teng.new_session(), jeng.new_session()
    ts2.submit(0, p0, 9, frontier=to_port)
    js2.submit(1, p1, 8, frontier=to_jax)
    assert list(ts2._frontiers) == [0] and list(js2._frontiers) == [1]
    prefills = teng.telemetry.prefills
    for s in (ts2, js2):
        while not s.idle:
            s.pump()
    assert teng.telemetry.prefills == prefills
    np.testing.assert_array_equal(ts2.results[0], refs[0])
    np.testing.assert_array_equal(js2.results[1], refs[1])
