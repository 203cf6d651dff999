"""Durable KV in the port's paged sessions against the JAX package (CPU).

The recovery tier's geometry of ``tests/test_durable_kv.py``:
qwen3-0.6b.reduce() (fp32), page size 16, max_len 112, 3 slots, 43 pages,
prompts of 96 tokens; the port's weights from the JAX params
(``convert.py``).  Every session test runs under both admissions (mixed and
legacy).

* ``BlockAllocator.extract_kv`` / ``inject_kv`` against the JAX allocator,
  op for op (the trash page, a freed page, all-or-nothing under pressure,
  cached pages evicted only by a grab that succeeds);
* a mid-decode ``KVFrontier`` resumed in a fresh session, the port's and
  the JAX session in lockstep pump by pump: streams, every report's
  counters (``recovered_tokens``, ``recomputed_prefill_tokens`` among
  them), ``decoding_lens``, block tables, ``allocator.stats`` and the
  telemetry; the frontiers' tokens equal and their payloads within atol
  1e-4 on the positions below the frontier (past it the last page holds
  garbage that differs between the two); the resumed stream equals the
  uninterrupted JAX stream; ``submit(recompute=True)`` counted at a miss,
  a prefix hit and a frontier that does not match;
* a frontier covering the ask completes at submit, a mismatched one
  (another prompt, another page size, the other kind) is ignored, a
  payload that does not fit raises, a restore under pool pressure is
  requeued with its frontier kept (in lockstep with JAX), and a
  contiguous session ignores frontiers;
* frontiers cross between the packages through numpy only
  (``convert.frontier_fields`` / ``frontier_from_fields``): a JAX frontier
  resumes token-exact in a port session and a port frontier in a JAX one.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.model import DecoderKVCache as JaxDecoderKVCache
from repro.serving import BlockAllocator as JaxBlockAllocator
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import KVFrontier as JaxKVFrontier
from repro.serving import QueueSession as JaxQueueSession
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import frontier_fields, frontier_from_fields, params_from_jax
from repro_torch.models import Model
from repro_torch.serving import (
    BlockAllocator,
    CacheBackend,
    EngineConfig,
    KVFrontier,
    QueueSession,
    ServingEngine,
    StateFrontier,
)
from repro_torch.serving.paged_kv import TRASH_PAGE

PLEN = 96
PAGE = 16
MAX_LEN = 112
NUM_PAGES = 43
ATOL = 1e-4
ADMISSIONS = pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "legacy"])


# ---------------------------------------------------------------------------
# the allocator's extract / inject against the JAX allocator, op for op
# ---------------------------------------------------------------------------


def _snap(al):
    return (al.refcount.tolist(), list(al._free), list(al._lru), al.free_pages,
            al.cached_pages, al.live_pages, dataclasses.asdict(al.stats))


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _extract_validates(cls):
    al = cls(6, 4)
    pages = [al.alloc() for _ in range(2)]
    out = [al.extract_kv(pages), al.extract_kv(np.asarray(pages, np.int64)),
           _raises(lambda: al.extract_kv([TRASH_PAGE])), _snap(al)]
    al.deref(pages[0])
    return out + [_raises(lambda: al.extract_kv(pages)), _snap(al)]


def _inject_all_or_nothing(cls):
    al = cls(4, 4)                                  # 3 usable pages
    out = [al.inject_kv(5), _snap(al)]              # cannot fit: no state change
    return out + [al.inject_kv(3), al.inject_kv(1), _snap(al)]


def _inject_evicts_only_when_it_succeeds(cls):
    al = cls(5, 2)                                  # 4 usable pages
    a, b = al.alloc(), al.alloc()
    al.publish([1, 2, 3, 4], [a, b], np.zeros(4))
    al.deref(a)
    al.deref(b)                                     # two cached pages
    c = al.alloc()                                  # one free page left
    out = [al.inject_kv(4), _snap(al), al.match_prefix([1, 2, 3, 4, 5])]
    out += [al.inject_kv(2), _snap(al), al.match_prefix([1, 2, 3, 4, 5])]
    al.deref(c)
    return out + [al.inject_kv(0), _snap(al)]


@pytest.mark.parametrize("script", [_extract_validates, _inject_all_or_nothing,
                                    _inject_evicts_only_when_it_succeeds],
                         ids=lambda f: f.__name__.strip("_"))
def test_allocator_extract_inject_matches_jax(script):
    assert script(BlockAllocator) == script(JaxBlockAllocator)


# ---------------------------------------------------------------------------
# sessions: the port's and the JAX paged session, in lockstep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, cfg, model


@pytest.fixture(scope="module")
def engines(pair):
    """(JAX engine, port engine) by (mixed, num_pages), built once each: the
    JAX engine's compiled steps are shared by the module's tests."""
    jmodel, jparams, cfg, model = pair

    @functools.cache
    def get(mixed: bool, num_pages: int = NUM_PAGES):
        kw = dict(max_len=MAX_LEN, decode_batch=3, temperature=0.0, decode_chunk=4,
                  mixed_step=mixed, prefill_chunk=64, paged_kv=True, page_size=PAGE,
                  num_pages=num_pages)
        return (JaxServingEngine(jmodel, jparams, JaxEngineConfig(**kw)),
                ServingEngine(model, EngineConfig(**kw), device="cpu"))

    return get


REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "prefill_chunks",
                 "mixed_steps", "useful_tokens", "wasted_tokens", "occupancy", "prefix_hits",
                 "prefix_misses", "reused_tokens", "prefilled_tokens", "page_occupancy",
                 "cached_pages", "recovered_tokens", "recomputed_prefill_tokens")
TELEMETRY_FIELDS = ("prefills", "prefill_chunks", "mixed_steps", "chunks", "useful_tokens",
                    "wasted_tokens", "completed_requests", "prefix_hits", "prefix_misses",
                    "reused_tokens", "prefilled_tokens", "recovered_tokens",
                    "recomputed_prefill_tokens")


def _pump_both(js, ts):
    jr, tr = js.pump(), ts.pump()
    for f in REPORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    assert sorted(tr.completed) == sorted(jr.completed)
    for rid in jr.completed:
        np.testing.assert_array_equal(tr.completed[rid], jr.completed[rid])
    np.testing.assert_array_equal(ts.tables, js.tables)
    assert _snap(ts.allocator) == _snap(js.allocator)
    assert ts.decoding_lens() == js.decoding_lens()
    assert sorted(ts._frontiers) == sorted(js._frontiers)
    return jr, tr


def _drain_both(js, ts):
    while not (js.idle and ts.idle):
        _pump_both(js, ts)
    assert sorted(ts.results) == sorted(js.results)
    for rid in js.results:
        np.testing.assert_array_equal(ts.results[rid], js.results[rid])


def _telemetry(eng):
    return {f: getattr(eng.telemetry, f) for f in TELEMETRY_FIELDS}


def _prompts(cfg, seed, n=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, (1, PLEN)) for _ in range(n)]


def _same_payload(tf: KVFrontier, jf) -> None:
    """Tokens equal; pages within ATOL below the frontier (the last page's
    rows past it hold garbage that differs between the packages)."""
    assert (tf.prompt, tf.generated, tf.carry_tok, tf.page_size, tf.tokens) == \
        (tuple(jf.prompt), tuple(jf.generated), int(jf.carry_tok), jf.page_size, jf.tokens)
    n = tf.tokens
    for t, j in zip(tf.pages_kv, jf.pages_kv):
        assert t.shape == np.asarray(j).shape and t.dtype == np.float32
        flat = lambda a: np.asarray(a).reshape(a.shape[0], -1, *a.shape[3:])[:, :n]
        np.testing.assert_allclose(flat(t), flat(j), atol=ATOL)


def _mid_decode(js, ts, rid, at_least):
    while len(ts._out.get(rid, [])) < at_least:
        _pump_both(js, ts)


@ADMISSIONS
def test_frontier_roundtrip_lockstep_with_jax(pair, engines, mixed):
    """Extract mid-decode, kill, resume in fresh sessions with zero prefill,
    both packages pump by pump; beside the restored request, retries
    marked ``recompute``: a miss, one with a frontier of another prompt
    (ignored: it prefills), a prefix hit on the miss's first page and a
    full hit on its repeat (no model work, nothing recomputed)."""
    cfg = pair[2]
    jeng, teng = engines(mixed)
    p0, p1, p2 = _prompts(cfg, 3, 3)
    ref = jeng.serve_queue([(p0, 10)])[0]

    js, ts = JaxQueueSession(jeng), QueueSession(teng)
    assert isinstance(ts, CacheBackend) and ts.supports_frontiers
    for s in (js, ts):
        s.submit(0, p0, 10)
        s.submit(5, p2, 6)
    _mid_decode(js, ts, 0, 4)
    jfs, tfs = dict(js.extract_frontiers()), dict(ts.extract_frontiers())
    assert sorted(tfs) == sorted(jfs) == [0, 5]
    for rid in tfs:
        _same_payload(tfs[rid], jfs[rid])
        assert tfs[rid].tokens == ts.decoding_lens()[rid]
    assert list(tfs[0].generated) == [int(x) for x in ref[:len(tfs[0].generated)]]
    for s in (js, ts):
        assert s.extract_frontier(99) is None
        s.cancel(0)                                  # the replica dies
        s.cancel(5)

    js2, ts2 = JaxQueueSession(jeng), QueueSession(teng)
    tel0 = (_telemetry(jeng), _telemetry(teng))
    sib = np.concatenate([p1[:, :PAGE], p0[:, PAGE:]], axis=1)
    for s, frs in ((js2, jfs), (ts2, tfs)):
        s.submit(1, p0, 10, frontier=frs[0], recompute=True)
        s.submit(2, p1, 5, recompute=True)
        s.submit(3, p2, 5, frontier=frs[0], recompute=True)   # another prompt's: ignored
        s.submit(4, sib, 4, recompute=True)
        s.submit(6, p1, 3, recompute=True)
    assert sorted(ts2._frontiers) == sorted(js2._frontiers) == [1]
    jr, tr = _pump_both(js2, ts2)
    assert tr.admitted[0] == 1 and tr.tokens[1][:len(tfs[0].generated)] == list(tfs[0].generated)
    assert tr.recovered_tokens == tfs[0].tokens
    _drain_both(js2, ts2)
    np.testing.assert_array_equal(ts2.results[1], ref)
    moved = [{f: _telemetry(e)[f] - t0[f] for f in TELEMETRY_FIELDS}
             for e, t0 in zip((jeng, teng), tel0)]
    assert moved[1] == moved[0]
    assert moved[1]["recovered_tokens"] == tfs[0].tokens
    assert moved[1]["recomputed_prefill_tokens"] == moved[1]["prefilled_tokens"] > 0
    st = ts2.allocator.stats
    assert st.misses == 2 and st.prefix_hits == 1 and st.full_hits == 1
    assert ts2.allocator.live_pages == 0 and not ts2._frontiers and not ts2._recompute


@ADMISSIONS
def test_frontier_covering_the_ask_instant_completes(pair, engines, mixed):
    cfg = pair[2]
    jeng, teng = engines(mixed)
    (prompt,) = _prompts(cfg, 4)
    ref = jeng.serve_queue([(prompt, 10)])[0]
    js, ts = JaxQueueSession(jeng), QueueSession(teng)
    for s in (js, ts):
        s.submit(0, prompt, 10)
    _mid_decode(js, ts, 0, 6)
    jf, tf = js.extract_frontier(0), ts.extract_frontier(0)
    js2, ts2 = JaxQueueSession(jeng), QueueSession(teng)
    for s, fr in ((js2, jf), (ts2, tf)):
        s.submit(2, prompt, 4, frontier=fr, recompute=True)   # asks less than fr holds
        assert 2 in s.results and not s._recompute
    jr, tr = _pump_both(js2, ts2)
    assert 2 in tr.completed and tr.recovered_tokens == PLEN + 4 and tr.chunk_steps == 0
    np.testing.assert_array_equal(ts2.results[2], ref[:4])
    # a retired request has nothing to extract
    _drain_both(js, ts)
    assert ts.extract_frontier(0) is None and ts.extract_frontiers() == []


@ADMISSIONS
def test_mismatched_frontier_is_ignored(pair, engines, mixed):
    """Another prompt's frontier, one of another page size and a scan-state
    frontier are ignored at submit: the request prefills and completes as
    the uninterrupted run."""
    cfg = pair[2]
    jeng, teng = engines(mixed)
    p1, p2 = _prompts(cfg, 5, 2)
    ref = jeng.serve_queue([(p2, 6)])[0]
    ts = QueueSession(teng)
    ts.submit(0, p1, 10)
    while len(ts._out.get(0, [])) < 3:
        ts.pump()
    fr = ts.extract_frontier(0)
    ts.cancel(0)
    wrong = [fr, dataclasses.replace(fr, prompt=tuple(int(t) for t in p2[0]), page_size=8),
             StateFrontier(prompt=tuple(int(t) for t in p2[0]), generated=(1,), carry_tok=0,
                           state=None)]
    ts2 = QueueSession(teng)
    for rid, w in enumerate(wrong):
        ts2.submit(rid, p2, 6, frontier=w)
    assert not ts2._frontiers
    while not ts2.idle:
        ts2.pump()
    for rid in range(len(wrong)):
        np.testing.assert_array_equal(ts2.results[rid], ref)


def test_restore_that_does_not_fit_raises(pair, engines):
    """A payload that does not fit the pages it is injected into raises; it
    is never turned into a prefill."""
    cfg = pair[2]
    _, teng = engines(True)
    (prompt,) = _prompts(cfg, 6)
    ts = QueueSession(teng)
    ts.submit(0, prompt, 10)
    while len(ts._out.get(0, [])) < 2:
        ts.pump()
    fr = ts.extract_frontier(0)
    short = dataclasses.replace(fr, pages_kv=type(fr.pages_kv)(
        *(leaf[:, :-1] for leaf in fr.pages_kv)))
    ts2 = QueueSession(teng)
    ts2.submit(1, prompt, 10, frontier=short)
    with pytest.raises(ValueError, match="does not fit"):
        ts2.pump()


@ADMISSIONS
def test_restore_under_pool_pressure_requeues_with_frontier(pair, engines, mixed):
    """A pool of 10 usable pages: a decoding request holds 7, so a frontier
    needing 7 waits, its frontier kept, and restores once pages free."""
    cfg = pair[2]
    jeng, teng = engines(mixed, num_pages=11)
    p0, p1 = _prompts(cfg, 7, 2)
    ref = jeng.serve_queue([(p0, 10)])[0]
    js, ts = JaxQueueSession(jeng), QueueSession(teng)
    for s in (js, ts):
        s.submit(0, p0, 10)
    _mid_decode(js, ts, 0, 4)
    jf, tf = js.extract_frontier(0), ts.extract_frontier(0)
    for s in (js, ts):
        s.cancel(0)
    js2, ts2 = JaxQueueSession(jeng), QueueSession(teng)
    for s, fr in ((js2, jf), (ts2, tf)):
        s.submit(1, p1, 8)
        s.submit(0, p0, 10, frontier=fr)
    _, tr = _pump_both(js2, ts2)
    assert tr.admitted == [1] and ts2._frontiers[0] is tf and tr.recovered_tokens == 0
    seen = 0
    while not (js2.idle and ts2.idle):
        _, tr = _pump_both(js2, ts2)
        seen += tr.recovered_tokens
    assert seen == tf.tokens
    _drain_both(js2, ts2)
    np.testing.assert_array_equal(ts2.results[0], ref)
    assert ts2.allocator.live_pages == 0


@ADMISSIONS
def test_contiguous_session_ignores_frontiers(pair, engines, mixed):
    cfg, model = pair[2], pair[3]
    jeng, teng = engines(mixed)
    (prompt,) = _prompts(cfg, 8)
    ref = jeng.serve_queue([(prompt, 8)])[0]
    ts = QueueSession(teng)
    ts.submit(0, prompt, 8)
    while len(ts._out.get(0, [])) < 2:
        ts.pump()
    fr = ts.extract_frontier(0)
    flat = ServingEngine(model, dataclasses.replace(teng.cfg, paged_kv=False), device="cpu")
    cs = QueueSession(flat)
    assert isinstance(cs, CacheBackend) and not cs.supports_frontiers and not cs.scan_state
    cs.submit(0, prompt, 8, frontier=fr, recompute=True)
    assert not cs._frontiers
    while len(cs._out.get(0, [])) < 2:
        cs.pump()
    assert cs.extract_frontier(0) is None and cs.extract_frontiers() == []
    while not cs.idle:
        cs.pump()
    np.testing.assert_array_equal(cs.results[0], ref)


# ---------------------------------------------------------------------------
# frontiers across the packages, through numpy
# ---------------------------------------------------------------------------


@ADMISSIONS
def test_frontier_crosses_between_packages(pair, engines, mixed):
    cfg = pair[2]
    jeng, teng = engines(mixed)
    p0, p1 = _prompts(cfg, 9, 2)
    refs = jeng.serve_queue([(p0, 10), (p1, 9)])

    js, ts = JaxQueueSession(jeng), QueueSession(teng)
    js.submit(0, p0, 10)
    ts.submit(1, p1, 9)
    while len(js._out.get(0, [])) < 4 or len(ts._out.get(1, [])) < 3:
        js.pump()
        ts.pump()
    jf, tf = js.extract_frontier(0), ts.extract_frontier(1)
    # JAX -> port, port -> JAX: numpy fields only
    to_port = frontier_from_fields(frontier_fields(jf))
    to_jax = frontier_from_fields(frontier_fields(tf), JaxKVFrontier, JaxDecoderKVCache)
    assert isinstance(to_port, KVFrontier) and isinstance(to_jax, JaxKVFrontier)
    assert frontier_fields(to_port)["prompt"] == tuple(int(t) for t in jf.prompt)

    ts2, js2 = QueueSession(teng), JaxQueueSession(jeng)
    recomputed = teng.telemetry.recomputed_prefill_tokens
    ts2.submit(0, p0, 10, frontier=to_port)
    js2.submit(1, p1, 9, frontier=to_jax)
    assert list(ts2._frontiers) == [0] and list(js2._frontiers) == [1]
    for s in (ts2, js2):
        while not s.idle:
            s.pump()
    np.testing.assert_array_equal(ts2.results[0], refs[0])
    np.testing.assert_array_equal(js2.results[1], refs[1])
    assert teng.telemetry.recomputed_prefill_tokens == recomputed
    assert ts2.eng.telemetry.prefills == teng.telemetry.prefills
