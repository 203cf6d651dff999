"""The port's paged KV path against the JAX package (CPU).

* Kernels: the plain paged versions (``ref.decode_attention_paged``,
  ``decode_attention_paged_splitk``, ``mixed_attention_paged``) against the
  JAX Pallas kernels in ``interpret=True``, with shuffled, shared and
  trash table entries and column-sliced tables; fp32 atol 2e-5, rtol 1e-3.
* ``BlockAllocator``: the port's copy against the JAX one on the operation
  sequences of ``tests/test_paged_kv.py``.
* Model: paged ``decode``/``step_mixed`` logits and pools against the JAX
  model at fp32 atol 1e-4 (every page but the trash page, which JAX also
  writes padding rows into).
* Engine: greedy streams, per-pump reports, block tables and
  ``allocator.stats`` of the port's paged ``QueueSession`` equal the JAX
  paged session's on the scenarios of ``tests/test_paged_kv.py``
  (qwen3-0.6b.reduce(), weights from ``params_from_jax``, max_len 64,
  page size 8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import kernel as jkernel
from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention import ref as jref
from repro.models import Model as JaxModel
from repro.serving import BlockAllocator as JaxBlockAllocator
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import QueueSession as JaxQueueSession
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.decode_attention import kernel, ops, ref
from repro_torch.models import DecoderKVCache, Model
from repro_torch.serving import (
    EngineClient,
    EngineConfig,
    InferenceRequest,
    QueueSession,
    RequestStatus,
    ServingEngine,
)
from repro_torch.serving.paged_kv import TRASH_PAGE, BlockAllocator

TOL = dict(atol=2e-5, rtol=1e-3)
ATOL = 1e-4


# ---------------------------------------------------------------------------
# kernels: plain paged versions vs the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _pool(rng, P, ps, Hkv, D):
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    return k, v


def _tables(rng, P, B, nb, lens, ps, shared=2):
    """Shuffled distinct pages; rows 1.. share row 0's first ``shared``
    pages (prefix reuse); entries past each length are TRASH_PAGE."""
    pages = rng.permutation(np.arange(1, P))[: B * nb].reshape(B, nb).astype(np.int32)
    pages[1:, :shared] = pages[0, :shared]
    used = -(-np.asarray(lens) // ps)
    pages[np.arange(nb)[None, :] >= used[:, None]] = TRASH_PAGE
    return pages


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("ps", [4, 8, 16])
def test_paged_decode_plain_vs_pallas(ps):
    rng = np.random.default_rng(ps)
    B, Hkv, G, D, nb = 4, 2, 2, 32, 8
    P = 1 + B * nb
    k, v = _pool(rng, P, ps, Hkv, D)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    lens = np.array([nb * ps, 3 * ps + 1, ps, 1], np.int32)
    tbl = _tables(rng, P, B, nb, lens, ps)
    want = jkernel.decode_attention_paged(*_j(q, k, v, tbl, lens), interpret=True)
    got = ops.decode_attention(*_t(q, k, v), *_t(lens), page_table=torch.from_numpy(tbl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k_splits", [2, 4, 8])
@pytest.mark.parametrize("ps", [4, 8, 16, 5, 12])    # 5, 12: the CUDA kernel's division path
def test_paged_splitk_plain_vs_pallas(k_splits, ps):
    rng = np.random.default_rng(10 * k_splits + ps)
    B, Hkv, G, D, nb = 3, 2, 2, 32, 16
    P = 1 + B * nb
    k, v = _pool(rng, P, ps, Hkv, D)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    # full, mid-chunk, inside the first chunk (later chunks wholly empty)
    lens = np.array([nb * ps, (nb // 2) * ps + 3, 2], np.int32)
    tbl = _tables(rng, P, B, nb, lens, ps)
    want = jkernel.decode_attention_paged_splitk(*_j(q, k, v, tbl, lens), k_splits=k_splits,
                                                 interpret=True)
    got = ref.decode_attention_paged_splitk(*_t(q, k, v, tbl, lens), k_splits=k_splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ps", [4, 8, 16])
def test_mixed_paged_plain_vs_pallas_truncated_table(ps):
    """The engine reads ``tables[:, :ceil(aw / ps)]``, a column slice."""
    rng = np.random.default_rng(20 + ps)
    B, Hkv, G, D, Q, nb = 3, 2, 2, 32, 4, 12
    w = 6                                          # read only the first w blocks
    P = 1 + B * nb
    k, v = _pool(rng, P, ps, Hkv, D)
    q = rng.standard_normal((B, Q, Hkv * G, D)).astype(np.float32)
    cl = np.array([0, ps + 1, w * ps - Q], np.int32)
    tbl = _tables(rng, P, B, nb, cl + Q, ps)
    want = jkernel.mixed_attention_paged(*_j(q, k, v, tbl[:, :w], cl), interpret=True)
    tq, tk, tv, tt, tl = _t(q, k, v, tbl, cl)
    view = tt[:, :w]
    assert not view.is_contiguous()
    got = ops.mixed_attention(tq, tk, tv, tl, page_table=view)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(3)
    pages = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    tbl = np.array([[2, 0, 5], [5, 1, 3]], np.int32)
    want = jref.gather_pages(*_j(pages, tbl))
    np.testing.assert_array_equal(ref.gather_pages(*_t(pages, tbl)).numpy(), np.asarray(want))


def test_paged_splitk_partial_matches_contiguous_chunks():
    """Paged chunk kc covers pages [kc·nb/K, (kc+1)·nb/K): the same keys as
    contiguous chunk kc over the gathered cache, so the combine is shared."""
    rng = np.random.default_rng(4)
    B, Hkv, G, D, nb, ps, K = 2, 2, 2, 32, 8, 8, 4
    P = 1 + B * nb
    k, v = _pool(rng, P, ps, Hkv, D)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    lens = np.array([nb * ps, 5], np.int32)
    tq, tk, tv, tt, tl = _t(q, k, v, _tables(rng, P, B, nb, lens, ps), lens)
    m, l, acc = ref.decode_attention_paged_splitk_partial(tq, tk, tv, tt, tl, k_splits=K)
    m2, l2, acc2 = ref.decode_attention_splitk_partial(
        tq, ref.gather_pages(tk, tt), ref.gather_pages(tv, tt), tl, k_splits=K)
    assert m.shape == (B, Hkv, K, G) and acc.shape == (B, Hkv, K, G, D)
    for a, b in ((m, m2), (l, l2), (acc, acc2)):
        assert torch.equal(a, b)
    assert torch.all(m[1, :, 1:] == ref.NEG_INF) and torch.all(l[1, :, 1:] == 0)


def test_auto_paged_k_splits_matches_jax():
    for nb in (1, 2, 4, 8, 16, 32, 64, 96, 128, 256, 512, 1024):
        for ps in (1, 4, 8, 16, 32, 64):
            assert ops.auto_paged_k_splits(nb, ps) == jops.auto_paged_k_splits(nb, ps), (nb, ps)
    assert ops.auto_paged_k_splits(256, 16) == 8
    assert ops.auto_paged_k_splits(64, 16) == 1


def test_cpu_paged_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    k, v = _pool(rng, 5, 8, 2, 32)
    q = rng.standard_normal((2, 4, 32)).astype(np.float32)
    tbl = np.array([[1, 2], [3, 4]], np.int32)
    lens = np.array([16, 3], np.int32)
    kernel.reset_launches()
    ops.decode_attention(*_t(q, k, v), *_t(lens), page_table=torch.from_numpy(tbl))
    assert all(n == 0 for n in kernel.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        kernel.decode_attention_paged_cuda(*_t(q, k, v, tbl, lens))


# ---------------------------------------------------------------------------
# BlockAllocator: the port's copy against the JAX one, op for op
# ---------------------------------------------------------------------------


def _snap(al):
    return (al.refcount.tolist(), list(al._free), list(al._lru), al.free_pages,
            al.cached_pages, al.live_pages, al.occupancy, dataclasses.asdict(al.stats))


def _roundtrip(cls):
    al = cls(num_pages=5, page_size=4)
    out = [al.usable, al.free_pages]
    pages = [al.alloc() for _ in range(4)]
    out += [pages, al.alloc(), al.occupancy]
    al.ref(pages[0])
    al.deref(pages[0])
    out.append(int(al.refcount[pages[0]]))
    for p in pages:
        al.deref(p)
    out.append(_snap(al))
    for bad in (lambda: al.deref(pages[0]), lambda: al.ref(0)):
        with pytest.raises(ValueError):
            bad()
    return out


def _publish_match(cls):
    al = cls(num_pages=8, page_size=4)
    toks = list(range(10))
    pages = [al.alloc() for _ in range(3)]
    al.publish(toks, pages, np.arange(16, dtype=np.float32))
    e = al.lookup_prompt(toks)
    return [e.pages, e.logits.tolist(), al.match_prefix(toks[:8] + [99, 98, 97]),
            al.match_prefix([5] + toks[1:]), al.match_prefix(toks[:8]),
            al.match_len(toks), al.match_len(toks[:8] + [1, 2]), _snap(al)]


def _lru_eviction(cls):
    al = cls(num_pages=4, page_size=2)
    a = al.alloc()
    al.publish([1, 2], [a], np.zeros(4))
    al.deref(a)
    out = [_snap(al)]
    b = al.alloc()
    al.publish([3, 4], [b], np.zeros(4))
    al.deref(b)
    c, d = al.alloc(), al.alloc()
    out += [c, d, al.match_prefix([1, 2, 9]), al.lookup_prompt([1, 2]),
            al.match_prefix([3, 4, 9]), _snap(al)]
    e = al.alloc()
    out += [e, al.match_prefix([3, 4, 9]), al.alloc()]
    for p in (c, d, e):
        al.deref(p)
    return out + [_snap(al)]


def _prefers_cached(cls):
    al = cls(num_pages=3, page_size=2)
    a = al.alloc()
    al.publish([1, 2], [a], np.zeros(4))
    al.deref(a)
    b, c = al.alloc(), al.alloc()
    out = [a, b, c, al.alloc(), _snap(al)]
    al.deref(b)
    return out + [al.alloc(), _snap(al)]


def _cow(cls):
    al = cls(num_pages=5, page_size=4)
    shared = al.alloc()
    al.ref(shared)
    fresh = al.cow(shared)
    out = [shared, fresh, _snap(al)]
    al.ref(shared)
    while al.alloc() is not None:
        pass
    return out + [al.cow(shared), _snap(al)]


def _prompt_cap(cls):
    al = cls(num_pages=12, page_size=2)
    if cls is BlockAllocator:
        al.MAX_PROMPT_ENTRIES = 2                  # a class constant in the port
    else:
        al.max_prompt_entries = 2
    for i in range(3):
        p = al.alloc()
        al.publish([10 * i, 10 * i + 1], [p], np.zeros(4))
    return [al.lookup_prompt([0, 1]), al.lookup_prompt([10, 11]).pages,
            al.lookup_prompt([20, 21]).pages, al.match_prefix([0, 1, 99]), _snap(al)]


@pytest.mark.parametrize("script", [_roundtrip, _publish_match, _lru_eviction,
                                    _prefers_cached, _cow, _prompt_cap],
                         ids=lambda f: f.__name__.strip("_"))
def test_allocator_matches_jax(script):
    assert script(BlockAllocator) == script(JaxBlockAllocator)


# ---------------------------------------------------------------------------
# model: paged decode / step_mixed against the JAX model
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


def _pools(rng, jmodel, model, P, ps):
    jp = jmodel.empty_page_pool(P, ps)
    tp = model.empty_page_pool(P, ps)
    assert tp.k.shape == jp.k.shape
    k = rng.standard_normal(jp.k.shape).astype(np.float32)
    v = rng.standard_normal(jp.v.shape).astype(np.float32)
    tp.k.copy_(torch.from_numpy(k))
    tp.v.copy_(torch.from_numpy(v))
    return jp._replace(k=jnp.asarray(k), v=jnp.asarray(v)), tp


def _close_pools(tp: DecoderKVCache, jp) -> None:
    """Every page but the trash page (JAX writes padding rows into it)."""
    np.testing.assert_allclose(tp.k[:, 1:].numpy(), np.asarray(jp.k)[:, 1:], atol=ATOL)
    np.testing.assert_allclose(tp.v[:, 1:].numpy(), np.asarray(jp.v)[:, 1:], atol=ATOL)


@pytest.mark.parametrize("nb,ps", [(8, 8), (256, 8)])
def test_decode_paged_matches_jax(pair, nb, ps):
    """nb·ps = 2048 takes the paged split-K plain version (K = 8)."""
    jmodel, jparams, cfg, model = pair
    rng = np.random.default_rng(6)
    B = 3
    P = 1 + B * nb
    jp, tp = _pools(rng, jmodel, model, P, ps)
    lens = np.array([0, 13, nb * ps - 1], np.int32)
    tbl = _tables(rng, P, B, nb, lens + 1, ps)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jp2 = jmodel.decode(jparams, jnp.asarray(tokens), jp, jnp.asarray(lens),
                            page_table=jnp.asarray(tbl))
    tl = model.decode(torch.from_numpy(tokens).long(), tp, torch.from_numpy(lens),
                      page_table=tbl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _close_pools(tp, jp2)
    if nb * ps >= 2048:
        assert ops.auto_paged_k_splits(nb, ps) > 1


@pytest.mark.parametrize("all_logits", [False, True])
def test_step_mixed_paged_matches_jax(pair, all_logits):
    jmodel, jparams, cfg, model = pair
    rng = np.random.default_rng(7)
    B, Q, nb, ps, aw = 3, 8, 8, 8, 32
    P = 1 + B * nb
    jp, tp = _pools(rng, jmodel, model, P, ps)
    cache_lens = np.array([0, 17, 24], np.int32)
    new_lens = np.array([8, 1, 5], np.int32)
    tbl = _tables(rng, P, B, nb, cache_lens + new_lens, ps, shared=0)
    tokens = rng.integers(0, cfg.vocab_size, (B, Q)).astype(np.int32)
    jl, jp2 = jmodel.step_mixed(jparams, jnp.asarray(tokens), jp, jnp.asarray(cache_lens),
                                jnp.asarray(new_lens), page_table=jnp.asarray(tbl),
                                attn_window=aw, all_logits=all_logits)
    tl = model.step_mixed(torch.from_numpy(tokens).long(), tp, cache_lens, new_lens,
                          page_table=tbl, attn_window=aw, all_logits=all_logits)
    if all_logits:
        # padding columns are garbage the engine discards; JAX writes their KV
        # into the trash page, which their own queries then read, the port
        # drops them, so only the real columns i < new_lens[b] compare
        for b, n in enumerate(new_lens):
            np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                       atol=ATOL, rtol=1e-4)
    else:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _close_pools(tp, jp2)


# ---------------------------------------------------------------------------
# engine: the port's paged session against the JAX paged session
# ---------------------------------------------------------------------------


def _engines(pair, **kw):
    jmodel, jparams, cfg, model = pair
    base = dict(max_len=64, decode_batch=3, temperature=0.0, decode_chunk=4,
                paged_kv=True, page_size=8)
    base.update(kw)
    return (JaxServingEngine(jmodel, jparams, JaxEngineConfig(**base)),
            ServingEngine(model, EngineConfig(**base), device="cpu"))


REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "prefill_chunks",
                 "mixed_steps", "useful_tokens", "wasted_tokens", "occupancy", "prefix_hits",
                 "prefix_misses", "reused_tokens", "prefilled_tokens", "page_occupancy",
                 "cached_pages")


def _same_state(js, ts) -> None:
    np.testing.assert_array_equal(ts.tables, js.tables)
    assert _snap(ts.allocator) == _snap(js.allocator)


def _pump_both(js, ts):
    jr, tr = js.pump(), ts.pump()
    for f in REPORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    assert sorted(tr.completed) == sorted(jr.completed)
    for rid in jr.completed:
        np.testing.assert_array_equal(tr.completed[rid], jr.completed[rid])
    _same_state(js, ts)
    return jr, tr


def _drain_both(js, ts):
    while not (js.idle and ts.idle):
        _pump_both(js, ts)
    assert sorted(ts.results) == sorted(js.results)
    for rid in js.results:
        np.testing.assert_array_equal(ts.results[rid], js.results[rid])


def _sessions(pair, requests, **kw):
    jeng, teng = _engines(pair, **kw)
    js, ts = JaxQueueSession(jeng), QueueSession(teng)
    for rid, (inp, n) in enumerate(requests):
        js.submit(rid, inp, n)
        ts.submit(rid, inp, n)
    return js, ts


def _shared_requests(vocab, rng):
    """Misses + a full-prompt duplicate + a block-aligned prefix sibling."""
    p0 = rng.integers(0, vocab, (1, 12))
    p1 = np.concatenate([p0[:, :8], rng.integers(0, vocab, (1, 4))], axis=1)
    p2 = rng.integers(0, vocab, (1, 10))
    return [(p0, 6), (p0, 6), (p1, 7), (p2, 5), (p0, 9)]


def test_engine_cold_matches_jax(pair):
    rng = np.random.default_rng(0)
    vocab = pair[2].vocab_size
    reqs = [(rng.integers(0, vocab, (1, 12)), n) for n in (6, 9, 3, 7, 5)]
    js, ts = _sessions(pair, reqs)
    _drain_both(js, ts)
    assert ts.allocator.stats.misses == 5 and ts.allocator.live_pages == 0


def test_engine_prefix_hit_matches_jax(pair):
    js, ts = _sessions(pair, _shared_requests(pair[2].vocab_size, np.random.default_rng(1)))
    _drain_both(js, ts)
    st = ts.allocator.stats
    assert st.full_hits >= 1 and st.prefix_hits >= 1 and st.reused_tokens >= 12 + 8
    assert ts.allocator.live_pages == 0


def test_engine_cow_on_divergence_matches_jax(pair):
    p0 = np.random.default_rng(2).integers(0, pair[2].vocab_size, (1, 12))
    js, ts = _sessions(pair, [(p0, 8), (p0, 8), (p0, 8)])
    _drain_both(js, ts)
    st = ts.allocator.stats
    assert st.full_hits == 2 and st.cow_copies >= 1 and ts.allocator.live_pages == 0


def test_engine_eviction_under_pressure_matches_jax(pair):
    rng = np.random.default_rng(3)
    vocab = pair[2].vocab_size
    reqs = [(rng.integers(0, vocab, (1, 12)), 8) for _ in range(5)]
    js, ts = _sessions(pair, reqs, decode_batch=2, num_pages=7)
    _drain_both(js, ts)
    big = rng.integers(0, vocab, (1, 50))
    for sess in (js, ts):
        with pytest.raises(ValueError):
            sess.submit(99, big, 10)
    assert not ts.fits(50, 10) and ts.fits(12, 8)


def test_engine_cancel_releases_pages_matches_jax(pair):
    rng = np.random.default_rng(4)
    vocab = pair[2].vocab_size
    js, ts = _sessions(pair, [(rng.integers(0, vocab, (1, 12)), 8) for _ in range(4)])
    _pump_both(js, ts)                             # 3 decoding + 1 queued
    live_before = ts.allocator.live_pages
    assert live_before > 0
    for rid in (0, 3):                             # an active slot, a queued request
        assert ts.cancel(rid) and js.cancel(rid)
    _same_state(js, ts)
    assert ts.allocator.live_pages < live_before
    assert np.all(ts.tables[0] == TRASH_PAGE)
    _drain_both(js, ts)
    assert ts.allocator.live_pages == 0 and set(ts.results) == {1, 2}


def test_engine_instant_and_oversize_match_jax(pair):
    js, ts = _sessions(pair, [(np.zeros((1, 8), np.int64), 0)])
    _, tr = _pump_both(js, ts)
    assert tr.completed[0].size == 0 and ts.idle
    for sess in (js, ts):
        with pytest.raises(ValueError):
            sess.submit(1, np.zeros((1, 8), np.int64), 1000)
        sess.submit(1, np.zeros((1, 8), np.int64), 2)
    _drain_both(js, ts)
    assert ts.results[1].size == 2 and ts.allocator.live_pages == 0


def test_engine_report_and_telemetry_match_jax(pair):
    p0 = np.random.default_rng(5).integers(0, pair[2].vocab_size, (1, 12))
    js, ts = _sessions(pair, [(p0, 8)], decode_batch=2)
    _, tr = _pump_both(js, ts)
    assert tr.prefix_misses == 1 and tr.prefilled_tokens == 12 and tr.page_occupancy > 0
    _drain_both(js, ts)
    for sess in (js, ts):
        sess.submit(1, p0, 4)
    _, tr = _pump_both(js, ts)
    assert tr.prefix_hits == 1 and tr.reused_tokens == 12
    _drain_both(js, ts)
    assert ts.allocator.cached_pages > 0
    for probe in (p0, np.concatenate([p0[:, :8], p0[:, :5]], axis=1), p0[:, :3]):
        assert ts.prefix_match_len(probe) == js.prefix_match_len(probe)
    assert ts.prefix_match_len(p0) == 12
    jt, tt = js.eng.telemetry, ts.eng.telemetry
    for f in ("prefix_hits", "prefix_misses", "reused_tokens", "prefilled_tokens",
              "mixed_steps", "prefill_chunks", "prefills", "chunks", "useful_tokens",
              "wasted_tokens", "completed_requests", "cache_hit_rate"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert tt.cache_hit_rate == pytest.approx(0.5)


def test_engine_pool_matches_jax_after_one_pump(pair):
    """One mixed step ingests both prompts, then one decode chunk: the pools
    agree on every page but the trash page."""
    rng = np.random.default_rng(6)
    vocab = pair[2].vocab_size
    js, ts = _sessions(pair, [(rng.integers(0, vocab, (1, 12)), 8) for _ in range(2)])
    _, tr = _pump_both(js, ts)
    assert tr.mixed_steps == 1 and tr.chunk_steps == 4
    _close_pools(ts.cache, js.cache)


# page sizes that end the 12-token prompt mid-page, so its repeats copy a page
@pytest.mark.parametrize("page_size", [5, 8])
def test_port_paged_equals_port_contiguous(pair, page_size):
    *_, cfg, model = pair
    reqs = _shared_requests(cfg.vocab_size, np.random.default_rng(1))
    p0 = reqs[0][0]
    reqs += [(p0, 8), (p0, 8)]
    outs = []
    for paged in (False, True):
        eng = ServingEngine(model, EngineConfig(max_len=64, decode_batch=3, decode_chunk=4,
                                                prefill_chunk=16, paged_kv=paged,
                                                page_size=page_size), device="cpu")
        cli = EngineClient(eng, device="cpu")
        hs = [cli.submit(InferenceRequest(prompt=p, max_new=n)) for p, n in reqs]
        outs.append([h.result() for h in hs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    st = cli.session.allocator.stats
    assert st.full_hits >= 1 and st.prefix_hits >= 1 and st.cow_copies >= 1
    assert cli.session.allocator.live_pages == 0


def test_client_cancel_releases_pages(pair):
    *_, cfg, model = pair
    eng = ServingEngine(model, EngineConfig(max_len=64, decode_batch=1, decode_chunk=2,
                                            prefill_chunk=8, paged_kv=True, page_size=8),
                        device="cpu")
    cli = EngineClient(eng, device="cpu")
    a = cli.submit(InferenceRequest(prompt=np.arange(6), max_new=20))
    b = cli.submit(InferenceRequest(prompt=np.arange(6) + 1, max_new=3))
    cli.tick()
    assert a.status is RequestStatus.STREAMING
    assert cli.session.allocator.live_pages == 4      # ceil((6 + 20) / 8)
    assert a.cancel() and a.status is RequestStatus.CANCELLED
    assert cli.session.allocator.live_pages == 0
    assert np.all(cli.session.tables == TRASH_PAGE)
    assert len(b.result()) == 3 and cli.idle
    assert cli.session.allocator.live_pages == 0
