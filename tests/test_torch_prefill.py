"""The port's prefill path against the JAX package (qwen3-0.6b.reduce(), CPU).

* The plain flash-attention versions (``ref.flash_attention``, the tiled
  online softmax ``ops`` runs on the CPU, and ``ref.attention_ref``)
  against ``flash_attention_pallas(interpret=True)`` at the shapes of
  ``tests/test_kernels.py``, with GQA and Sk > Sq, and against the JAX
  ``attention_ref`` at ragged lengths the Pallas kernel refuses.
  Tolerance: fp32 atol 2e-5, rtol 1e-3; bf16 atol 3e-2, rtol 3e-2.
* ``attention_block``, ``Model.prefill`` and ``Model.prefill_paged``
  against the JAX functions (``use_pallas`` off, as the JAX qwen3 config
  runs, and on): outputs, logits, caches and pools at fp32 atol 1e-4.
* ``ServingEngine.generate`` token-exact with the JAX one.
* The legacy (``mixed_step=False``) ``QueueSession`` pump by pump in
  lockstep with the JAX legacy session on both KV layouts: streams,
  reports, telemetry, block tables and allocator state.
* The port's legacy admission token-exact with its mixed admission on
  both layouts, including a 1500-token prompt, a length the JAX prefill
  refuses (its ``chunked_attention`` needs ``S % min(1024, S) == 0``).

Weights come from ``Model(cfg).init(jax.random.key(0))`` through
``convert.params_from_jax``; inputs from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import Model as JaxModel
from repro.models import attention as jattention
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import QueueSession as JaxQueueSession
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.models import DecoderKVCache, Model, attention
from repro_torch.serving import (
    EngineClient,
    EngineConfig,
    InferenceRequest,
    QueueSession,
    RequestStatus,
    ServingEngine,
)
from repro_torch.serving.paged_kv import TRASH_PAGE

TOL = dict(atol=2e-5, rtol=1e-3)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
ATOL = 1e-4


def _qkv(seed, B, Sq, Sk, Hkv, G, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hkv * G, D)).astype(dtype)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(dtype)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(dtype)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the plain flash versions against the JAX Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,H,D", [(256, 4, 64), (128, 2, 128)])
def test_flash_plain_vs_pallas(S, H, D, causal, window):
    q, k, v = _qkv(0, 2, S, S, H, 1, D)
    want = np.asarray(flash_attention_pallas(*_j(q, k, v), causal=causal, window=window,
                                             block_q=64, block_k=64, interpret=True))
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    whole = ref.attention_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(whole.numpy(), want, **TOL)


@pytest.mark.parametrize("G,Sq,Sk,window", [(2, 128, 128, 0), (4, 128, 128, 96),
                                            (2, 64, 192, 0), (4, 128, 256, 96)])
def test_flash_plain_gqa_vs_pallas(G, Sq, Sk, window):
    """GQA at Hkv width (query head h reads kv head h // G), and queries
    right-aligned to a longer key sequence."""
    q, k, v = _qkv(1, 2, Sq, Sk, 2, G, 64)
    want = np.asarray(flash_attention_pallas(*_j(q, k, v), causal=True, window=window,
                                             block_q=64, block_k=64, interpret=True))
    for block_k in (64, 128):
        got = ref.flash_attention(*_t(q, k, v), causal=True, window=window, block_k=block_k)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_plain_bf16_vs_pallas():
    rng = np.random.default_rng(3)
    shape_q, shape_kv = (1, 256, 4, 64), (1, 256, 2, 64)
    q = jnp.asarray(rng.standard_normal(shape_q), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal(shape_kv), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal(shape_kv), jnp.bfloat16)
    want = np.asarray(flash_attention_pallas(q, k, v, block_q=128, block_k=128, interpret=True),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("Sq,Sk,causal,window", [(100, 100, True, 0), (100, 100, False, 30),
                                                 (37, 100, True, 30), (1, 77, True, 0)])
def test_flash_plain_ragged_vs_attention_ref(Sq, Sk, causal, window):
    """Lengths no tile divides (the Pallas kernel asserts ``S % block == 0``):
    the port's 64-key tiled loop against the JAX score-materialising oracle."""
    G = 2
    q, k, v = _qkv(4, 2, Sq, Sk, 2, G, 32)
    kr, vr = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)     # MHA form for the oracle
    want = np.asarray(jax_attention_ref(*_j(q, kr, vr), causal=causal, window=window))
    got = ref.flash_attention(*_t(q, k, v), causal=causal, window=window, block_k=64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(ref.attention_ref(*_t(q, k, v), causal=causal,
                                                 window=window).numpy(), want, **TOL)


def test_cpu_flash_takes_the_plain_version():
    q, k, v = _t(*_qkv(5, 1, 16, 16, 2, 2, 64))
    kernel.reset_launches()
    ops.flash_attention(q, k, v)
    assert kernel.LAUNCHES == {"flash_attention": 0}
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, k, v)


# ---------------------------------------------------------------------------
# model: attention_block, prefill, prefill_paged against the JAX model
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


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_block_matches_jax(pair, use_pallas):
    jmodel, jparams, cfg, model = pair
    jcfg = dataclasses.replace(jmodel.cfg, use_pallas=use_pallas)
    x = np.random.default_rng(6).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    jout, jcache = jattention.attention_block(lp, jnp.asarray(x), jcfg, return_cache=True)
    out, cache = attention.attention_block(model.layers[0].attn, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=ATOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=ATOL)


@pytest.mark.parametrize("S,use_pallas", [(16, False), (64, False), (700, False), (64, True)])
def test_prefill_matches_jax(pair, S, use_pallas):
    """B=2, generate's shape; S=700 is one 700-query chunk in JAX."""
    jmodel, jparams, cfg, model = pair
    jm = JaxModel(dataclasses.replace(jmodel.cfg, use_pallas=use_pallas))
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))
    jl, jc = jax.jit(jm.prefill)(jparams, {"inputs": jnp.asarray(toks)})
    tl, tc = model.prefill(torch.from_numpy(toks))
    assert tl.shape == (2, cfg.vocab_size)
    assert tc.k.shape == (cfg.n_layers, 2, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL)


def test_prefill_paged_matches_jax(pair):
    """The scenario of ``test_paged_kv.py::test_continuation_prefill_matches_full_prefill``:
    two cached blocks of 8, then a 5-token suffix through the table row."""
    jmodel, jparams, cfg, model = pair
    ps, nb, S, T = 8, 4, 16, 5
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, S + T))
    full_l, _ = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks)})
    _, pc = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks[:, :S])})
    pool = jmodel.empty_page_pool(1 + nb, ps)
    pages = jnp.arange(1, 1 + S // ps, dtype=jnp.int32)
    kr = pc.k.reshape(pc.k.shape[0], S // ps, ps, *pc.k.shape[3:])
    vr = pc.v.reshape(pc.v.shape[0], S // ps, ps, *pc.v.shape[3:])
    pool = type(pool)(k=pool.k.at[:, pages].set(kr), v=pool.v.at[:, pages].set(vr))
    row = np.array([1, 2, 3, 0], np.int32)
    tpool = DecoderKVCache(k=torch.from_numpy(np.array(pool.k)),
                           v=torch.from_numpy(np.array(pool.v)))
    jl, jpool = jax.jit(jmodel.prefill_paged)(jparams, jnp.asarray(toks[:, S:]), pool,
                                              jnp.asarray(row), jnp.int32(S))
    tl = model.prefill_paged(torch.from_numpy(toks[:, S:]), tpool, row, S)
    assert tl.shape == (1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k), atol=ATOL)
    np.testing.assert_allclose(tpool.v.numpy(), np.asarray(jpool.v), atol=ATOL)
    # the continuation reproduces the port's own full prefill
    port_full, _ = model.prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), port_full.numpy(), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(full_l), atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# engine: generate
# ---------------------------------------------------------------------------


def _ecfg(cls, **kw):
    base = dict(max_len=64, decode_batch=3, temperature=0.0, decode_chunk=4, prefill_chunk=8)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("max_len", [64, 2048])
def test_generate_token_exact_with_jax(pair, max_len):
    """Greedy B=4, prompt 16, 12 steps; max_len 2048 decodes through split-K."""
    jmodel, jparams, cfg, model = pair
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 16))
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, max_len=max_len))
    want = jeng.generate({"inputs": jnp.asarray(toks)}, 12, 16)
    eng = ServingEngine(model, _ecfg(EngineConfig, max_len=max_len), device="cpu")
    got = eng.generate({"inputs": toks}, 12, 16)
    assert got.shape == (4, 12)
    np.testing.assert_array_equal(got, want)


def test_generate_raises_past_max_len(pair):
    jmodel, jparams, cfg, model = pair
    toks = np.zeros((1, 16), np.int64)
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, max_len=32))
    eng = ServingEngine(model, _ecfg(EngineConfig, max_len=32), device="cpu")
    for e in (jeng, eng):
        with pytest.raises(ValueError, match="max_len"):
            e.generate({"inputs": toks}, 17, 16)
    assert eng.generate({"inputs": toks}, 16, 16).shape == (1, 16)


def test_generate_temperature_is_seeded(pair):
    *_, cfg, model = pair
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 8))
    outs = [ServingEngine(model, _ecfg(EngineConfig, temperature=0.8, seed=s),
                          device="cpu").generate({"inputs": toks}, 6, 8) for s in (3, 3, 4)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert ((outs[0] >= 0) & (outs[0] < cfg.vocab_size)).all()
    assert not np.array_equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# engine: the legacy session in lockstep with the JAX legacy session
# ---------------------------------------------------------------------------


REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "prefill_chunks",
                 "mixed_steps", "useful_tokens", "wasted_tokens", "occupancy", "prefix_hits",
                 "prefix_misses", "reused_tokens", "prefilled_tokens", "page_occupancy",
                 "cached_pages")
TELEMETRY_FIELDS = ("prefills", "prefill_chunks", "mixed_steps", "chunks", "useful_tokens",
                    "wasted_tokens", "completed_requests", "prefix_hits", "prefix_misses",
                    "reused_tokens", "prefilled_tokens")


def _snap(al):
    return (al.refcount.tolist(), list(al._free), list(al._lru), al.free_pages,
            al.cached_pages, al.live_pages, al.occupancy, dataclasses.asdict(al.stats))


def _legacy_sessions(pair, requests, **kw):
    jmodel, jparams, cfg, model = pair
    kw = dict(dict(mixed_step=False), **kw)
    js = JaxQueueSession(JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, **kw)))
    ts = QueueSession(ServingEngine(model, _ecfg(EngineConfig, **kw), device="cpu"))
    for rid, (inp, n) in enumerate(requests):
        js.submit(rid, inp, n)
        ts.submit(rid, inp, n)
    return js, ts


def _same_state(js, ts):
    if ts.paged:
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
    for f in TELEMETRY_FIELDS:
        assert getattr(ts.eng.telemetry, f) == getattr(js.eng.telemetry, f), f


def _mixed_batch_requests(vocab):
    """``tests/test_mixed_batch.py``'s requests."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (1, p)), n)
            for p, n in [(12, 6), (5, 9), (17, 3), (30, 7), (12, 5), (8, 1)]]


def _shared_requests(vocab, rng):
    """Misses + a full-prompt duplicate + a block-aligned prefix sibling."""
    p0 = rng.integers(0, vocab, (1, 12))
    p1 = np.concatenate([p0[:, :8], rng.integers(0, vocab, (1, 4))], axis=1)
    p2 = rng.integers(0, vocab, (1, 10))
    return [(p0, 6), (p0, 6), (p1, 7), (p2, 5), (p0, 9)]


@pytest.mark.parametrize("max_len", [64, 2048])
def test_legacy_contiguous_lockstep_with_jax(pair, max_len):
    js, ts = _legacy_sessions(pair, _mixed_batch_requests(pair[2].vocab_size), max_len=max_len)
    _, tr = _pump_both(js, ts)
    assert tr.admitted == [0, 1, 2] and tr.mixed_steps == 0
    # after one pump: each admitted slot's prompt and first chunk agree with JAX
    for s, plen in enumerate((12, 5, 17)):
        n = plen + tr.chunk_steps
        np.testing.assert_allclose(ts.cache.k[:, s, :n].numpy(),
                                   np.asarray(js.cache.k)[:, s, :n], atol=ATOL)
    _drain_both(js, ts)
    assert ts.eng.telemetry.prefills == 6


@pytest.mark.parametrize("scenario", ["cold", "prefix_hit", "cow", "pressure"])
def test_legacy_paged_lockstep_with_jax(pair, scenario):
    vocab = pair[2].vocab_size
    rng = np.random.default_rng(10)
    kw = dict(paged_kv=True, page_size=8)
    if scenario == "cold":
        reqs = [(rng.integers(0, vocab, (1, 12)), n) for n in (6, 9, 3, 7, 5)]
    elif scenario == "prefix_hit":
        reqs = _shared_requests(vocab, rng)
    elif scenario == "cow":
        p0 = rng.integers(0, vocab, (1, 12))
        reqs = [(p0, 8), (p0, 8), (p0, 8)]
    else:
        reqs = [(rng.integers(0, vocab, (1, 12)), 8) for _ in range(5)]
        kw.update(decode_batch=2, num_pages=7)
    js, ts = _legacy_sessions(pair, reqs, **kw)
    _pump_both(js, ts)
    # every page but the trash page, which idle slots' decode writes hit
    np.testing.assert_allclose(ts.cache.k[:, 1:].numpy(), np.asarray(js.cache.k)[:, 1:],
                               atol=ATOL)
    np.testing.assert_allclose(ts.cache.v[:, 1:].numpy(), np.asarray(js.cache.v)[:, 1:],
                               atol=ATOL)
    _drain_both(js, ts)
    st = ts.allocator.stats
    assert ts.allocator.live_pages == 0
    if scenario == "cold":
        assert st.misses == 5
    elif scenario == "prefix_hit":
        assert st.full_hits >= 1 and st.prefix_hits >= 1
    elif scenario == "cow":
        assert st.full_hits == 2 and st.cow_copies >= 1
    else:
        assert st.evictions >= 1


def test_legacy_paged_cancel_releases_pages_with_jax(pair):
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, pair[2].vocab_size, (1, 12)), 8) for _ in range(4)]
    js, ts = _legacy_sessions(pair, reqs, paged_kv=True, page_size=8)
    _pump_both(js, ts)                             # 3 decoding + 1 queued
    live_before = ts.allocator.live_pages
    for rid in (0, 3):                             # an active slot, a queued request
        assert ts.cancel(rid) and js.cancel(rid)
    _same_state(js, ts)
    assert ts.allocator.live_pages < live_before
    assert np.all(ts.tables[0] == TRASH_PAGE)
    _drain_both(js, ts)
    assert ts.allocator.live_pages == 0 and set(ts.results) == {1, 2}


def test_legacy_client_stream_and_cancel(pair):
    """``EngineClient`` over a paged legacy session: stream, cancel, pages
    released on cancel."""
    *_, cfg, model = pair
    eng = ServingEngine(model, EngineConfig(max_len=64, decode_batch=1, decode_chunk=2,
                                            mixed_step=False, paged_kv=True, page_size=8),
                        device="cpu")
    cli = EngineClient(eng, device="cpu")
    a = cli.submit(InferenceRequest(prompt=np.arange(6), max_new=20))
    b = cli.submit(InferenceRequest(prompt=np.arange(6) + 1, max_new=3))
    cli.tick()
    assert a.status is RequestStatus.STREAMING and a.delivered == 2
    assert cli.session.allocator.live_pages == 4      # ceil((6 + 20) / 8)
    assert a.cancel() and a.status is RequestStatus.CANCELLED
    assert cli.session.allocator.live_pages == 0
    assert list(b.tokens()) == list(b.result()) and len(b.result()) == 3
    assert cli.idle and cli.session.allocator.live_pages == 0
    assert eng.telemetry.prefills == 2


# ---------------------------------------------------------------------------
# the port's legacy admission == its mixed admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_port_legacy_equals_port_mixed(pair, paged):
    """Token-exact on both layouts, with prefix hits and copy-on-write when
    paged, and one 1500-token prompt: the JAX prefill asserts
    ``S % min(1024, S) == 0`` there, so only the port is held at it."""
    *_, cfg, model = pair
    rng = np.random.default_rng(12)
    reqs = _shared_requests(cfg.vocab_size, rng)
    reqs += [(reqs[0][0], 8), (rng.integers(0, cfg.vocab_size, (1, 1500)), 6)]
    outs = []
    for mixed in (False, True):
        eng = ServingEngine(model, EngineConfig(max_len=2048, decode_batch=3, decode_chunk=4,
                                                prefill_chunk=64, mixed_step=mixed,
                                                paged_kv=paged, page_size=5),
                            device="cpu")
        cli = EngineClient(eng, device="cpu")
        hs = [cli.submit(InferenceRequest(prompt=p, max_new=n)) for p, n in reqs]
        outs.append([h.result() for h in hs])
        if paged:
            st = cli.session.allocator.stats
            assert st.full_hits >= 1 and st.prefix_hits >= 1 and st.cow_copies >= 1
            assert cli.session.allocator.live_pages == 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
