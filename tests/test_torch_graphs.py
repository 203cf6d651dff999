"""The engine's capturable steps on the CPU, against the JAX package
(qwen3-0.6b.reduce(): 2 layers, 4 q / 2 kv heads of 32, fp32).

On the card the engine captures ``ServingEngine._mixed_step`` and
``_decode_steps`` over a ``serving.steps.StepState`` as CUDA graphs; on
the CPU it calls the same functions, so these tests hold the captured
code itself:

* the device-side KV write of the mixed step (``attention.mixed_write_plan``,
  ``paged_write_plan``) against the host-index write, bit for bit, on the
  cache and on every page of the pool but the trash page (padding rows
  go there, as in JAX; nothing reads it);
* the mixed step through the static buffers against the JAX engine's
  ``_mixed_step_fn`` and ``_mixed_step_paged_fn``;
* sessions through the static buffers token-exact with the JAX
  ``QueueSession`` on ``tests/test_mixed_batch.py``'s bucketing workload,
  and ``mixed_traces`` as the JAX engine counts it, warmed or not;
* ``graphs=True`` off the card raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model, attention
from repro_torch.serving import EngineConfig, ServingEngine

ATOL = 1e-4      # the model-level tolerance of tests/test_torch_model.py


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, cfg, model


# ---------------------------------------------------------------------------
# the device-side KV write against the host-index write
# ---------------------------------------------------------------------------


def _host_write(buf, new, src, dst):
    flat = buf.view(-1, *buf.shape[2:])
    rows = new.reshape(-1, *new.shape[2:]).to(buf.dtype)
    flat.index_copy_(0, torch.as_tensor(dst), rows.index_select(0, torch.as_tensor(src)))


def _rand(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


# new_len 0 (slot 1), a tail running past S (slot 2), padding columns
# (slots 0, 3), a slot at S - 1 (slot 3), a slot at S (slot 4: nothing lands)
EDGE_CASE = ([0, 5, 14, 15, 16], [3, 0, 4, 1, 2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_write_equals_host_write(dtype):
    rng = np.random.default_rng(0)
    B, S, Q, H, D = 5, 16, 4, 2, 8
    cases = [EDGE_CASE] + [(rng.integers(0, S + 1, B), rng.integers(0, Q + 1, B))
                           for _ in range(30)]
    for cache_lens, new_lens in cases:
        cache = _rand(rng, (B, S, H, D), dtype)
        new = _rand(rng, (B, Q, H, D), torch.float32)
        want, got = cache.clone(), cache.clone()
        _host_write(want, new, *attention.mixed_write_index(cache_lens, new_lens, Q, S))
        plan = attention.mixed_write_plan(torch.tensor(cache_lens, dtype=torch.int32),
                                          torch.tensor(new_lens, dtype=torch.int32), Q, S)
        attention.write_rows(got, new, plan)
        assert torch.equal(got, want), (cache_lens, new_lens)


def test_contiguous_write_needs_q_rows():
    with pytest.raises(ValueError, match="at least 8 rows"):
        attention.mixed_write_plan(torch.zeros(2, dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32), 8, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_write_equals_host_write(dtype):
    """Page size 4, 4 blocks a slot.  Slot 0 owns pages 1-4; slot 1 shares
    its first two pages with slot 0 and took a copy-on-write page (5) for
    its partial third block, then a fresh one (6); slot 2 is idle (trash
    table, new_len 0); slot 3 writes past the end of its table; slot 4
    shares slot 0's first page only and writes at S - 1.  Every page but
    the trash page must equal the host-index write bit for bit, and the
    host write leaves the trash page alone."""
    rng = np.random.default_rng(1)
    ps, nb, Q, H, D, P = 4, 4, 4, 2, 8, 16
    tables = np.array([[1, 2, 3, 4], [1, 2, 5, 6], [0, 0, 0, 0], [7, 8, 9, 10],
                       [1, 11, 12, 13]], np.int32)
    cases = [([8, 10, 0, 14, 15], [3, 4, 0, 4, 1])]
    # a slot writes only past the pages it shares: from 8 (slots 0, 1), 4 (slot 4)
    lo = np.array([8, 8, 0, 0, 4])
    cases += [(rng.integers(lo, 17), rng.integers(0, Q + 1, 5)) for _ in range(30)]
    for cache_lens, new_lens in cases:
        new_lens = np.where(tables[:, 0] == 0, 0, new_lens)     # the idle slot writes nothing
        pool = _rand(rng, (P, ps, H, D), dtype)
        new = _rand(rng, (5, Q, H, D), torch.float32)
        want, got = pool.clone(), pool.clone()
        _host_write(want, new, *attention.paged_write_index(cache_lens, new_lens, Q, tables, ps))
        plan = attention.paged_write_plan(torch.tensor(cache_lens, dtype=torch.int32),
                                          torch.tensor(new_lens, dtype=torch.int32), Q,
                                          torch.from_numpy(tables), ps)
        attention.write_rows(got, new, plan)
        assert torch.equal(got[1:], want[1:]), (cache_lens, new_lens)
        assert torch.equal(want[0], pool[0])


# ---------------------------------------------------------------------------
# the mixed step through the static buffers against the JAX engine's
# ---------------------------------------------------------------------------


def _ecfg(cls, **kw):
    base = dict(max_len=64, decode_batch=3, temperature=0.0, decode_chunk=4, prefill_chunk=12)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_step_matches_jax_mixed_step_fn(pair, paged):
    """``ServingEngine._mixed_step`` reading its ``StepState`` buffers (a
    decode slot, a prompt chunk and a tail chunk, slot 2's running to the
    last row) against the JAX ``_mixed_step_fn`` / ``_mixed_step_paged_fn``
    on the same cache: logits, argmax and the written cache."""
    jmodel, jparams, cfg, model = pair
    rng = np.random.default_rng(2)
    kw = dict(paged_kv=True, page_size=8) if paged else {}
    eng = ServingEngine(model, _ecfg(EngineConfig, **kw), device="cpu")
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, **kw))
    st = eng._session_state()
    Q, B, aw = eng.chunk_quantum(12), 3, 64
    kv = [rng.standard_normal(leaf.shape).astype(np.float32) for leaf in st.cache]
    for leaf, a in zip(st.cache, kv):
        leaf.copy_(torch.from_numpy(a))
    lens = np.array([17, 0, 60], np.int32)
    new_lens = np.array([1, 4, 4], np.int32)
    is_decode = np.array([True, False, False])
    chunks = rng.integers(0, cfg.vocab_size, (B, Q)).astype(np.int32)
    tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    tables = None
    if paged:
        tables = rng.permutation(np.arange(1, eng.num_pages))[:B * eng.max_blocks]
        tables = tables.reshape(B, eng.max_blocks).astype(np.int32)
    st.stage(lens, new_lens, is_decode, is_decode, tables)
    st.chunk(Q).fill(chunks)
    st.tok.copy_(torch.from_numpy(tok))
    logits, nxt = eng._mixed_call(st, Q, aw)

    args = (jnp.asarray(chunks), jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(new_lens),
            jnp.asarray(is_decode), aw)
    if paged:
        jpool = jmodel.empty_page_pool(eng.num_pages, 8)
        jpool = jpool._replace(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]))
        jl, jc, _ = jeng._mixed_step_paged_fn(jparams, jpool, jnp.asarray(tables), *args)
    else:
        jcache = jmodel.empty_cache(B, 64)
        jcache = jcache._replace(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]))
        jl, jc, _ = jeng._mixed_step_fn(jparams, jcache, *args)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnp.argmax(jl, -1)))
    # JAX's padding rows land in the trash page too, but in another order
    skip = 1 if paged else 0
    for got, want in zip(st.cache, (jc.k, jc.v)):
        np.testing.assert_allclose(got.numpy()[:, skip:], np.asarray(want)[:, skip:], atol=ATOL)


# ---------------------------------------------------------------------------
# sessions through the static buffers, and the bucket count
# ---------------------------------------------------------------------------


def _bucketing_requests(vocab):
    """``tests/test_mixed_batch.py::test_one_trace_serves_many_prompt_lengths``'s
    workload: ten prompts of 3 to 26 tokens, 3 new tokens each."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, (1, p)), 3) for p in (3, 5, 6, 7, 9, 11, 13, 17, 21, 26)]


def _drain(eng, reqs):
    sess = eng.new_session()
    for rid, (p, n) in enumerate(reqs):
        sess.submit(rid, p, n)
    while not sess.idle:
        sess.pump()
    return [np.asarray(sess.results[rid]) for rid in range(len(reqs))]


@pytest.mark.parametrize("paged", [False, True])
def test_session_equals_jax_and_counts_its_buckets(pair, paged):
    """The bucketing workload (budget 12 over 3 slots: Q = 4, windows 4-64)
    through the port's static step buffers is token-exact with the JAX
    ``QueueSession``, and ``mixed_traces`` equals the JAX engine's.  Warmed
    with ``warm_mixed_traces([12])``, the port prepares as many buckets as
    JAX compiles traces, and the workload then adds none."""
    jmodel, jparams, cfg, model = pair
    reqs = _bucketing_requests(cfg.vocab_size)
    kw = dict(paged_kv=True, page_size=8) if paged else {}
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, **kw))
    want = _drain(jeng, reqs)
    eng = ServingEngine(model, _ecfg(EngineConfig, **kw), device="cpu")
    assert not eng.graphs
    got = _drain(eng, reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert eng.mixed_traces == jeng.mixed_traces <= 5

    warm = ServingEngine(model, _ecfg(EngineConfig, **kw), device="cpu")
    assert warm.warm_mixed_traces([12]) == 5 == len(warm._windows(4))
    assert warm.warm_decode() == 0                      # nothing to capture on the CPU
    for a, b in zip(_drain(warm, reqs), want):
        np.testing.assert_array_equal(a, b)
    assert warm.mixed_traces == 5


def test_jax_warms_as_many_buckets(pair):
    """The JAX engine's ``warm_mixed_traces([12])`` at the same config
    compiles the five traces the port prepares."""
    jmodel, jparams, _, _ = pair
    assert JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig)).warm_mixed_traces([12]) == 5


def test_graphs_need_the_card(pair):
    *_, model = pair
    with pytest.raises(ValueError, match="graphs=True"):
        ServingEngine(model, _ecfg(EngineConfig), device="cpu", graphs=True)
    assert not ServingEngine(model, _ecfg(EngineConfig), device="cpu", graphs=False).graphs


def test_step_buffers_refuse_inputs_of_another_shape(pair):
    """A step reads fixed-shape buffers: staging inputs that do not fill
    them exactly raises, rather than leave a replay stale rows."""
    *_, model = pair
    eng = ServingEngine(model, _ecfg(EngineConfig, paged_kv=True, page_size=8), device="cpu")
    st = eng._session_state()
    n, nb = 3, eng.max_blocks
    st.stage(np.zeros(n), np.ones(n), np.zeros(n), np.zeros(n), np.zeros((n, nb)))
    with pytest.raises(ValueError, match="do not fill"):
        st.stage(np.zeros(n), np.ones(n), np.zeros(n), np.zeros(n), np.zeros((n, nb - 1)))
    with pytest.raises(ValueError, match="do not fill"):
        st.chunk(4).fill(np.zeros((n, 8)))
