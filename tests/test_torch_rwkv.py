"""The port's rwkv6 path against the JAX package (rwkv6-7b.reduce(), CPU).

* The plain WKV6 versions (``ref.wkv6_ref``, the exact recurrence, and
  ``ref.wkv6_chunked``, the TPU kernel's chunk form that ``ops.wkv6`` runs
  on the CPU) against ``wkv6_pallas(interpret=True)`` at the shapes of
  ``tests/test_kernels.py``, and against the JAX ``wkv6_ref`` and
  ``models.rwkv6.wkv_chunked`` at lengths the Pallas kernel refuses
  (``S % min(64, S) != 0``), with a slow decay and with a strong one
  (log-decays near -20 a token; no assertion is made there about
  ``wkv6_pallas``).  Tolerance: atol 5e-4, rtol 1e-3 on y and the state,
  as ``test_kernels.py``.
* ``group_norm``, ``wkv_decode``, ``time_mix``, ``channel_mix``,
  ``rwkv_layer`` (without and with a cache) and ``rwkv_layer_decode``,
  ``Model.prefill`` and ``Model.decode`` against the JAX functions:
  outputs, logits and every cache leaf at fp32 atol 1e-4.
* ``ServingEngine.generate`` token-exact with the JAX one.
* The rwkv ``QueueSession`` pump by pump in lockstep with the JAX one
  (streams, ``PumpReport``s, ``EngineTelemetry``), slot reuse and a cancel
  included; ``EngineClient`` over it.
* The options the family refuses, as JAX refuses them.

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
from repro.kernels.rwkv6_scan.kernel import wkv6_pallas
from repro.kernels.rwkv6_scan.ref import wkv6_ref as jax_wkv6_ref
from repro.models import Model as JaxModel
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv6
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import QueueSession as JaxQueueSession
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rwkv6_scan import kernel, ops, ref
from repro_torch.models import Model, RWKVLayerCache, layers, rwkv6, transformer
from repro_torch.serving import (
    EngineClient,
    EngineConfig,
    InferenceRequest,
    QueueSession,
    RequestStatus,
    ServingEngine,
)

SCAN_TOL = dict(atol=5e-4, rtol=1e-3)
ATOL = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the plain WKV6 versions against the JAX kernel and oracles
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, B, S, H, N, *, mu=0.0):
    """r, k, v ~ N(0, 1); logw = -exp(mu + 0.5 N(0,1)): mu = 0 as
    ``test_kernels.py``, -5 a slow decay (a state that keeps thousands of
    tokens), 3 a strong one (about -20 per token, so a chunk's cumulative
    log-decay reaches about -1300); u ~ 0.1 N(0, 1); a random fp32 state0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(3))
    logw = -np.exp(mu + 0.5 * rng.standard_normal((B, S, H, N))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, logw, u, s0


def _close_pair(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCAN_TOL)


@pytest.mark.parametrize("plain", [ref.wkv6_ref, ref.wkv6_chunked])
@pytest.mark.parametrize("S,H,N,chunk", [(128, 2, 32, 32), (64, 4, 16, 16)])
def test_wkv6_plain_vs_pallas(plain, S, H, N, chunk):
    args = _wkv_inputs(S + N, 2, S, H, N)
    want = wkv6_pallas(*_j(*args), chunk=chunk, interpret=True)
    _close_pair(plain(*_t(*args)), want)


@pytest.mark.parametrize("plain", [ref.wkv6_ref, ref.wkv6_chunked])
@pytest.mark.parametrize("S,mu", [
    pytest.param(1, 0.0, id="1-False"), pytest.param(17, 0.0, id="17-False"),
    pytest.param(65, 0.0, id="65-False"), pytest.param(100, 0.0, id="100-False"),
    pytest.param(100, -5.0, id="100-True"),
    pytest.param(100, 3.0, id="100-strong"), pytest.param(173, 3.0, id="173-strong"),
])
def test_wkv6_plain_any_length_vs_jax(plain, S, mu):
    """Short last chunks (17, 65, 100, 173) the Pallas kernel refuses, held
    against the JAX recurrence and the model's ``wkv_chunked``, at the
    default, a slow (mu -5) and a strong (mu 3) decay.  At the strong decay
    the chunk form's exponent a_t - cum_{t-1} must come out exactly 0: taken
    as ``cum - w`` it is the rounding error of a large cumulative sum."""
    args = _wkv_inputs(S + 7, 2, S, 2, 32, mu=mu)
    got = plain(*_t(*args))
    _close_pair(got, jax_wkv6_ref(*_j(*args)))
    _close_pair(got, jrwkv6.wkv_chunked(*_j(*args)))


def test_wkv6_cpu_takes_the_plain_chunk_form():
    r, k, v, logw, u, s0 = _t(*_wkv_inputs(3, 1, 40, 2, 16))
    kernel.reset_launches()
    y, st = ops.wkv6(r, k, v, logw, u, s0)
    y_c, st_c = ref.wkv6_chunked(r, k, v, logw, u, s0)
    assert torch.equal(y, y_c) and torch.equal(st, st_c)
    y0, st0 = ops.wkv6(r, k, v, logw, u)                 # no state0: zeros
    y0_c, st0_c = ref.wkv6_chunked(r, k, v, logw, u, torch.zeros_like(s0))
    assert torch.equal(y0, y0_c) and torch.equal(st0, st0_c)
    assert y.dtype == st.dtype == torch.float32
    assert kernel.LAUNCHES == {"wkv6": 0}
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv6_cuda(r, k, v, logw, u, s0)


# ---------------------------------------------------------------------------
# layers against the JAX rwkv6 module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("rwkv6-7b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("rwkv6-7b").reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, cfg, model


def _layer0(jparams):
    return jax.tree.map(lambda a: a[0], jparams["layers"])


def _x(seed, cfg, B=2, S=33):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _layer_cache(seed, cfg, B=2):
    """A random (B, ...) layer cache for both frameworks."""
    rng = np.random.default_rng(seed)
    N = cfg.rwkv_head_dim
    H = cfg.d_model // N
    leaves = (rng.standard_normal((B, H, N, N)).astype(np.float32),
              rng.standard_normal((B, cfg.d_model)).astype(np.float32),
              rng.standard_normal((B, cfg.d_model)).astype(np.float32))
    return RWKVLayerCache(*_t(*leaves)), jrwkv6.RWKVLayerCache(*_j(*leaves))


def _close_cache(got, want, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-4)


def test_group_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32) * 3 + 1
    w, b = rng.standard_normal(128).astype(np.float32), rng.standard_normal(128).astype(np.float32)
    got = layers.group_norm(*_t(x, w, b), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlayers.group_norm(*_j(x, w, b), 4)),
                               atol=1e-5, rtol=1e-5)
    assert layers.group_norm(torch.ones(3, 8, dtype=torch.bfloat16), torch.ones(8),
                             torch.zeros(8), 2).dtype == torch.bfloat16


def test_wkv_decode():
    r, k, v, logw, u, s0 = _wkv_inputs(4, 2, 1, 4, 32)
    got = rwkv6.wkv_decode(*_t(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, s0))
    want = jrwkv6.wkv_decode(*_j(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, s0))
    _close_cache(got, want)


@pytest.mark.parametrize("with_cache", [False, True])
def test_time_and_channel_mix(pair, with_cache):
    jmodel, jparams, cfg, model = pair
    x = _x(1, cfg)
    tc, jc = _layer_cache(2, cfg) if with_cache else (None, None)
    layer, lp = model.layers[0], _layer0(jparams)
    out, (state, shift) = rwkv6.time_mix(layer, torch.from_numpy(x), cfg, tc)
    jout, (jstate, jshift) = jrwkv6.time_mix(lp, jnp.asarray(x), jmodel.cfg, jc)
    _close_cache((out, state, shift), (jout, jstate, jshift))
    out, shift = rwkv6.channel_mix(layer, torch.from_numpy(x), cfg, tc)
    jout, jshift = jrwkv6.channel_mix(lp, jnp.asarray(x), jmodel.cfg, jc)
    _close_cache((out, shift), (jout, jshift))


@pytest.mark.parametrize("with_cache", [False, True])
def test_rwkv_layer(pair, with_cache):
    jmodel, jparams, cfg, model = pair
    x = _x(3, cfg)
    tc, jc = _layer_cache(4, cfg) if with_cache else (None, None)
    out, cache = rwkv6.rwkv_layer(model.layers[1], torch.from_numpy(x), cfg, tc)
    jout, jcache = jrwkv6.rwkv_layer(jax.tree.map(lambda a: a[1], jparams["layers"]),
                                     jnp.asarray(x), jmodel.cfg, jc)
    _close_cache((out, *cache), (jout, *jcache))


def test_rwkv_layer_decode(pair):
    jmodel, jparams, cfg, model = pair
    x = _x(5, cfg, S=1)
    tc, jc = _layer_cache(6, cfg)
    before = [t.clone() for t in tc]
    out, cache = rwkv6.rwkv_layer_decode(model.layers[0], torch.from_numpy(x), cfg, tc)
    jout, jcache = jrwkv6.rwkv_layer_decode(_layer0(jparams), jnp.asarray(x), jmodel.cfg, jc)
    _close_cache((out, *cache), (jout, *jcache))
    assert all(torch.equal(a, b) for a, b in zip(tc, before))       # the cache is only read


# ---------------------------------------------------------------------------
# the model facade
# ---------------------------------------------------------------------------


def test_convert_loads_strict(pair):
    jmodel, jparams, cfg, model = pair
    state = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    fresh = Model(cfg, device="cpu")
    res = fresh.load_state_dict(state, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert set(state) == set(fresh.state_dict())
    assert state["layers.0.ln_x_w"].dtype == torch.float32
    np.testing.assert_array_equal(state["lm_head"].numpy(), np.asarray(jparams["lm_head"]))
    np.testing.assert_array_equal(state["layers.1.mix_w2"].numpy(),
                                  np.asarray(jparams["layers"]["mix_w2"][1]))


def test_seeded_init_matches_the_jax_distributions():
    cfg = get_config("rwkv6-7b").reduce()
    model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
    layer = model.layers[0]
    assert float(layer.u.abs().max()) == 0.0 and bool((layer.w0 == -2.0).all())
    assert bool((layer.mu == 0.5).all()) and bool((layer.ln_x_w == 1.0).all())
    d = cfg.d_model
    assert abs(float(layer.wr.std()) * d ** 0.5 - 1.0) < 0.05
    assert abs(float(layer.cm_wv.std()) * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert abs(float(layer.decay_a.std()) / 0.01 - 1.0) < 0.1
    assert abs(float(model.lm_head.std()) * d ** 0.5 - 1.0) < 0.05
    again = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def _prefill_both(jmodel, jparams, model, toks):
    jl, jc = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks)})
    tl, tc = model.prefill(torch.from_numpy(toks))
    return (tl, tc), (jl, jc)


@pytest.mark.parametrize("S", [16, 64, 100])
def test_prefill_and_decode_match_jax(pair, S):
    """Logits and the (L, B, ...) cache leaves after a B=2 prefill, then four
    decode steps (the cache updated in place) against JAX's."""
    jmodel, jparams, cfg, model = pair
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))
    (tl, tc), (jl, jc) = _prefill_both(jmodel, jparams, model, toks)
    N = cfg.rwkv_head_dim
    assert tl.shape == (2, cfg.vocab_size)
    assert tc.state.shape == (cfg.n_layers, 2, cfg.d_model // N, N, N)
    assert tc.shift_att.shape == tc.shift_ffn.shape == (cfg.n_layers, 2, cfg.d_model)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _close_cache(tc, jc)
    decode = jax.jit(jmodel.decode)
    rng = np.random.default_rng(S + 1)
    for i in range(4):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        jl, jc = decode(jparams, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl = model.decode(torch.from_numpy(tok), tc, torch.full((2,), S + i))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
        _close_cache(tc, jc)


@pytest.mark.parametrize("S", [16, 100])
def test_decode_after_prefill_equals_longer_prefill(pair, S):
    """The port against itself, as ``tests/test_serve_consistency.py`` holds
    JAX: decode of token S after prefill(S) is prefill(S + 1)."""
    *_, cfg, model = pair
    toks = torch.from_numpy(np.random.default_rng(S + 2).integers(0, cfg.vocab_size, (2, S + 1)))
    _, cache = model.prefill(toks[:, :S])
    step = model.decode(toks[:, S:], cache, torch.full((2,), S))
    full, full_cache = model.prefill(toks)
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=2e-4, rtol=1e-4)
    _close_cache(cache, full_cache, atol=2e-4)


def test_prefill_matches_jax_through_pallas(pair):
    """The JAX model with ``use_pallas``: the same function through
    ``ops.wkv6`` (the interpret-mode kernel), at S=64."""
    jmodel, jparams, cfg, model = pair
    jm = JaxModel(dataclasses.replace(jmodel.cfg, use_pallas=True))
    toks = np.random.default_rng(64).integers(0, cfg.vocab_size, (2, 64))
    (tl, tc), (jl, jc) = _prefill_both(jm, jparams, model, toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _close_cache(tc, jc)


def test_prefill_matches_jax_with_random_bonus_and_decay(pair):
    """``u`` and ``w0`` redrawn at random (the JAX init sets u to 0, which
    would hide a fault in the bonus term): prefill and two decode steps."""
    jmodel, jparams, cfg, _ = pair
    rng = np.random.default_rng(9)
    lay = dict(jparams["layers"])
    lay["u"] = jnp.asarray(0.5 * rng.standard_normal(lay["u"].shape), lay["u"].dtype)
    lay["w0"] = jnp.asarray(-2.0 + rng.standard_normal(lay["w0"].shape), lay["w0"].dtype)
    jp = dict(jparams, layers=lay)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    toks = rng.integers(0, cfg.vocab_size, (2, 40))
    (tl, tc), (jl, jc) = _prefill_both(jmodel, jp, model, toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _close_cache(tc, jc)
    for i in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        jl, jc = jax.jit(jmodel.decode)(jp, jnp.asarray(tok), jc, jnp.int32(40 + i))
        tl = model.decode(torch.from_numpy(tok), tc, torch.full((2,), 40 + i))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
        _close_cache(tc, jc)


def test_options_the_family_refuses(pair):
    """No mixed step and no paged KV for rwkv, in the port as in JAX; the
    hybrid and MoE families are ported."""
    jmodel, jparams, cfg, model = pair
    assert not model.supports_mixed_step and not model.supports_paged_kv
    assert not jmodel.supports_mixed_step and not jmodel.supports_paged_kv
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="mixed"):
        model.step_mixed(tok, model.empty_cache(1, 8), np.array([0]), np.array([4]))
    with pytest.raises(ValueError, match="paged"):
        model.prefill_paged(tok, None, np.array([1]), 0)
    with pytest.raises(ValueError, match="paged"):
        model.empty_page_pool(4, 8)
    with pytest.raises(ValueError, match="paged"):
        model.decode(tok[:, :1], model.empty_cache(1, 8), torch.zeros(1),
                     page_table=np.zeros((1, 1), np.int32))
    with pytest.raises(ValueError, match="paged_kv"):
        ServingEngine(model, EngineConfig(max_len=32, paged_kv=True), device="cpu")
    with pytest.raises(ValueError):
        JaxServingEngine(jmodel, jparams, JaxEngineConfig(max_len=32, paged_kv=True))
    for arch in ("zamba2-2.7b", "mixtral-8x22b", "arctic-480b"):
        jc = jax_get_config(arch)
        transformer.check_supported(ModelConfig(**{f.name: getattr(jc, f.name)
                                                   for f in dataclasses.fields(ModelConfig)}))


# ---------------------------------------------------------------------------
# the engine: generate, the session in lockstep with JAX, the client
# ---------------------------------------------------------------------------


def _ecfg(cls, **kw):
    base = dict(max_len=32, decode_batch=2, temperature=0.0, decode_chunk=4)
    base.update(kw)
    return cls(**base)


def test_generate_token_exact_with_jax(pair):
    jmodel, jparams, cfg, model = pair
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, max_len=64))
    want = jeng.generate({"inputs": jnp.asarray(toks)}, 12, 16)
    eng = ServingEngine(model, _ecfg(EngineConfig, max_len=64), device="cpu")
    got = eng.generate({"inputs": toks}, 12, 16)
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "prefill_chunks",
                 "mixed_steps", "useful_tokens", "wasted_tokens", "occupancy")
TELEMETRY_FIELDS = ("prefills", "prefill_chunks", "mixed_steps", "chunks", "useful_tokens",
                    "wasted_tokens", "completed_requests")


def _sessions(pair):
    """The JAX legacy session (``mixed_step=False``, as the multimodel tests
    run it) and the port's at the default ``mixed_step=True``, which the
    engine turns into legacy admission for rwkv, as JAX does."""
    jmodel, jparams, cfg, model = pair
    js = JaxQueueSession(JaxServingEngine(jmodel, jparams,
                                          _ecfg(JaxEngineConfig, mixed_step=False)))
    ts = QueueSession(ServingEngine(model, _ecfg(EngineConfig), device="cpu"))
    assert ts.eng.cfg.mixed_step and not ts.eng.mixed and not js.eng.mixed
    assert ts.scan_state and js.scan_state and not ts.paged
    return js, ts


def _pump_both(js, ts):
    jr, tr = js.pump(), ts.pump()
    for f in REPORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    assert sorted(tr.completed) == sorted(jr.completed)
    for rid in jr.completed:
        np.testing.assert_array_equal(tr.completed[rid], jr.completed[rid])
    return jr, tr


def _drain_both(js, ts):
    while not (js.idle and ts.idle):
        _pump_both(js, ts)
    assert sorted(ts.results) == sorted(js.results)
    for rid in js.results:
        np.testing.assert_array_equal(ts.results[rid], js.results[rid])
    for f in TELEMETRY_FIELDS:
        assert getattr(ts.eng.telemetry, f) == getattr(js.eng.telemetry, f), f


def test_session_straddling_pumps_lockstep_with_jax(pair):
    """``tests/test_multimodel.py``'s scan session: request 0 mid-flight when
    requests 1 and 2 arrive."""
    js, ts = _sessions(pair)
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, pair[2].vocab_size, (1, 8)), n) for n in (5, 7, 4)]
    for s in (js, ts):
        s.submit(0, *reqs[0])
    _pump_both(js, ts)
    # the admitted slot's state and shift rows agree with JAX after a chunk
    _close_cache([leaf[:, 0] for leaf in ts.cache], [leaf[:, 0] for leaf in js.cache])
    for s in (js, ts):
        s.submit(1, *reqs[1])
        s.submit(2, *reqs[2])
    _drain_both(js, ts)
    assert ts.eng.telemetry.prefills == 3


def test_session_reuses_slots_lockstep_with_jax(pair):
    """Six requests through two slots: each admission must replace every
    leaf of its slot (state and both shift rows), which the idle decode
    steps fill with garbage in between."""
    js, ts = _sessions(pair)
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, pair[2].vocab_size, (1, p)), n)
            for p, n in [(12, 5), (8, 9), (12, 3), (8, 7), (12, 4), (8, 6)]]
    for rid, (inp, n) in enumerate(reqs):
        js.submit(rid, inp, n)
        ts.submit(rid, inp, n)
    _drain_both(js, ts)
    assert ts.eng.telemetry.prefills == 6 and ts.eng.telemetry.completed_requests == 6


def test_session_cancel_mid_decode_lockstep_with_jax(pair):
    js, ts = _sessions(pair)
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(0, pair[2].vocab_size, (1, 8)), n) for n in (12, 6, 5)]
    for rid, (inp, n) in enumerate(reqs):
        js.submit(rid, inp, n)
        ts.submit(rid, inp, n)
    _pump_both(js, ts)                              # 0 and 1 decoding, 2 queued
    assert ts.cancel(0) and js.cancel(0)
    assert not ts.cancel(0)
    _drain_both(js, ts)
    assert set(ts.results) == {1, 2}


def test_client_stream_and_cancel(pair):
    """``EngineClient`` over an rwkv session: a cancelled stream frees its
    slot for the next request; streamed tokens equal the session's."""
    *_, cfg, model = pair
    eng = ServingEngine(model, EngineConfig(max_len=32, decode_batch=1, decode_chunk=2),
                        device="cpu")
    cli = EngineClient(eng, device="cpu")
    a = cli.submit(InferenceRequest(prompt=np.arange(6), max_new=20))
    b = cli.submit(InferenceRequest(prompt=np.arange(6) + 1, max_new=3))
    cli.tick()
    assert a.status is RequestStatus.STREAMING and a.delivered == 2
    assert b.status is RequestStatus.QUEUED
    assert a.cancel() and a.status is RequestStatus.CANCELLED
    assert list(b.tokens()) == list(b.result()) and len(b.result()) == 3
    np.testing.assert_array_equal(b.result(), cli.session.results[b.rid])
    assert cli.idle and eng.telemetry.prefills == 2
    # the same request alone in a fresh session streams the same tokens
    solo = QueueSession(ServingEngine(model, EngineConfig(max_len=32, decode_batch=1,
                                                          decode_chunk=2), device="cpu"))
    solo.submit(0, np.arange(6)[None] + 1, 3)
    while not solo.idle:
        solo.pump()
    np.testing.assert_array_equal(solo.results[0], b.result())
