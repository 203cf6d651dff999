"""The port's hybrid (zamba2) path against the JAX package (zamba2-2.7b.reduce(), CPU).

* The plain SSD versions (``ref.ssd_ref``, the exact recurrence, and
  ``ref.ssd_chunked``, the chunk form that ``ops.ssd`` runs on the CPU)
  against ``ssd_pallas(interpret=True)`` at the shapes of
  ``tests/test_kernels.py`` and across two calls carrying the state, and
  against the JAX ``ssd_ref`` at lengths the Pallas kernel refuses
  (``S % min(128, S) != 0``), from a random state0, and with a slow decay
  (A about -1e-3) over 2000 steps.  Tolerance: atol 5e-4, rtol 1e-3 on y
  and the state, as ``test_kernels.py``.
* The plain RMSNorm in both forms against the JAX ``rmsnorm_ref`` and
  ``rmsnorm_pallas(interpret=True)`` (fp32 atol 1e-5; bf16 one bf16 ulp
  against the Pallas kernel, which also normalises the unrounded sum).
* ``_causal_conv`` (with and without a tail), ``ssd_decode``,
  ``mamba2_layer`` (without and with a cache, and with random ``A_log``,
  ``dt_bias``, ``D`` and ``conv_b``) and ``mamba2_layer_decode``,
  ``Model.prefill`` and ``Model.decode`` against the JAX functions
  (``use_pallas`` off and on): outputs, logits and every cache leaf at
  fp32 atol 1e-4; decode after prefill(S) against prefill(S + 1) in the
  port, also at S = 200, a length the JAX prefill refuses.
* ``ServingEngine.generate`` token-exact with the JAX one.
* The hybrid ``QueueSession`` pump by pump in lockstep with the JAX one
  (streams, ``PumpReport``s, ``EngineTelemetry``), straddling pumps, slot
  reuse and a cancel included; ``EngineClient`` over it.
* The options the family refuses, as JAX refuses them, and a strict load.

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
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.ssd_scan.kernel import ssd_pallas
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import Model as JaxModel
from repro.models import mamba2 as jmamba2
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import QueueSession as JaxQueueSession
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rmsnorm import kernel as norm_kernel
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.rmsnorm import ref as norm_ref
from repro_torch.kernels.ssd_scan import kernel, ops, ref
from repro_torch.models import Mamba2LayerCache, Model, Zamba2Cache, layers, mamba2
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
# the plain SSD versions against the JAX kernel and oracle
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, B, S, H, P, N, *, slow=False, state=True):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(0.3 N(0, 1)) as
    ``test_kernels.py``, or with ``slow`` A = -1e-3 exp(0.3 N(0, 1)), a
    state that keeps thousands of steps; a random fp32 state0 or zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0).astype(np.float32)
    A = (-(1e-3 if slow else 1.0) * np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    s0 = (rng.standard_normal((B, H, P, N)) if state else np.zeros((B, H, P, N)))
    return x, dt, A, Bm, Cm, s0.astype(np.float32)


def _close_pair(got, want, tol=SCAN_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("plain", [ref.ssd_ref, ref.ssd_chunked])
@pytest.mark.parametrize("S,H,P,N,chunk", [(128, 2, 32, 16, 32), (64, 4, 16, 16, 16)])
def test_ssd_plain_vs_pallas(plain, S, H, P, N, chunk):
    args = _ssd_inputs(S + N, 2, S, H, P, N)
    want = ssd_pallas(*_j(*args), chunk=chunk, interpret=True)
    _close_pair(plain(*_t(*args)), want)


@pytest.mark.parametrize("plain", [ref.ssd_ref, ref.ssd_chunked])
def test_ssd_plain_state_continuity(plain):
    """``test_ssd_state_continuity``: two calls carrying the state equal one
    call, here against the one-call Pallas kernel."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(8, 1, 128, 2, 16, 16, state=False)
    y_full, st_full = ssd_pallas(*_j(x, dt, A, Bm, Cm, s0), chunk=32, interpret=True)
    h = 70                                          # a split no chunk divides
    y1, st1 = plain(*_t(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], s0))
    y2, st2 = plain(*_t(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:]), st1)
    _close_pair((torch.cat([y1, y2], 1), st2), (y_full, st_full))


@pytest.mark.parametrize("plain", [ref.ssd_ref, ref.ssd_chunked])
@pytest.mark.parametrize("S,slow", [(1, False), (17, False), (100, False), (200, False),
                                    (2000, True)])
def test_ssd_plain_any_length_vs_jax(plain, S, slow):
    """Lengths 1 to 2000 from a random state0 (2000 with a slow decay),
    held against the JAX recurrence; against the JAX chunk form too where
    it accepts the length (``S % min(128, S) == 0``: 1, 17 and 100 as one
    chunk, not 200 or 2000)."""
    args = _ssd_inputs(S + 5, 2, S, 2, 32, 16, slow=slow)
    got = plain(*_t(*args))
    _close_pair(got, jax_ssd_ref(*_j(*args)))
    if S % min(128, S) == 0:
        _close_pair(got, jmamba2.ssd_chunked(*_j(*args)))


def test_ssd_cpu_takes_the_plain_chunk_form():
    x, dt, A, Bm, Cm, s0 = _t(*_ssd_inputs(3, 1, 40, 2, 16, 16))
    kernel.reset_launches()
    y, st = ops.ssd(x, dt, A, Bm, Cm, s0)
    y_c, st_c = ref.ssd_chunked(x, dt, A, Bm, Cm, s0)
    assert torch.equal(y, y_c) and torch.equal(st, st_c)
    y0, st0 = ops.ssd(x, dt, A, Bm, Cm)                  # no state0: zeros
    y0_c, st0_c = ref.ssd_chunked(x, dt, A, Bm, Cm, torch.zeros_like(s0))
    assert torch.equal(y0, y0_c) and torch.equal(st0, st0_c)
    assert y.dtype == st.dtype == torch.float32
    assert kernel.LAUNCHES == {"ssd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_cuda(x, dt, A, Bm, Cm, s0)


# ---------------------------------------------------------------------------
# the plain RMSNorm against the JAX kernel and oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("M,d", [(7, 128), (256, 256)])
def test_rmsnorm_plain_vs_jax(M, d, with_residual):
    rng = np.random.default_rng(M + d)
    x, r = (rng.standard_normal((M, d)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal(d).astype(np.float32)
    res = r if with_residual else None
    got = norm_ref.rmsnorm_ref(*_t(x, w), None if res is None else torch.from_numpy(res))
    jres = None if res is None else jnp.asarray(res)
    for want in (jax_rmsnorm_ref(*_j(x, w), jres),
                 rmsnorm_pallas(*_j(x, w), jres, block_rows=M, interpret=True)):
        _close_pair(got, want, dict(atol=1e-5, rtol=1e-5))
    if not with_residual:                               # the plain form is layers.rms_norm
        assert torch.equal(got[0], layers.rms_norm(*_t(x, w)))


def test_rmsnorm_fused_bf16_matches_the_pallas_kernel():
    """In bf16 the fused form normalises the unrounded fp32 sum, as the TPU
    kernel does; the sum itself is returned rounded to bf16."""
    rng = np.random.default_rng(1)
    x, r = (rng.standard_normal((16, 256)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal(256).astype(np.float32)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, w, r)]
    out, summed = norm_ref.rmsnorm_ref(bf[0], bf[1], bf[2])
    jbf = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf]
    jout, jsum = rmsnorm_pallas(jbf[0], jbf[1], jbf[2], block_rows=16, interpret=True)
    assert out.dtype == summed.dtype == torch.bfloat16
    np.testing.assert_array_equal(summed.float().numpy(), np.asarray(jsum, np.float32))
    # at most one bf16 ulp apart (the two sides round the same fp32 value)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_rmsnorm_cpu_takes_the_plain_version():
    rng = np.random.default_rng(2)
    x, r = _t(*(rng.standard_normal((3, 5, 64)).astype(np.float32) for _ in range(2)))
    w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    norm_kernel.reset_launches()
    assert torch.equal(norm_ops.rms_norm(x, w), layers.rms_norm(x, w))
    out, summed = norm_ops.rmsnorm(x, w, r)
    assert torch.equal(summed, x + r) and torch.equal(out, layers.rms_norm(x + r, w))
    assert norm_kernel.LAUNCHES == {"rmsnorm": 0, "rmsnorm_fused": 0}
    with pytest.raises(ValueError, match="CUDA"):
        norm_kernel.rmsnorm_cuda(x, w)


# ---------------------------------------------------------------------------
# layers against the JAX mamba2 module
# ---------------------------------------------------------------------------


def _load(jparams, cfg):
    model = Model(cfg, device="cpu")
    res = model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg),
                                strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return model


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("zamba2-2.7b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("zamba2-2.7b").reduce()
    return jmodel, jparams, cfg, _load(jparams, cfg)


def _randomised(jparams, seed):
    """The JAX init sets A_log = dt_bias = conv_b = 0 and D = 1, so A = -1
    and the state forgets within ~10 tokens; redraw them (a slow decay for
    some heads) so a fault in the decay, dt or the skip cannot hide."""
    rng = np.random.default_rng(seed)
    lay = dict(jparams["layers"])
    shape = lay["A_log"].shape
    lay["A_log"] = jnp.asarray(rng.uniform(-7.0, 0.5, shape), jnp.float32)
    lay["dt_bias"] = jnp.asarray(rng.standard_normal(shape) - 1.0, jnp.float32)
    lay["D"] = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    lay["conv_b"] = jnp.asarray(0.1 * rng.standard_normal(lay["conv_b"].shape),
                                lay["conv_b"].dtype)
    return dict(jparams, layers=lay)


def _lp(jparams, li):
    return jax.tree.map(lambda a: a[li], jparams["layers"])


def _x(seed, cfg, B=2, S=33):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _layer_cache(seed, cfg, B=2):
    rng = np.random.default_rng(seed)
    d_inner, P, H, N, conv_ch = mamba2.dims(cfg)
    leaves = (rng.standard_normal((B, mamba2.CONV_K - 1, conv_ch)).astype(np.float32),
              rng.standard_normal((B, H, P, N)).astype(np.float32))
    return Mamba2LayerCache(*_t(*leaves)), jmamba2.Mamba2LayerCache(*_j(*leaves))


def _close_cache(got, want, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-4)


def test_config_matches_jax():
    jc = jax_get_config("zamba2-2.7b")
    cfg = get_config("zamba2-2.7b")
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(jc, f.name), f.name
    assert mamba2.dims(cfg) == jmamba2.dims(jc) == (5120, 64, 80, 64, 5248)
    assert cfg.resolved_head_dim == 80


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv(with_tail):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    w = rng.standard_normal((mamba2.CONV_K, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    tail = rng.standard_normal((2, mamba2.CONV_K - 1, 40)).astype(np.float32) if with_tail else None
    got = mamba2._causal_conv(*_t(x, w, b), None if tail is None else torch.from_numpy(tail))
    want = jmamba2._causal_conv(*_j(x, w, b), None if tail is None else jnp.asarray(tail))
    _close_cache(got, want, atol=1e-5)
    # one token at a time through the tail is the whole sequence
    t = None if tail is None else torch.from_numpy(tail)
    outs = []
    for i in range(x.shape[1]):
        o, t = mamba2._causal_conv(torch.from_numpy(x[:, i:i + 1]), *_t(w, b), t)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), got[0].numpy(), atol=1e-6)


def test_ssd_decode():
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(4, 2, 1, 4, 32, 16)
    got = mamba2.ssd_decode(*_t(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], s0))
    want = jmamba2.ssd_decode(*_j(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], s0))
    _close_cache(got, want, atol=1e-5)


@pytest.mark.parametrize("randomised", [False, True])
@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba2_layer(pair, with_cache, randomised):
    jmodel, jparams, cfg, model = pair
    if randomised:
        jparams = _randomised(jparams, 5)
        model = _load(jparams, cfg)
    x = _x(1, cfg)
    tc, jc = _layer_cache(2, cfg) if with_cache else (None, None)
    out, cache = mamba2.mamba2_layer(model.layers[1], torch.from_numpy(x), cfg, tc)
    jout, jcache = jmamba2.mamba2_layer(_lp(jparams, 1), jnp.asarray(x), jmodel.cfg, jc)
    _close_cache((out, *cache), (jout, *jcache))


@pytest.mark.parametrize("randomised", [False, True])
def test_mamba2_layer_decode(pair, randomised):
    jmodel, jparams, cfg, model = pair
    if randomised:
        jparams = _randomised(jparams, 6)
        model = _load(jparams, cfg)
    x = _x(3, cfg, S=1)
    tc, jc = _layer_cache(4, cfg)
    before = [t.clone() for t in tc]
    out, cache = mamba2.mamba2_layer_decode(model.layers[0], torch.from_numpy(x), cfg, tc)
    jout, jcache = jmamba2.mamba2_layer_decode(_lp(jparams, 0), jnp.asarray(x), jmodel.cfg, jc)
    _close_cache((out, *cache), (jout, *jcache))
    assert all(torch.equal(a, b) for a, b in zip(tc, before))       # the cache is only read


# ---------------------------------------------------------------------------
# the model facade
# ---------------------------------------------------------------------------


def test_convert_loads_strict(pair):
    jmodel, jparams, cfg, model = pair
    state = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert set(state) == set(Model(cfg, device="cpu").state_dict())
    for name in ("A_log", "D", "dt_bias"):
        assert state[f"layers.0.{name}"].dtype == torch.float32
    np.testing.assert_array_equal(state["lm_head"].numpy(), np.asarray(jparams["lm_head"]))
    np.testing.assert_array_equal(state["layers.3.in_proj"].numpy(),
                                  np.asarray(jparams["layers"]["in_proj"][3]))
    at, mlp = jparams["shared"]["attn"], jparams["shared"]["mlp"]
    np.testing.assert_array_equal(
        state["shared.attn.wqkv"].numpy(),
        np.concatenate([np.asarray(at[k]) for k in ("wq", "wk", "wv")], -1))
    np.testing.assert_array_equal(
        state["shared.w_gu"].numpy(),
        np.concatenate([np.asarray(mlp[k]) for k in ("w_gate", "w_up")], -1))
    fresh = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError):               # strict: a missing key is refused
        fresh.load_state_dict({k: v for k, v in state.items() if k != "shared.ln2"})


def test_seeded_init_matches_the_jax_distributions():
    cfg = get_config("zamba2-2.7b").reduce()
    model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
    layer = model.layers[0]
    assert bool((layer.A_log == 0).all() and (layer.dt_bias == 0).all() and (layer.D == 1).all())
    assert bool((layer.conv_b == 0).all() and (layer.out_norm == 1).all())
    d = cfg.d_model
    assert abs(float(layer.in_proj.std()) * d ** 0.5 - 1.0) < 0.05
    assert abs(float(layer.conv_w.std()) / 0.5 - 1.0) < 0.1
    assert abs(float(model.shared.w_gu.std()) * d ** 0.5 - 1.0) < 0.05
    assert abs(float(model.lm_head.std()) * d ** 0.5 - 1.0) < 0.05
    again = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def _prefill_both(jmodel, jparams, model, toks):
    jl, jc = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks)})
    tl, tc = model.prefill(torch.from_numpy(toks))
    return (tl, tc), (jl, jc)


def _prefill_decode_vs_jax(jmodel, jparams, model, cfg, S, steps, seed):
    """A B=2 prefill, its cache padded into a max_len buffer, then decode
    steps at per-slot lengths (the cache updated in place) against JAX's."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S))
    (tl, tc), (jl, jc) = _prefill_both(jmodel, jparams, model, toks)
    G = cfg.n_layers // cfg.attention_every
    assert tl.shape == (2, cfg.vocab_size) and isinstance(tc, Zamba2Cache)
    assert tc.attn_k.shape == (G, 2, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _close_cache(tc, jc)
    max_len = S + steps + 3
    buf = model.empty_cache(2, max_len)
    for b, c in zip(buf, tc):
        b[tuple(slice(0, n) for n in c.shape)] = c
    jbuf = jmodel.empty_cache(2, max_len)
    jbuf = jax.tree.map(lambda b, c: b.at[tuple(slice(0, n) for n in c.shape)].set(c), jbuf, jc)
    decode = jax.jit(jmodel.decode)
    rng = np.random.default_rng(seed + 1)
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        lens = np.array([S + i, S + i], np.int32)
        jl, jbuf = decode(jparams, jnp.asarray(tok), jbuf, jnp.asarray(lens))
        tl = model.decode(torch.from_numpy(tok), buf, torch.from_numpy(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
        _close_cache(buf, jbuf)


@pytest.mark.parametrize("S", [16, 100])
def test_prefill_and_decode_match_jax(pair, S):
    jmodel, jparams, cfg, model = pair
    _prefill_decode_vs_jax(jmodel, jparams, model, cfg, S, 3, S)


def test_prefill_and_decode_match_jax_with_random_decay_dt_and_skip(pair):
    jmodel, jparams, cfg, _ = pair
    jp = _randomised(jparams, 9)
    _prefill_decode_vs_jax(jmodel, jp, _load(jp, cfg), cfg, 64, 2, 40)


def test_prefill_matches_jax_through_pallas(pair):
    """The JAX model with ``use_pallas``: the same function through the
    interpret-mode SSD and flash-attention kernels, at S=64."""
    jmodel, jparams, cfg, model = pair
    jm = JaxModel(dataclasses.replace(jmodel.cfg, use_pallas=True))
    toks = np.random.default_rng(64).integers(0, cfg.vocab_size, (2, 64))
    (tl, tc), (jl, jc) = _prefill_both(jm, jparams, model, toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _close_cache(tc, jc)


@pytest.mark.parametrize("S", [32, 200])
def test_decode_after_prefill_equals_longer_prefill(pair, S):
    """The port against itself, as ``tests/test_serve_consistency.py`` holds
    JAX: decode of token S after prefill(S) is prefill(S + 1).  S = 200 is
    a length the JAX prefill refuses."""
    *_, cfg, model = pair
    toks = torch.from_numpy(np.random.default_rng(S + 2).integers(0, cfg.vocab_size, (2, S + 1)))
    _, cache = model.prefill(toks[:, :S])
    buf = model.empty_cache(2, S + 1)
    for b, c in zip(buf, cache):
        b[tuple(slice(0, n) for n in c.shape)] = c
    step = model.decode(toks[:, S:], buf, torch.full((2,), S))
    full, full_cache = model.prefill(toks)
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=2e-4, rtol=1e-4)
    _close_cache(buf, full_cache, atol=2e-4)


def test_options_the_family_refuses(pair):
    """No mixed step and no paged KV for hybrid, in the port as in JAX."""
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


# ---------------------------------------------------------------------------
# the engine: generate, the session in lockstep with JAX, the client
# ---------------------------------------------------------------------------


def _ecfg(cls, **kw):
    base = dict(max_len=48, decode_batch=2, temperature=0.0, decode_chunk=4)
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
    """The JAX legacy session (``mixed_step=False``) and the port's at the
    default ``mixed_step=True``, which the engine turns into legacy
    admission for hybrid, as JAX does."""
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
    """Request 0 mid-flight when requests 1 and 2 arrive."""
    js, ts = _sessions(pair)
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, pair[2].vocab_size, (1, p)), n) for p, n in [(8, 5), (13, 7), (8, 4)]]
    for s in (js, ts):
        s.submit(0, *reqs[0])
    _pump_both(js, ts)
    # the admitted slot's leaves agree with JAX after a chunk (its KV at [0, len))
    n = int(ts._lens_host[0])
    _close_cache([leaf[:, 0] for leaf in ts.cache[:2]], [leaf[:, 0] for leaf in js.cache[:2]])
    _close_cache([leaf[:, 0, :n] for leaf in ts.cache[2:]],
                 [leaf[:, 0, :n] for leaf in js.cache[2:]])
    for s in (js, ts):
        s.submit(1, *reqs[1])
        s.submit(2, *reqs[2])
    _drain_both(js, ts)
    assert ts.eng.telemetry.prefills == 3


def test_session_reuses_slots_lockstep_with_jax(pair):
    """Six requests through two slots: each admission must replace the conv
    tails and states of its slot whole and its KV over [0, S), which the
    idle decode steps fill with garbage in between."""
    js, ts = _sessions(pair)
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, pair[2].vocab_size, (1, p)), n)
            for p, n in [(12, 5), (8, 9), (20, 3), (8, 7), (12, 4), (30, 6)]]
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
    """``EngineClient`` over a hybrid session: a cancelled stream frees its
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
    solo = QueueSession(ServingEngine(model, EngineConfig(max_len=32, decode_batch=1,
                                                          decode_chunk=2), device="cpu"))
    solo.submit(0, np.arange(6)[None] + 1, 3)
    while not solo.idle:
        solo.pump()
    np.testing.assert_array_equal(solo.results[0], b.result())
