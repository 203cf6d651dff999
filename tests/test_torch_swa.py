"""The port's sliding-window attention (mixtral-8x22b ``reduce()``: window
64, fp32, CPU) against the JAX package and against itself.

* ``attention.ring_rows`` and the prefill: logits equal JAX's at S below,
  at and past the window (the windowed flash kernel's plain version
  against JAX's windowed ``chunked_attention``); the prompt cache is
  JAX's last-W slice rolled so that position p sits at row p % W, which is
  JAX's own slice whenever S <= W or S % W == 0.
* The ring decode: after ``prefill(S)`` placed into ``empty_cache`` (the
  ring of min(max_len, W) rows) a decode step equals the port's own
  ``prefill(S + 1)`` within 2e-4 at S in {32, 64, 70, 128, 200}, and JAX's
  decode at the aligned S in {32, 64, 128}.  At S = 70 JAX's decode is off
  by far more (its prefill keeps the last W keys at rows 0..W-1 and its
  decode then writes at S % W, overwriting a key inside the window).  These
  run at capacity factor 16, where no expert overflows, since prefill(S +
  1) and a decode step route different token sets.
* Serving: ``generate`` and the legacy ``QueueSession`` (the window has
  no mixed step) token-exact with JAX, pump by pump, at max_len 128 with
  prompts of 8-60 tokens and 48 new each, so decode wraps the ring, at the
  default capacity factor; and the port's session with prompts past the
  window against greedy decoding by repeated full prefills.
"""
import dataclasses

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

ARCH = "mixtral-8x22b"
W = 64
ATOL = 2e-5


@pytest.fixture(scope="module")
def pairs():
    """capacity factor -> (jax model, jax params, port model)."""
    built = {}

    def get(cf=1.25):
        if cf not in built:
            jcfg = dataclasses.replace(jax_get_config(ARCH).reduce(), capacity_factor=cf)
            cfg = dataclasses.replace(get_config(ARCH).reduce(), capacity_factor=cf)
            assert cfg.sliding_window == jcfg.sliding_window == W
            jmodel = JaxModel(jcfg)
            jparams = jmodel.init(jax.random.key(0))
            model = Model(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
            built[cf] = (jmodel, jparams, model)
        return built[cf]

    return get


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 130])
def test_ring_rows_rolls_the_last_window(S):
    kv = torch.arange(2 * S, dtype=torch.float32).reshape(2, S, 1, 1)
    ring = attention.ring_rows(kv, W)
    assert ring.shape[1] == min(S, W)
    for p in range(max(0, S - W), S):
        assert torch.equal(ring[:, p % W], kv[:, p]), p
    if S <= W or S % W == 0:
        assert torch.equal(ring, kv[:, -W:])
    assert attention.ring_rows(kv, 0) is kv


@pytest.mark.parametrize("S", [40, 64, 70, 128, 200])
def test_prefill_matches_jax_below_at_and_past_the_window(pairs, S):
    jmodel, jparams, model = pairs()
    toks = _tokens(model.cfg, 2, S, seed=S)
    jl, jc = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks)})
    tl, tc = model.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    assert tc.k.shape[2] == jc.k.shape[2] == min(S, W)
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        want = np.roll(np.asarray(j), S % W if S > W else 0, axis=2)
        np.testing.assert_allclose(t.numpy(), want, atol=ATOL)


def test_empty_cache_is_the_ring(pairs):
    jmodel, _, model = pairs()
    for max_len in (32, 64, 256):
        assert model.empty_cache(2, max_len).k.shape[2] == min(max_len, W)
        assert jmodel.empty_cache(2, max_len).k.shape[2] == min(max_len, W)


def _decode_after_prefill(model, toks, S, max_len):
    """Port: prefill the first S tokens, place the ring into an empty cache
    at offset 0 (as ``ServingEngine._place_slot`` does), decode token S."""
    _, pc = model.prefill(torch.from_numpy(toks[:, :S]).long())
    cache = model.empty_cache(toks.shape[0], max_len)
    n = pc.k.shape[2]
    cache.k[:, :, :n] = pc.k
    cache.v[:, :, :n] = pc.v
    lens = torch.full((toks.shape[0],), S, dtype=torch.int32)
    return model.decode(torch.from_numpy(toks[:, S:S + 1]).long(), cache, lens)


def _jax_decode_after_prefill(jmodel, jparams, toks, S, max_len):
    """JAX, placed as ``tests/test_decode_fastpath.py`` places it."""
    _, pc = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks[:, :S])})
    buf = jmodel.empty_cache(toks.shape[0], max_len)
    sc = min(pc.k.shape[2], buf.k.shape[2])
    cache = type(pc)(k=buf.k.at[:, :, :sc].set(pc.k[:, :, :sc]),
                     v=buf.v.at[:, :, :sc].set(pc.v[:, :, :sc]))
    out, _ = jax.jit(jmodel.decode)(jparams, jnp.asarray(toks[:, S:S + 1]), cache,
                                    jnp.int32(S))
    return np.asarray(out)


@pytest.mark.parametrize("S", [32, 64, 70, 128, 200])
def test_ring_decode_equals_prefill_of_one_more(pairs, S):
    jmodel, jparams, model = pairs(16.0)
    max_len = 256
    toks = _tokens(model.cfg, 2, S + 1, seed=100 + S)
    full, _ = model.prefill(torch.from_numpy(toks).long())
    dec = _decode_after_prefill(model, toks, S, max_len)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4, rtol=0)
    jdec = _jax_decode_after_prefill(jmodel, jparams, toks, S, max_len)
    if S < W or S % W == 0:
        np.testing.assert_allclose(dec.numpy(), jdec, atol=ATOL, rtol=1e-4)
    else:
        # the reference's placement fault: its decode is not its prefill(S + 1)
        jfull, _ = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks)})
        assert float(np.abs(jdec - np.asarray(jfull)).max()) > 0.1
        np.testing.assert_allclose(np.asarray(jfull), full.numpy(), atol=ATOL, rtol=1e-4)


def test_ring_decode_steps_wrap_with_jax(pairs):
    """Decode steps from S = 40 across the ring's wrap at 64, both packages
    stepping the same tokens at per-slot lengths: logits and rings equal."""
    jmodel, jparams, model = pairs()
    B, S, steps, max_len = 2, 40, 36, 128
    toks = _tokens(model.cfg, B, S + steps, seed=7)
    _, jpc = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks[:, :S])})
    _, tpc = model.prefill(torch.from_numpy(toks[:, :S]).long())
    jc, tc = jmodel.empty_cache(B, max_len), model.empty_cache(B, max_len)
    jc = jc._replace(k=jc.k.at[:, :, :S].set(jpc.k), v=jc.v.at[:, :, :S].set(jpc.v))
    tc.k[:, :, :S] = tpc.k
    tc.v[:, :, :S] = tpc.v
    dec = jax.jit(jmodel.decode)
    for i in range(steps):
        lens = np.full(B, S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = dec(jparams, jnp.asarray(tok), jc, jnp.asarray(lens))
        tl = model.decode(torch.from_numpy(tok).long(), tc, torch.from_numpy(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "prefill_chunks",
                 "mixed_steps", "useful_tokens", "wasted_tokens", "prefilled_tokens")


def _ecfg(cls, **kw):
    base = dict(max_len=128, decode_batch=3, temperature=0.0, decode_chunk=8, prefill_chunk=8)
    base.update(kw)
    return cls(**base)


def test_generate_wraps_the_ring_token_exact_with_jax(pairs):
    jmodel, jparams, model = pairs()
    toks = _tokens(model.cfg, 2, 40, seed=3)
    want = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig)).generate(
        {"inputs": toks}, 48, 40)
    got = ServingEngine(model, _ecfg(EngineConfig), device="cpu").generate(
        {"inputs": toks}, 48, 40)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_legacy_session_wraps_the_ring_token_exact_with_jax(pairs):
    """Seven requests of 8-60 prompt tokens and 48 new each through 3
    slots: every stream decodes past the ring's 64 rows.  The default
    ``mixed_step=True`` takes legacy admission, in both packages, as
    ``mixed_step=False`` does."""
    jmodel, jparams, model = pairs()
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig))
    teng = ServingEngine(model, _ecfg(EngineConfig), device="cpu")
    assert teng.cfg.mixed_step and not teng.mixed
    assert not ServingEngine(model, _ecfg(EngineConfig, mixed_step=False), device="cpu").mixed
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, model.cfg.vocab_size, int(n)).astype(np.int32)[None], 48)
            for n in np.linspace(8, 60, 7).round()]
    js, ts = jeng.new_session(), teng.new_session()
    for rid, (p, n) in enumerate(reqs):
        js.submit(rid, p, n)
        ts.submit(rid, p, n)
    pumps = 0
    while not (js.idle and ts.idle):
        jr, tr = js.pump(), ts.pump()
        pumps += 1
        for f in REPORT_FIELDS:
            assert getattr(tr, f) == getattr(jr, f), (f, pumps)
        for rid in jr.completed:
            np.testing.assert_array_equal(tr.completed[rid], jr.completed[rid])
    assert sorted(ts.results) == sorted(js.results) == list(range(7))
    for rid in js.results:
        np.testing.assert_array_equal(ts.results[rid], js.results[rid])


def test_session_with_prompts_past_the_window_is_greedy(pairs):
    """Prompts of 70, 100 and 131 tokens (past W, unaligned) at max_len 160:
    each stream equals greedy decoding by a full prefill per token
    (capacity factor 16: no expert overflows in either)."""
    _, _, model = pairs(16.0)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32) for n in (70, 100, 131)]
    new = 6
    sess = ServingEngine(model, _ecfg(EngineConfig, max_len=160), device="cpu").new_session()
    for rid, p in enumerate(prompts):
        sess.submit(rid, p[None], new)
    while not sess.idle:
        sess.pump()
    for rid, p in enumerate(prompts):
        seq = list(p)
        for _ in range(new):
            logits, _ = model.prefill(torch.tensor([seq]).long())
            seq.append(int(logits[0].argmax()))
        np.testing.assert_array_equal(sess.results[rid], seq[len(p):])
