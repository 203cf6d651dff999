"""The port's training loss and its gradients against the JAX package (CPU, fp32).

* ``Model.loss`` and the gradient of every JAX leaf (read through
  ``convert.leaf_view``: a fused port tensor's slice, the sum of the
  per-head ``qk_norm`` rows for ``q_norm``/``k_norm``) against
  ``jax.value_and_grad`` of JAX's ``Model.loss`` with ``use_pallas=True``
  (the Pallas kernels in interpret mode, as ``test_pallas_integration.py``
  runs them), for qwen3-0.6b, rwkv6-7b and zamba2-2.7b (``reduce()``,
  B=2, S=64).  Tolerance per element: rtol 1e-3 and atol 1e-5, the atol
  scaled by max|g|/0.1 in a leaf whose largest gradient is above 0.1.
  Only zamba2's embedding is such a leaf (its gradients reach 0.96: the
  first norm divides 0.02-scale embeddings by their RMS), and there both
  packages are about 1.9e-5 away from a run of the port with float64
  weights and matmuls, so fp32 noise alone exceeds a flat 1e-5.
* The loss and the global gradient norm of llava-next-mistral-7b (8
  patches ahead of 56 text tokens), hubert-xlarge (``embeds`` and a
  ``mask``) and arctic-480b (MoE with a dense residual; ``moe_aux`` too)
  at rtol 1e-5 (loss) and 1e-4 (norm).
* Each kernel's ``autograd.Function`` (its backward the plain version's
  autograd, recomputed) against ``jax.vjp`` of the JAX ``ops`` function
  with random cotangents: flash attention at G 1 and 2, causal,
  non-causal and windowed; WKV6 and SSD from a random state, at the
  model's decay and a strong one (gradients finite); RMSNorm in both forms
  against ``jax.vjp`` of ``layers.rms_norm`` (the fused form as ``x +
  r`` then the norm).  The JAX ``ssd_chunked`` backward is NaN once a
  chunk's log-decay sums below about -88 (its exponents above the
  diagonal overflow fp32 before its mask, and 0·inf is NaN): at the
  model's decay (A about -1, dt about 1) that is already a 128-token
  chunk.  So the SSD is held to JAX's ``ops.ssd`` over one 64-token chunk,
  and at a strong decay over 128 tokens, where the JAX backward is NaN,
  to ``jax.vjp`` of the exact recurrence ``ssd_ref``.  Tolerance: atol 2e-5, rtol 1e-3
  (the scans at atol 5e-4, rtol 1e-3, as their forward tests).
* The flash backward's query chunks: ``flash_attention_vjp`` at a
  32-query chunk equals the one-chunk result (causal, windowed, non-causal
  and Sk > Sq).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import ops as jflash
from repro.kernels.rwkv6_scan import ops as jwkv
from repro.kernels.ssd_scan import ops as jssd
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import Model as JaxModel
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import Model
from repro_torch.training import optimizer as opt

B, S = 2, 64
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
FN_TOL = dict(atol=2e-5, rtol=1e-3)
SCAN_TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small models: one intra-op thread runs them faster than a pool, and
    keeps this file from oversubscribing the cores that parallel test
    workers share.  Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaf_atol(a: np.ndarray) -> float:
    return GRAD_TOL["atol"] * max(1.0, float(np.abs(a).max()) / 0.1)


def _pair(arch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduce(), use_pallas=True)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config(arch).reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, cfg, model.train_()


def _batch(cfg, rng, n_patches=0):
    if cfg.family == "encoder":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                "mask": (rng.random((B, S)) < 0.3).astype(np.float32)}
    s_text = S - n_patches
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32)}
    if n_patches:
        batch["patches"] = rng.standard_normal((B, n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _both(arch, n_patches=0):
    """JAX's and the port's (loss, metrics, per-leaf gradients) on one batch."""
    jmodel, jparams, cfg, model = _pair(arch)
    batch = _batch(cfg, np.random.default_rng(0), n_patches)
    (jl, jm), jg = jax.value_and_grad(lambda p: jmodel.loss(p, batch), has_aux=True)(jparams)
    loss, met = model.loss(batch)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    view = convert.leaf_view(cfg)
    jleaves = convert.unstack_leaves(view, jax.tree.map(np.asarray, jg))
    pleaves = [convert.leaf_grad(grads, leaf).numpy() for leaf in view]
    return (float(jl), {k: float(v) for k, v in jm.items()}, jleaves,
            float(loss.detach()), {k: float(v.detach()) for k, v in met.items()}, pleaves, view)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b", "zamba2-2.7b"])
def test_loss_and_every_gradient_leaf_match_jax(arch):
    jl, jm, jleaves, loss, met, pleaves, view = _both(arch)
    np.testing.assert_allclose(loss, jl, rtol=1e-6)
    np.testing.assert_allclose(met["ce"], jm["ce"], rtol=1e-6)
    assert met["moe_aux"] == 0.0 == jm["moe_aux"]
    for leaf, a, b in zip(view, jleaves, pleaves):
        assert b.shape == a.shape, leaf.key
        np.testing.assert_allclose(b, a, rtol=GRAD_TOL["rtol"], atol=_leaf_atol(a),
                                   err_msg=leaf.key)
    # every JAX leaf is in the view once
    jg_paths = {"/".join(str(k.key) for k in p)
                for p, _ in jax.tree_util.tree_flatten_with_path(
                    _pair(arch)[1])[0]}
    assert {leaf.path for leaf in view} == jg_paths


@pytest.mark.parametrize("arch,n_patches", [("llava-next-mistral-7b", 8), ("hubert-xlarge", 0),
                                            ("arctic-480b", 0)])
def test_loss_and_grad_norm_match_jax(arch, n_patches):
    jl, jm, jleaves, loss, met, pleaves, view = _both(arch, n_patches)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    np.testing.assert_allclose(met["moe_aux"], jm["moe_aux"], rtol=1e-5, atol=1e-7)
    if arch == "arctic-480b":
        assert met["moe_aux"] > 0.5
    jn = float(np.sqrt(sum(np.sum(np.square(a, dtype=np.float64)) for a in jleaves)))
    pn = float(opt.global_norm([torch.from_numpy(b) for b in pleaves]))
    np.testing.assert_allclose(pn, jn, rtol=1e-4)


# ---------------------------------------------------------------------------
# each kernel's autograd.Function against jax.vjp
# ---------------------------------------------------------------------------


def _t(*arrays, grad=True):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad) for a in arrays]


def _vjp_both(jfn, tfn, arrays, cots, tol):
    outs, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1 else jnp.asarray(cots[0]))
    ts = _t(*arrays)
    touts = tfn(*ts)
    touts = touts if isinstance(touts, tuple) else (touts,)
    tgrads = torch.autograd.grad(touts, ts, [torch.from_numpy(c) for c in cots])
    for i, (a, b) in enumerate(zip(jgrads, tgrads)):
        b = b.numpy()
        assert np.isfinite(b).all(), i
        np.testing.assert_allclose(b, np.asarray(a), err_msg=f"input {i}", **tol)
    return tgrads


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_flash_attention_function_matches_jax_vjp(G, causal, window):
    rng = np.random.default_rng(10 * G + window)
    Hkv, D, Sx = 2, 32, 128
    q = rng.standard_normal((B, Sx, Hkv * G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sx, Hkv, D)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    _vjp_both(lambda q, k, v: jflash.flash_attention(q, k, v, causal=causal, window=window,
                                                     block_q=64, block_k=64),
              lambda q, k, v: flash_ops.flash_attention(q, k, v, causal=causal, window=window),
              (q, k, v), (g,), FN_TOL)


@pytest.mark.parametrize("causal,window,Sq,Sk", [(True, 0, 100, 100), (True, 40, 100, 100),
                                                 (False, 0, 100, 100), (True, 0, 50, 120)])
def test_flash_backward_query_chunks(causal, window, Sq, Sk):
    gen = torch.Generator().manual_seed(Sq + window)
    q = torch.randn((2, Sq, 4, 32), generator=gen)
    k, v = (torch.randn((2, Sk, 2, 32), generator=gen) for _ in range(2))
    g = torch.randn(q.shape, generator=gen)
    whole = flash_ref.flash_attention_vjp(q, k, v, g, causal=causal, window=window)
    chunked = flash_ref.flash_attention_vjp(q, k, v, g, causal=causal, window=window, q_chunk=32)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)


def _wkv_inputs(rng, Sx, mu):
    H, N = 2, 32
    r, k, v = (rng.standard_normal((B, Sx, H, N)).astype(np.float32) for _ in range(3))
    logw = -np.exp(mu + 0.5 * rng.standard_normal((B, Sx, H, N))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("mu", [-2.0, 3.0])
def test_wkv6_function_matches_jax_vjp(mu):
    rng = np.random.default_rng(5)
    arrays = _wkv_inputs(rng, 128, mu)
    y, st = wkv_ops.wkv6(*_t(*arrays, grad=False))
    cots = (rng.standard_normal(y.shape).astype(np.float32),
            rng.standard_normal(st.shape).astype(np.float32))
    _vjp_both(lambda *a: jwkv.wkv6(*a, chunk=64), wkv_ops.wkv6, arrays, cots, SCAN_TOL)


def _ssd_inputs(rng, Sx, mu):
    H, P, N = 2, 32, 16
    x = rng.standard_normal((B, Sx, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, Sx, H)))).astype(np.float32)
    z = rng.standard_normal((H,))
    A = (-np.exp(mu + 0.5 * z) if mu is not None else -np.exp(0.3 * z)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, Sx, N)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("mu", [None, 3.0])
def test_ssd_function_matches_jax_vjp(mu):
    rng = np.random.default_rng(6)
    arrays = _ssd_inputs(rng, 64 if mu is None else 128, mu)
    y, st = ssd_ops.ssd(*_t(*arrays, grad=False))
    cots = (rng.standard_normal(y.shape).astype(np.float32),
            rng.standard_normal(st.shape).astype(np.float32))
    jcots = tuple(jnp.asarray(c) for c in cots)
    _, jvjp = jax.vjp(lambda *a: jssd.ssd(*a, chunk=128), *[jnp.asarray(a) for a in arrays])
    chunked_finite = all(bool(jnp.isfinite(g).all()) for g in jvjp(jcots))
    if mu is None:
        assert chunked_finite
        _vjp_both(lambda *a: jssd.ssd(*a, chunk=128), ssd_ops.ssd, arrays, cots, SCAN_TOL)
    else:
        # the JAX chunk form's backward overflows here; the port's stays finite
        assert not chunked_finite
        _vjp_both(jax_ssd_ref, ssd_ops.ssd, arrays, cots, SCAN_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_rmsnorm_function_matches_jax_vjp(fused):
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((3, 5, 256))).astype(np.float32)
    w = rng.standard_normal((256,)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    if not fused:
        _vjp_both(lambda x, w: jlayers.rms_norm(x, w, 1e-6),
                  lambda x, w: norm_ops.rms_norm(x, w, 1e-6), (x, w), (g,), FN_TOL)
        return
    r = rng.standard_normal(x.shape).astype(np.float32)
    g2 = rng.standard_normal(x.shape).astype(np.float32)

    def jfused(x, w, r):
        s = x + r
        return jlayers.rms_norm(s, w, 1e-6), s

    _vjp_both(jfused, lambda x, w, r: norm_ops.rmsnorm(x, w, r, eps=1e-6), (x, w, r),
              (g, g2), FN_TOL)


def test_serving_calls_record_no_graph():
    """Under no_grad (every serving method) the ops call their kernel or
    plain version directly: no autograd node, even on parameters that
    require gradients."""
    x = torch.randn((2, 8, 64), requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    with torch.no_grad():
        assert norm_ops.rms_norm(x, w).grad_fn is None
        q = torch.randn((1, 8, 2, 32), requires_grad=True)
        assert flash_ops.flash_attention(q, q, q).grad_fn is None
    assert norm_ops.rms_norm(x, w).grad_fn is not None


def test_hybrid_gradients_stay_finite_past_a_128_token_chunk():
    """At S=256 the JAX hybrid's gradients are NaN (its ``ssd_chunked``
    overflows before its mask: 0·inf in the backward, a 128-token chunk at
    the model's decay); the port's are finite, and its loss is JAX's."""
    jmodel, jparams, cfg, model = _pair("zamba2-2.7b")
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, 256)).astype(np.int32)
             for k in ("inputs", "targets")}
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss(p, batch)[0])(jparams)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jg))
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
