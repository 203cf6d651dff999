"""The port's layers against ``repro.models`` on the same numpy inputs (fp32, CPU).

Tolerance: atol 1e-5 / rtol 1e-5 for the elementwise layers, 1e-4 for the
projection (a matmul summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.models import attention, layers

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _np(rng, 3, 5, 64), _np(rng, 64)
    np.testing.assert_allclose(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)


def test_rms_norm_bf16_casts_back():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    assert layers.rms_norm(x, torch.ones(8, dtype=torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 7, 3, 32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rope_frequencies(32, theta).numpy(), np.asarray(jlayers.rope_frequencies(32, theta)),
        rtol=1e-6)
    out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # angles reach ~4000 rad: sin/cos of fp32 arguments round differently
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_swiglu_fused():
    rng = np.random.default_rng(2)
    x, wg, wu, wd = _np(rng, 2, 4, 32), _np(rng, 32, 48), _np(rng, 32, 48), _np(rng, 48, 32)
    w_gu = layers.fuse_gate_up_weights(torch.from_numpy(wg), torch.from_numpy(wu))
    out = layers.swiglu_fused(torch.from_numpy(x), w_gu, torch.from_numpy(wd))
    ref = jlayers.swiglu_fused(jnp.asarray(x), jlayers.fuse_gate_up_weights(
        jnp.asarray(wg), jnp.asarray(wu)), jnp.asarray(wd))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_project_qkv_fused():
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    cfg = get_config("qwen3-0.6b").reduce()
    p = jax.tree.map(np.asarray, jattn.init_attn_params(jax.random.key(3), jcfg, jnp.float32))
    rng = np.random.default_rng(3)
    p["q_norm"] = 1.0 + 0.1 * _np(rng, cfg.resolved_head_dim)
    p["k_norm"] = 1.0 + 0.1 * _np(rng, cfg.resolved_head_dim)
    x = _np(rng, 2, 5, cfg.d_model)
    pos = rng.integers(0, 60, (2, 5)).astype(np.int32)
    jq, jk, jv = jattn._project_qkv(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                                    jnp.asarray(pos), fused=True)
    mod = attention.Attention(cfg, device="cpu", dtype=torch.float32)
    t = {k: torch.tensor(v) for k, v in p.items()}
    with torch.no_grad():
        mod.wqkv.copy_(attention.fuse_qkv_weights(t["wq"], t["wk"], t["wv"]))
        mod.wo.copy_(t["wo"])
        mod.qk_norm.copy_(attention.fuse_qk_norm(t["q_norm"], t["k_norm"], cfg.n_heads,
                                                 cfg.n_kv_heads))
    q, k, v = attention._project_qkv(mod, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    for a, b in ((q, jq), (k, jk), (v, jv)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_mixed_write_index_matches_positional_select():
    """Only rows i < new_lens[b] land, at cache_lens[b] + i, and never past S."""
    cache_lens, new_lens, Q, S = np.array([0, 5, 14]), np.array([3, 0, 4]), 4, 16
    src, dst = attention.mixed_write_index(cache_lens, new_lens, Q, S)
    got = sorted(zip(src.tolist(), dst.tolist()))
    want = [(0, 0), (1, 1), (2, 2), (2 * Q + 0, 2 * S + 14), (2 * Q + 1, 2 * S + 15)]
    assert got == want
