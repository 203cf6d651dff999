"""The port's model against the JAX model on qwen3-0.6b.reduce() (fp32, CPU).

Weights come from the JAX ``Model.init`` and cross through numpy
(``repro_torch.convert.params_from_jax``).  Logits and KV caches must
match at atol 1e-4 (fp32; the two frameworks sum in different orders).
Also: the import boundary of the port, and no silent CPU fallback.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import DecoderKVCache, Model
from repro_torch.serving import EngineConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jmodel, jparams, cfg, model


def test_config_matches_reference():
    for reduce in (False, True):
        a, b = jax_get_config("qwen3-0.6b"), get_config("qwen3-0.6b")
        if reduce:
            a, b = a.reduce(), b.reduce()
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "resolved_head_dim",
                  "d_ff", "vocab_size", "qk_norm", "rope_theta", "tie_embeddings",
                  "dtype", "norm_eps", "q_dim", "kv_dim"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.param_count() == b.param_count()


def test_params_from_jax_round_trips(pair):
    jcfg, _, jparams, cfg, model = pair
    jp = jax.tree.map(np.asarray, jparams)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["embed"].numpy(), jp["embed"])
    qd, kvd, f = cfg.q_dim, cfg.kv_dim, cfg.d_ff
    for li in range(cfg.n_layers):
        pre = f"layers.{li}."
        wqkv = sd[pre + "attn.wqkv"].numpy()
        at, mlp = jp["layers"]["attn"], jp["layers"]["mlp"]
        np.testing.assert_array_equal(wqkv[:, :qd], at["wq"][li])
        np.testing.assert_array_equal(wqkv[:, qd:qd + kvd], at["wk"][li])
        np.testing.assert_array_equal(wqkv[:, qd + kvd:], at["wv"][li])
        np.testing.assert_array_equal(sd[pre + "attn.wo"].numpy(), at["wo"][li])
        qkn = sd[pre + "attn.qk_norm"].numpy()
        np.testing.assert_array_equal(qkn[:cfg.n_heads], np.broadcast_to(
            at["q_norm"][li], (cfg.n_heads, cfg.resolved_head_dim)))
        np.testing.assert_array_equal(qkn[cfg.n_heads:], np.broadcast_to(
            at["k_norm"][li], (cfg.n_kv_heads, cfg.resolved_head_dim)))
        wgu = sd[pre + "w_gu"].numpy()
        np.testing.assert_array_equal(wgu[:, :f], mlp["w_gate"][li])
        np.testing.assert_array_equal(wgu[:, f:], mlp["w_up"][li])
        np.testing.assert_array_equal(sd[pre + "w_down"].numpy(), mlp["w_down"][li])
        np.testing.assert_array_equal(sd[pre + "ln1"].numpy(), jp["layers"]["ln1"][li])


def _caches(jmodel, model, B, S):
    jc = jmodel.empty_cache(B, S)
    return jc, model.empty_cache(B, S)


def _fill(rng, jc, tc):
    """Same random prefix KV in both caches."""
    k = rng.standard_normal(jc.k.shape).astype(np.float32)
    v = rng.standard_normal(jc.v.shape).astype(np.float32)
    tc.k.copy_(torch.from_numpy(k))
    tc.v.copy_(torch.from_numpy(v))
    return jc._replace(k=jnp.asarray(k), v=jnp.asarray(v))


@pytest.mark.parametrize("all_logits", [False, True])
def test_step_mixed_matches_jax(pair, all_logits):
    jcfg, jmodel, jparams, cfg, model = pair
    rng = np.random.default_rng(0)
    B, S, Q = 3, 64, 8
    jc, tc = _caches(jmodel, model, B, S)
    jc = _fill(rng, jc, tc)
    tokens = rng.integers(0, cfg.vocab_size, (B, Q)).astype(np.int32)
    cache_lens = np.array([0, 17, S - 5], np.int32)   # the last row's tail runs past S
    new_lens = np.array([8, 1, 5], np.int32)
    aw = 64
    jl, jc2 = jmodel.step_mixed(jparams, jnp.asarray(tokens), jc, jnp.asarray(cache_lens),
                                jnp.asarray(new_lens), attn_window=aw, all_logits=all_logits)
    tl = model.step_mixed(torch.from_numpy(tokens).long(), tc, cache_lens, new_lens,
                          attn_window=aw, all_logits=all_logits)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc2.k), atol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc2.v), atol=ATOL)


@pytest.mark.parametrize("S", [64, 2048])
def test_decode_matches_jax(pair, S):
    """S=2048 takes the split-K plain version (auto_k_splits(2048) = 4)."""
    jcfg, jmodel, jparams, cfg, model = pair
    rng = np.random.default_rng(1)
    B = 3
    jc, tc = _caches(jmodel, model, B, S)
    jc = _fill(rng, jc, tc)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    lens = np.array([0, 13, S - 1], np.int32)
    jl, jc2 = jmodel.decode(jparams, jnp.asarray(tokens), jc, jnp.asarray(lens))
    tl = model.decode(torch.from_numpy(tokens).long(), tc, torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc2.k), atol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc2.v), atol=ATOL)


def test_seeded_init_is_deterministic():
    cfg = get_config("qwen3-0.6b").reduce()
    a = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(7))
    b = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(7))
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    w = a.layers[0].attn.wqkv
    assert abs(float(w.std()) - 1.0 / np.sqrt(cfg.d_model)) < 0.01
    cache = a.empty_cache(2, 16)
    assert isinstance(cache, DecoderKVCache)
    assert cache.k.shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_no_silent_cpu():
    """Entry points default to the card; without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config("qwen3-0.6b").reduce()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, EngineConfig(max_len=64))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "attention_timing.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"
