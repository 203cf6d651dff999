"""The port's dense-family breadth against the JAX model (``reduce()`` fp32, CPU):
qwen3-4b (tied, SwiGLU), starcoder2-15b (GELU MLP, untied), llama3-405b
(untied), llava-next-mistral-7b (vlm: patch embeddings ahead of the text)
and hubert-xlarge (encoder: embeds input, non-causal, a ``head``, no decode).

Weights come from the JAX ``Model.init`` and cross through numpy
(``repro_torch.convert.params_from_jax``).  Logits and KV caches must match
at atol 1e-4 (fp32; the two frameworks sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import transformer as jax_transformer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import Model, layers, transformer
from repro_torch.serving import EngineConfig, ServingEngine

ATOL = 1e-4
DECODERS = ("qwen3-4b", "starcoder2-15b", "llama3-405b", "llava-next-mistral-7b")
ARCHES = DECODERS + ("hubert-xlarge",)


@pytest.fixture(scope="module")
def pairs():
    """arch -> (jax model, jax params, port cfg, port model), built once."""
    built = {}

    def get(arch):
        if arch not in built:
            jmodel = JaxModel(jax_get_config(arch).reduce())
            jparams = jmodel.init(jax.random.key(0))
            cfg = get_config(arch).reduce()
            model = Model(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
            built[arch] = (jmodel, jparams, cfg, model)
        return built[arch]

    return get


@pytest.mark.parametrize("arch", ARCHES)
def test_config_matches_reference(arch):
    for reduce in (False, True):
        a, b = jax_get_config(arch), get_config(arch)
        if reduce:
            a, b = a.reduce(), b.reduce()
        for f in dataclasses.fields(ModelConfig):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        for f in ("resolved_head_dim", "q_dim", "kv_dim"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.param_count() == b.param_count()
    if arch == "llava-next-mistral-7b":
        from repro.configs import llava_next_mistral_7b as jl
        from repro_torch.configs import llava_next_mistral_7b as tl

        assert tl.N_PATCH_EMBEDS == jl.N_PATCH_EMBEDS == 576


def test_registry_lists_the_ported_arches():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert len(ARCH_IDS) == 10
    assert set(ARCHES) <= set(ARCH_IDS)
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    for arch in ("mixtral-8x22b", "arctic-480b"):
        assert arch in ARCH_IDS


@pytest.mark.parametrize("arch", ARCHES)
def test_params_from_jax_round_trips(pairs, arch):
    jmodel, jparams, cfg, model = pairs(arch)
    jp = jax.tree.map(np.asarray, jparams)
    sd = model.state_dict()
    # every leaf the model holds is filled, and nothing else
    assert sorted(sd) == sorted(params_from_jax(jp, cfg))
    if not cfg.qk_norm:   # the port holds qk_norm expanded to (Hq + Hkv, Dh)
        assert sum(t.numel() for t in sd.values()) == sum(
            a.size for a in jax.tree.leaves(jp)) == cfg.param_count()
    if cfg.input_mode == "tokens":
        np.testing.assert_array_equal(sd["embed"].numpy(), jp["embed"])
    else:
        assert "embed" not in sd and "embed" not in jp
    if cfg.family == "encoder":
        np.testing.assert_array_equal(sd["encoder_head"].numpy(), jp["head"])
        assert torch.equal(model.head, sd["encoder_head"])
    elif cfg.tie_embeddings:
        assert "lm_head" not in sd and "lm_head" not in jp
    else:
        np.testing.assert_array_equal(sd["lm_head"].numpy(), jp["lm_head"])
        assert torch.equal(model.head, sd["lm_head"])
    mlp = jp["layers"]["mlp"]
    f = cfg.d_ff
    for li in range(cfg.n_layers):
        pre = f"layers.{li}."
        if cfg.mlp_type == "gelu":
            assert pre + "w_gu" not in sd and "w_gate" not in mlp
            np.testing.assert_array_equal(sd[pre + "w_up"].numpy(), mlp["w_up"][li])
        else:
            wgu = sd[pre + "w_gu"].numpy()
            np.testing.assert_array_equal(wgu[:, :f], mlp["w_gate"][li])
            np.testing.assert_array_equal(wgu[:, f:], mlp["w_up"][li])
        np.testing.assert_array_equal(sd[pre + "w_down"].numpy(), mlp["w_down"][li])


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), ("bfloat16", 2e-2)])
def test_gelu_mlp_matches_jax(dtype, atol):
    """``layers.gelu_mlp`` against the gelu branch of the JAX ``mlp_block``
    (the tanh form of ``jax.nn.gelu``)."""
    cfg = jax_get_config("starcoder2-15b").reduce()
    rng = np.random.default_rng(3)
    d, f = cfg.d_model, cfg.d_ff
    h = rng.standard_normal((2, 5, d)).astype(np.float32)
    w_up = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    w_down = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == np.float32 else (jnp.bfloat16,
                                                                       torch.bfloat16)
    lp = {"mlp": {"w_up": jnp.asarray(w_up, jd), "w_down": jnp.asarray(w_down, jd)}}
    want, _ = jax_transformer.mlp_block(lp, jnp.asarray(h, jd), cfg, None)
    got = layers.gelu_mlp(torch.from_numpy(h).to(td), torch.from_numpy(w_up).to(td),
                          torch.from_numpy(w_down).to(td))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=0)
    # the erf form is a different function at this tolerance
    x = torch.linspace(-6, 6, 4001, dtype=torch.float64)
    gap = (torch.nn.functional.gelu(x) - torch.nn.functional.gelu(x, approximate="tanh"))
    assert float(gap.abs().max()) > 4e-4


def _batch(cfg, rng, B, S, n_patches=0):
    """The JAX batch and the port's prefill arguments for one prompt batch."""
    if cfg.family == "encoder":
        e = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return {"embeds": e}, dict(embeds=torch.from_numpy(e))
    t = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"inputs": t}, dict(tokens=torch.from_numpy(t).long())
    if n_patches:
        p = rng.standard_normal((B, n_patches, cfg.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = p, torch.from_numpy(p)
    return jb, tb


def _same_cache(tc, jc):
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_matches_jax(pairs, arch):
    jmodel, jparams, cfg, model = pairs(arch)
    jb, tb = _batch(cfg, np.random.default_rng(0), 2, 24)
    jl, jc = jmodel.prefill(jparams, jb)
    tl, tc = model.prefill(**tb)
    assert tl.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _same_cache(tc, jc)


def test_vlm_prefill_with_patches_matches_jax(pairs):
    """8 patch embeddings ahead of 16 text tokens: positions arange(24),
    the KV of all 24 and the last text position's logits."""
    jmodel, jparams, cfg, model = pairs("llava-next-mistral-7b")
    jb, tb = _batch(cfg, np.random.default_rng(1), 2, 16, n_patches=8)
    jl, jc = jmodel.prefill(jparams, jb)
    tl, tc = model.prefill(**tb)
    assert tc.k.shape[2] == 24
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _same_cache(tc, jc)
    # the patches are really read: other patches, other logits
    tl2, _ = model.prefill(tb["tokens"], patches=tb["patches"] + 1.0)
    assert float((tl2 - tl).abs().max()) > 1e-3


def test_patches_and_embeds_only_for_their_families(pairs):
    _, _, cfg, model = pairs("starcoder2-15b")
    tok = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="vlm"):
        model.prefill(tok, patches=torch.zeros((1, 2, cfg.d_model)))
    with pytest.raises(ValueError, match="encoder"):
        model.prefill(embeds=torch.zeros((1, 4, cfg.d_model)))
    _, _, ecfg, enc = pairs("hubert-xlarge")
    with pytest.raises(ValueError, match="embeds"):
        enc.prefill(tok)


def test_encoder_all_position_logits_match_jax(pairs):
    """hubert: ``run_layers_seq`` + ``logits_from_hidden`` over every
    position at S 64 (non-causal: the first position sees the last), and
    ``Model.prefill(all_logits=True)``, against the JAX backbone and head."""
    jmodel, jparams, cfg, model = pairs("hubert-xlarge")
    assert not cfg.causal
    e = np.random.default_rng(2).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    jx, _, _ = jax_transformer.run_layers_seq(jparams, jnp.asarray(e), jmodel.cfg, None,
                                              return_cache=False)
    want = np.asarray(jax_transformer.logits_from_hidden(jparams, jx, jmodel.cfg))
    x, _ = transformer.run_layers_seq(model.layers, torch.from_numpy(e), cfg)
    got = transformer.logits_from_hidden(model.head, model.final_norm, x, cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)
    full, _ = model.prefill(embeds=torch.from_numpy(e), all_logits=True)
    assert full.shape == (2, 64, cfg.vocab_size)
    np.testing.assert_allclose(full.numpy(), want, atol=ATOL, rtol=1e-4)
    # non-causal: a change at the last frame moves the first frame's logits
    e2 = e.copy()
    e2[:, -1] += 1.0
    moved, _ = model.prefill(embeds=torch.from_numpy(e2), all_logits=True)
    assert float((moved[:, 0] - full[:, 0]).abs().max()) > 1e-4


def test_encoder_does_not_decode(pairs):
    jmodel, _, cfg, model = pairs("hubert-xlarge")
    assert not cfg.supports_decode
    assert not model.supports_mixed_step and not model.supports_paged_kv
    assert not jmodel.supports_mixed_step and not jmodel.supports_paged_kv
    tok = torch.zeros((1, 4), dtype=torch.long)
    cache = model.empty_cache(1, 8)
    with pytest.raises(ValueError, match="decode"):
        model.decode(tok[:, :1], cache, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="mixed"):
        model.step_mixed(tok, cache, np.array([0]), np.array([4]))
    with pytest.raises(ValueError, match="paged"):
        model.prefill_paged(tok, None, np.array([1]), 0)
    with pytest.raises(ValueError, match="paged"):
        model.empty_page_pool(4, 8)
    with pytest.raises(ValueError, match="does not decode"):
        ServingEngine(model, EngineConfig(max_len=32), device="cpu")


def _filled_caches(jmodel, model, rng, B, S):
    """Empty caches of both packages filled with the same random prefix KV."""
    jc, tc = jmodel.empty_cache(B, S), model.empty_cache(B, S)
    k = rng.standard_normal(jc.k.shape).astype(np.float32)
    v = rng.standard_normal(jc.v.shape).astype(np.float32)
    tc.k.copy_(torch.from_numpy(k))
    tc.v.copy_(torch.from_numpy(v))
    return jc._replace(k=jnp.asarray(k), v=jnp.asarray(v)), tc


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_jax(pairs, arch):
    jmodel, jparams, cfg, model = pairs(arch)
    rng = np.random.default_rng(4)
    B, S = 3, 64
    jc, tc = _filled_caches(jmodel, model, rng, B, S)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    lens = np.array([0, 13, S - 1], np.int32)
    jl, jc2 = jmodel.decode(jparams, jnp.asarray(tokens), jc, jnp.asarray(lens))
    tl = model.decode(torch.from_numpy(tokens).long(), tc, torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _same_cache(tc, jc2)


@pytest.mark.parametrize("all_logits", [False, True])
@pytest.mark.parametrize("arch", DECODERS)
def test_step_mixed_matches_jax(pairs, arch, all_logits):
    jmodel, jparams, cfg, model = pairs(arch)
    rng = np.random.default_rng(5)
    B, S, Q = 3, 64, 8
    jc, tc = _filled_caches(jmodel, model, rng, B, S)
    tokens = rng.integers(0, cfg.vocab_size, (B, Q)).astype(np.int32)
    cache_lens = np.array([0, 17, S - 5], np.int32)
    new_lens = np.array([8, 1, 5], np.int32)
    jl, jc2 = jmodel.step_mixed(jparams, jnp.asarray(tokens), jc, jnp.asarray(cache_lens),
                                jnp.asarray(new_lens), attn_window=S, all_logits=all_logits)
    tl = model.step_mixed(torch.from_numpy(tokens).long(), tc, cache_lens, new_lens,
                          attn_window=S, all_logits=all_logits)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    _same_cache(tc, jc2)


def test_seeded_init_draws_every_leaf():
    """``init_`` fills the gelu ``w_up``, the untied ``lm_head`` and the
    encoder's ``encoder_head`` at N(0, 1/fan_in), and is deterministic."""
    for arch in ("starcoder2-15b", "hubert-xlarge"):
        cfg = get_config(arch).reduce()
        a = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(7))
        b = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(7))
        for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), n
        assert abs(float(a.layers[0].w_up.std()) - 1.0 / np.sqrt(cfg.d_model)) < 0.01
        assert abs(float(a.head.std()) - 1.0 / np.sqrt(cfg.d_model)) < 0.01
        assert not hasattr(a.layers[0], "w_gu")


def test_check_supported_takes_the_five_and_refuses_moe():
    """Every arch of the JAX package is taken, the MoE pair too; what the
    port still refuses raises ``NotImplementedError``."""
    for arch in ARCHES + ("qwen3-0.6b", "rwkv6-7b", "zamba2-2.7b", "mixtral-8x22b",
                          "arctic-480b"):
        jc = jax_get_config(arch)
        transformer.check_supported(ModelConfig(**{f.name: getattr(jc, f.name)
                                                   for f in dataclasses.fields(ModelConfig)}))
    base = get_config("qwen3-4b").reduce()
    transformer.check_supported(dataclasses.replace(base, sliding_window=64))
    for bad in (dict(mlp_type="geglu"), dict(family="moe"), dict(n_experts=4, top_k=2),
                dict(family="moe", n_experts=4, top_k=0), dict(input_mode="embeds"),
                dict(family="encoder"), dict(family="vlm", sliding_window=64)):
        with pytest.raises(NotImplementedError):
            transformer.check_supported(dataclasses.replace(base, **bad))
    with pytest.raises(NotImplementedError):
        transformer.check_supported(
            dataclasses.replace(get_config("zamba2-2.7b").reduce(), sliding_window=64))
    enc = get_config("hubert-xlarge")
    with pytest.raises(NotImplementedError):
        transformer.check_supported(dataclasses.replace(enc, supports_decode=True))
