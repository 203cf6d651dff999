"""The port's MoE family against the JAX package (``reduce()`` configs, CPU):
mixtral-8x22b (8 experts top-2 -> 4 after ``reduce()``, sliding window)
and arctic-480b (128 experts -> 4, plus a dense SwiGLU residual).

* The MoE pieces (``route``, ``dispatch``, ``expert_ffn``, ``combine``,
  ``moe_block``) against JAX ``_route``, ``_dispatch``, ``_expert_ffn``,
  ``_combine`` and ``moe_block`` at T in {1, 8, 64, 200} tokens, capacity
  factors 1.25 (experts overflow) and 16, fp32 (atol 2e-5) and bf16 (atol
  2e-2, and rtol 2^-7, one bf16 ulp: the skewed inputs give outputs above
  4, where one ulp is 0.03125): the experts picked, each assignment's ``slot`` and ``keep`` are
  equal; the Switch aux loss; zero expert weights give zero.
* The model: ``prefill``, ``decode`` and (arctic) ``step_mixed``, with
  all-position logits too, and ``prefill_paged`` logits and caches against
  the JAX ``Model`` at fp32 atol 2e-5, both capacity factors.
* Sessions: arctic's are in ``tests/test_torch_moe_engine.py``,
  mixtral's (legacy, the ring wrapping) in ``tests/test_torch_swa.py``.

Weights come from the JAX ``Model.init`` through ``convert.params_from_jax``;
inputs from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import _moe_layer, params_from_jax
from repro_torch.models import Model, moe
from repro_torch.models.model import DecoderKVCache
from repro_torch.serving import EngineConfig, ServingEngine

ATOL = 2e-5
ARCHES = ("mixtral-8x22b", "arctic-480b")
FACTORS = (1.25, 16.0)
# (jax dtype, torch dtype, atol, rtol)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 0.0),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2.0 ** -7)}


def _cfgs(arch, cf, dtype="float32"):
    kw = dict(capacity_factor=cf, dtype=dtype)
    return (dataclasses.replace(jax_get_config(arch).reduce(), **kw),
            dataclasses.replace(get_config(arch).reduce(), **kw))


@pytest.mark.parametrize("arch", ARCHES)
def test_configs_match_the_reference(arch):
    from repro.configs import resolve_serving_arch as jax_resolve, serving_family as jax_family
    from repro_torch.configs import resolve_serving_arch, serving_family
    from repro_torch.configs.base import ModelConfig

    for a, b in ((jax_get_config(arch), get_config(arch)),
                 (jax_get_config(arch).reduce(), get_config(arch).reduce())):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
    assert resolve_serving_arch(arch) == get_config(arch)
    assert resolve_serving_arch(arch).name == jax_resolve(arch).name
    assert serving_family(arch) == jax_family(arch) == "moe"


@pytest.fixture(scope="module")
def layer_params():
    """arch -> layer 0's JAX ``moe`` leaves (numpy, fp32), drawn once."""
    out = {}
    for arch in ARCHES:
        jcfg = jax_get_config(arch).reduce()
        p = jmoe.init_moe_params(jax.random.key(3), jcfg, jnp.float32)
        out[arch] = jax.tree.map(np.asarray, p)
    return out


def _inputs(cfg, T, seed):
    """(T, d) tokens with a skew toward expert 0 on every other token, so the
    router overflows an expert at capacity factor 1.25."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    x[::2] += 3.0 * np.sign(rng.standard_normal(cfg.d_model)).astype(np.float32)
    return x


def _port_moe(np_leaves, cfg):
    """A port ``MoE`` holding the JAX leaves, fused as ``params_from_jax``
    fuses them."""
    stacked = jax.tree.map(lambda a: a[None], np_leaves)
    state = {}
    _moe_layer(state, "", stacked, 0, cfg)
    m = moe.MoE(cfg, device="cpu", dtype=cfg.torch_dtype)
    m.load_state_dict(state)
    return m


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("T", [1, 8, 64, 200])
@pytest.mark.parametrize("arch", ARCHES)
def test_moe_pieces_match_jax(layer_params, arch, T, cf, dtype):
    jd, td, atol, rtol = DTYPES[dtype]
    jcfg, cfg = _cfgs(arch, cf, dtype)
    leaves = layer_params[arch]
    x = _inputs(cfg, T, seed=T)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    E, k = cfg.n_experts, cfg.top_k
    cap = moe.capacity(T, cfg)
    assert cap == jmoe._capacity(T, jcfg)
    p = _port_moe(leaves, cfg)

    jg, je, jaux = jmoe._route(jx, jnp.asarray(leaves["router"]), k)
    tg, te, taux = moe.route(tx, p.router, k, aux=True)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert moe.route(tx, p.router, k)[2] is None

    jbuf, jslot, jtok, jcw = jmoe._dispatch(jx, jg, je, 0, E, cap)
    dp = moe.dispatch(tx, tg, te, E, cap)
    # the kept assignments are the slots below E·C; the port's tokens are
    # token-major, k a token, as JAX's token_idx
    np.testing.assert_array_equal(dp.slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(np.asarray(jtok), np.arange(T * k) // k)
    np.testing.assert_array_equal(dp.buf.float().numpy(), np.asarray(jbuf.astype(jnp.float32)))
    np.testing.assert_allclose(dp.combine_w.float().numpy(),
                               np.asarray(jcw.astype(jnp.float32)), atol=atol, rtol=rtol)

    w = {n: jnp.asarray(leaves[n], jd) for n in ("w_gate", "w_up", "w_down")}
    jy = jmoe._expert_ffn(jbuf, w["w_gate"], w["w_up"], w["w_down"], jd)
    ty = moe.expert_ffn(dp.buf, p.w_gu, p.w_down)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               atol=atol, rtol=rtol)
    # combine from the same expert rows, so only the combine's own rounding counts
    jo = jmoe._combine(jy, jslot, jtok, jcw, T)
    to = moe.combine(torch.tensor(np.asarray(jy.astype(jnp.float32))).to(td), dp.slot,
                     dp.combine_w, T)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                               atol=atol, rtol=rtol)

    jp = {n: jnp.asarray(a, jnp.float32 if n == "router" else jd) for n, a in leaves.items()}
    jout, _ = jmoe.moe_block(jp, jx.reshape(1, T, -1), jcfg)
    tout, none = moe.moe_block(p, tx.reshape(1, T, -1), cfg)
    assert none is None
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


def test_capacity_factor_125_overflows():
    """The skewed inputs of ``test_moe_pieces_match_jax`` really drop
    assignments at capacity factor 1.25 (and at 16 drop none)."""
    for arch in ARCHES:
        for cf, dropped in ((1.25, True), (16.0, False)):
            _, cfg = _cfgs(arch, cf)
            x = torch.from_numpy(_inputs(cfg, 64, seed=64))
            r = torch.Generator().manual_seed(0)
            router = torch.randn((cfg.d_model, cfg.n_experts), generator=r) * 0.02
            g, e, _ = moe.route(x, router, cfg.top_k)
            cap = moe.capacity(64, cfg)
            dp = moe.dispatch(x, g, e, cfg.n_experts, cap)
            assert bool((dp.slot == cfg.n_experts * cap).any()) == dropped, (arch, cf)


@pytest.mark.parametrize("arch", ARCHES)
def test_dense_residual_and_zero_experts(layer_params, arch):
    """Arctic's residual is ``layers.swiglu`` of the same input added after
    the combine; with zero expert weights the experts add exactly zero (the
    JAX property of ``test_elastic_and_moe_properties.py``)."""
    jcfg, cfg = _cfgs(arch, 1.25)
    leaves = {n: a.copy() for n, a in layer_params[arch].items()}
    for n in ("w_gate", "w_up", "w_down"):
        leaves[n][:] = 0.0
    p = _port_moe(leaves, cfg)
    x = torch.from_numpy(_inputs(cfg, 24, seed=5)).reshape(2, 12, -1)
    out, _ = moe.moe_block(p, x, cfg)
    if not cfg.moe_dense_residual:
        assert float(out.abs().max()) == 0.0
        return
    from repro.models import layers as jlayers

    want = jlayers.swiglu(jnp.asarray(x.numpy()), *(jnp.asarray(leaves[n]) for n in
                                                     ("res_gate", "res_up", "res_down")))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)
    assert float(out.abs().max()) > 0.1


def test_tied_probabilities_pick_the_lower_expert():
    """Equal router probabilities: the lower expert index first, as
    ``lax.top_k`` orders them."""
    x = torch.ones((3, 4))
    router = torch.zeros((4, 6))
    router[:, 4] = 1.0
    g, e, _ = moe.route(x, router, 3)
    want_g, want_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray((x @ router).numpy()), -1), 3)
    np.testing.assert_array_equal(e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(e[0].numpy(), [4, 0, 1])


# ---------------------------------------------------------------------------
# the model against the JAX Model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    """(arch, capacity factor) -> (jax model, jax params, port cfg, port model)."""
    built = {}

    def get(arch, cf=1.25):
        if (arch, cf) not in built:
            jcfg, cfg = _cfgs(arch, cf)
            jmodel = JaxModel(jcfg)
            jparams = jmodel.init(jax.random.key(0))
            model = Model(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
            built[arch, cf] = (jmodel, jparams, cfg, model)
        return built[arch, cf]

    return get


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHES)
def test_params_from_jax_carries_the_moe_leaves(pairs, arch):
    jmodel, jparams, cfg, model = pairs(arch)
    jp = jax.tree.map(np.asarray, jparams)
    sd = model.state_dict()
    assert sorted(sd) == sorted(params_from_jax(jp, cfg))
    assert sum(t.numel() for t in sd.values()) == sum(
        a.size for a in jax.tree.leaves(jp)) == cfg.param_count()
    m, f = jp["layers"]["moe"], cfg.d_ff
    for li in range(cfg.n_layers):
        pre = f"layers.{li}.moe."
        assert sd[pre + "router"].dtype == torch.float32
        np.testing.assert_array_equal(sd[pre + "router"].numpy(), m["router"][li])
        np.testing.assert_array_equal(sd[pre + "w_gu"][..., :f].numpy(), m["w_gate"][li])
        np.testing.assert_array_equal(sd[pre + "w_gu"][..., f:].numpy(), m["w_up"][li])
        np.testing.assert_array_equal(sd[pre + "w_down"].numpy(), m["w_down"][li])
        assert (pre + "res_gu" in sd) == cfg.moe_dense_residual
        if cfg.moe_dense_residual:
            fr = cfg.dense_residual_ff
            np.testing.assert_array_equal(sd[pre + "res_gu"][:, :fr].numpy(), m["res_gate"][li])
            np.testing.assert_array_equal(sd[pre + "res_down"].numpy(), m["res_down"][li])
        assert not hasattr(model.layers[li], "w_gu")


def test_bf16_model_keeps_the_router_fp32():
    for arch in ARCHES:
        cfg = dataclasses.replace(get_config(arch).reduce(), dtype="bfloat16")
        m = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
        lay = m.layers[0].moe
        assert lay.router.dtype == torch.float32 and lay.w_gu.dtype == torch.bfloat16
        assert abs(float(lay.router.std()) - 0.02) < 0.003
        assert abs(float(lay.w_gu.float().std()) - cfg.d_model ** -0.5) < 0.01
        assert abs(float(lay.w_down.float().std()) - cfg.d_ff ** -0.5) < 0.01


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_and_decode_match_jax(pairs, arch, cf):
    """A 40-token prefill (below mixtral's reduced window of 64) and two
    decode steps from it, logits and caches."""
    jmodel, jparams, cfg, model = pairs(arch, cf)
    rng = np.random.default_rng(1)
    B, S, max_len = 2, 40, 56
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jpc = jax.jit(jmodel.prefill)(jparams, {"inputs": jnp.asarray(toks)})
    tl, tpc = model.prefill(torch.from_numpy(toks).long())
    _close(tl, jl)
    _close(tpc.k, jpc.k)
    jc, tc = jmodel.empty_cache(B, max_len), model.empty_cache(B, max_len)
    jc = jc._replace(k=jc.k.at[:, :, :S].set(jpc.k), v=jc.v.at[:, :, :S].set(jpc.v))
    tc.k[:, :, :S] = tpc.k
    tc.v[:, :, :S] = tpc.v
    for i in range(2):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        lens = np.full(B, S + i, np.int32)
        jl, jc = jax.jit(jmodel.decode)(jparams, jnp.asarray(tok), jc, jnp.asarray(lens))
        tl = model.decode(torch.from_numpy(tok).long(), tc, torch.from_numpy(lens))
        _close(tl, jl)
        _close(tc.k, jc.k)


def _filled(jmodel, model, rng, B, S):
    jc, tc = jmodel.empty_cache(B, S), model.empty_cache(B, S)
    k = rng.standard_normal(jc.k.shape).astype(np.float32)
    v = rng.standard_normal(jc.v.shape).astype(np.float32)
    tc.k.copy_(torch.from_numpy(k))
    tc.v.copy_(torch.from_numpy(v))
    return jc._replace(k=jnp.asarray(k), v=jnp.asarray(v)), tc


@pytest.mark.parametrize("all_logits", [False, True])
@pytest.mark.parametrize("cf", FACTORS)
def test_arctic_step_mixed_matches_jax(pairs, cf, all_logits):
    """B 3 x Q 8 = 24 tokens route together, the padding columns included."""
    jmodel, jparams, cfg, model = pairs("arctic-480b", cf)
    rng = np.random.default_rng(5)
    B, S, Q = 3, 64, 8
    jc, tc = _filled(jmodel, model, rng, B, S)
    tokens = rng.integers(0, cfg.vocab_size, (B, Q)).astype(np.int32)
    cache_lens = np.array([0, 17, S - 5], np.int32)
    new_lens = np.array([8, 1, 5], np.int32)
    jl, jc2 = jmodel.step_mixed(jparams, jnp.asarray(tokens), jc, jnp.asarray(cache_lens),
                                jnp.asarray(new_lens), attn_window=S, all_logits=all_logits)
    tl = model.step_mixed(torch.from_numpy(tokens).long(), tc, cache_lens, new_lens,
                          attn_window=S, all_logits=all_logits)
    _close(tl, jl)
    _close(tc.k, jc2.k)
    _close(tc.v, jc2.v)


@pytest.mark.parametrize("cf", FACTORS)
def test_arctic_prefill_paged_matches_jax(pairs, cf):
    """Two cached blocks of 8, then a 5-token suffix through the table row."""
    jmodel, jparams, cfg, model = pairs("arctic-480b", cf)
    ps, nb, S, T = 8, 4, 16, 5
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, S + T))
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
    _close(tl, jl)
    _close(tpool.k, jpool.k)
    _close(tpool.v, jpool.v)


def test_paged_trash_writes_are_order_free():
    """An MoE model's paged plans give the rows that collide on the trash
    page one value, the last one's: the sequential write's result,
    whatever order the writes land in."""
    from repro_torch.models import attention

    ps, Q = 4, 6
    tables = torch.tensor([[1, 2, 0], [0, 0, 0], [3, 4, 5]], dtype=torch.int32)
    cl, nl = torch.tensor([2, 0, 9]), torch.tensor([3, 0, 2])
    dst, src, _ = attention.paged_write_plan(cl, nl, Q, tables, ps, dedupe=True)
    dst0, src0, _ = attention.paged_write_plan(cl, nl, Q, tables, ps)
    assert src0 is None and torch.equal(dst, dst0)
    rows = torch.arange(dst.numel(), dtype=torch.float32)[:, None]
    seq = torch.zeros((6 * ps, 1))
    for j in range(dst.numel()):
        seq[dst[j]] = rows[j]
    for order in (torch.arange(dst.numel()), torch.arange(dst.numel()).flip(0)):
        pool = torch.zeros((6 * ps, 1))
        pool[dst[order]] = rows[src][order]
        assert torch.equal(pool, seq)
    trash = dst < ps
    assert bool(trash.any()) and len(set(dst[trash].tolist())) < int(trash.sum())
    page, row, dsrc = attention.paged_decode_plan(torch.tensor([5, 7, 3, 11]),
                                                  torch.tensor([[1, 2, 0]] + [[0, 0, 0]] * 3,
                                                               dtype=torch.int32), ps,
                                                  dedupe=True)
    assert page.tolist() == [2, 0, 0, 0] and row.tolist() == [1, 3, 3, 3]
    assert dsrc.tolist() == [0, 3, 3, 3]


def test_mixtral_refuses_the_mixed_step_and_paged_kv(pairs):
    """A sliding window has no mixed step and no paged KV, in the port as in
    JAX; arctic (full attention) has both."""
    jmodel, _, cfg, model = pairs("mixtral-8x22b")
    assert not model.supports_mixed_step and not jmodel.supports_mixed_step
    assert not model.supports_paged_kv and not jmodel.supports_paged_kv
    ja, _, _, arctic = pairs("arctic-480b")
    assert arctic.supports_mixed_step and ja.supports_mixed_step
    assert arctic.supports_paged_kv and ja.supports_paged_kv
    tok = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="mixed"):
        model.step_mixed(tok, model.empty_cache(1, 8), np.array([0]), np.array([4]))
    with pytest.raises(ValueError, match="paged"):
        model.prefill_paged(tok, None, np.array([1]), 0)
    with pytest.raises(ValueError, match="paged"):
        model.empty_page_pool(4, 8)
    pool = arctic.empty_page_pool(4, 8)
    with pytest.raises(ValueError, match="sliding-window"):
        model.decode(tok[:, :1], DecoderKVCache(pool.k, pool.v), torch.zeros(1, dtype=torch.int32),
                     page_table=np.zeros((1, 1), np.int32))
    with pytest.raises(ValueError, match="paged_kv"):
        ServingEngine(model, EngineConfig(max_len=32, paged_kv=True), device="cpu")
