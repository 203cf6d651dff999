"""Greedy serving on the dense-family breadth arches against the JAX engine
(``reduce()`` fp32, CPU): starcoder2-15b (GELU MLP, untied head, G 2 after
``reduce()``), llama3-405b (untied) and llava-next-mistral-7b (vlm, served
on text), through ``QueueSession`` pump by pump, contiguous and paged, plus
legacy admission for starcoder2; and llava's ``generate`` with patch
embeddings ahead of the text against the JAX ``ServingEngine.generate``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.serving import EngineConfig, ServingEngine

REPORT_FIELDS = ("admitted", "emitted", "tokens", "chunk_steps", "prefill_chunks",
                 "mixed_steps", "useful_tokens", "wasted_tokens", "prefix_hits",
                 "prefix_misses", "reused_tokens", "prefilled_tokens", "cached_pages")


@pytest.fixture(scope="module")
def pairs():
    """arch -> (jax model, jax params, port model), built once."""
    built = {}

    def get(arch):
        if arch not in built:
            jmodel = JaxModel(jax_get_config(arch).reduce())
            jparams = jmodel.init(jax.random.key(0))
            cfg = get_config(arch).reduce()
            model = Model(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
            built[arch] = (jmodel, jparams, model)
        return built[arch]

    return get


def _ecfg(cls, **kw):
    base = dict(max_len=64, decode_batch=3, temperature=0.0, decode_chunk=4, prefill_chunk=8,
                page_size=8)
    base.update(kw)
    return cls(**base)


def _requests(vocab):
    """Seven requests: a shared 16-token prefix (two suffixes and an exact
    repeat, so the paged runs take a prefix hit and a full hit) and cold
    prompts of 5-30 tokens."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, 16)
    shared = [np.concatenate([system, rng.integers(0, vocab, n)]) for n in (3, 9)]
    prompts = shared + [shared[0].copy()] + [rng.integers(0, vocab, n) for n in (12, 5, 30, 8)]
    return [(p.astype(np.int32)[None], n) for p, n in zip(prompts, (6, 9, 5, 7, 3, 8, 1))]


@pytest.mark.parametrize("arch,paged,mixed", [
    ("starcoder2-15b", False, True), ("starcoder2-15b", True, True),
    ("starcoder2-15b", False, False), ("llama3-405b", False, True),
    ("llama3-405b", True, True), ("llava-next-mistral-7b", False, True),
    ("llava-next-mistral-7b", True, True)])
def test_session_streams_token_exact_with_jax(pairs, arch, paged, mixed):
    jmodel, jparams, model = pairs(arch)
    kw = dict(paged_kv=paged, mixed_step=mixed)
    js = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, **kw)).new_session()
    ts = ServingEngine(model, _ecfg(EngineConfig, **kw), device="cpu").new_session()
    for rid, (p, n) in enumerate(_requests(model.cfg.vocab_size)):
        js.submit(rid, p, n)
        ts.submit(rid, p, n)
    pumps = 0
    while not (js.idle and ts.idle):
        jr, tr = js.pump(), ts.pump()
        pumps += 1
        for f in REPORT_FIELDS:
            assert getattr(tr, f) == getattr(jr, f), (f, pumps)
        assert sorted(tr.completed) == sorted(jr.completed)
        for rid in jr.completed:
            np.testing.assert_array_equal(tr.completed[rid], jr.completed[rid])
    assert sorted(ts.results) == sorted(js.results) == list(range(7))
    for rid in js.results:
        np.testing.assert_array_equal(ts.results[rid], js.results[rid])
    if paged:
        st = ts.allocator.stats
        assert st.prefix_hits >= 1 and st.full_hits >= 1


def test_vlm_generate_with_patches_token_exact_with_jax(pairs):
    """B=2, 8 patch embeddings ahead of 12 text tokens: ``prompt_len`` 20."""
    steps = 6
    jmodel, jparams, model = pairs("llava-next-mistral-7b")
    cfg = model.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    patches = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    batch = {"inputs": toks, "patches": patches}
    want = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig)).generate(batch, steps, 20)
    eng = ServingEngine(model, _ecfg(EngineConfig), device="cpu")
    got = eng.generate(batch, steps, 20)
    np.testing.assert_array_equal(got, np.asarray(want))
    logits, cache = eng.prefill(batch)
    assert cache.k.shape[2] == 20
    np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(), got[:, 0])
