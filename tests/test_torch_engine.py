"""The port's serving path against the JAX engine (qwen3-0.6b.reduce(), CPU).

Greedy streams from the port's ``EngineClient`` must be token-exact with
the JAX ``EngineClient`` on the same weights and requests, and the pump
counters must agree.  At ``max_len=2048`` every decode step takes the
split-K plain version (``auto_k_splits(2048) = 4``).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.api import EngineClient as JaxEngineClient
from repro.serving.api import InferenceRequest as JaxInferenceRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.decode_attention import kernel, ops
from repro_torch.models import Model
from repro_torch.serving import (
    EngineClient,
    EngineConfig,
    InferenceRequest,
    RequestStatus,
    ServingEngine,
)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, cfg, model


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (1, p)), n)
            for p, n in [(12, 6), (5, 9), (17, 3), (30, 7), (12, 5), (8, 1)]]


def _ecfg(cls, max_len):
    return cls(max_len=max_len, decode_batch=3, temperature=0.0, decode_chunk=4,
               prefill_chunk=8)


@pytest.mark.parametrize("max_len", [64, 2048])
def test_streams_token_exact_with_jax(pair, max_len):
    jmodel, jparams, cfg, model = pair
    reqs = _requests(cfg.vocab_size)
    jeng = JaxServingEngine(jmodel, jparams, _ecfg(JaxEngineConfig, max_len))
    jcli = JaxEngineClient(jeng)
    jh = [jcli.submit(JaxInferenceRequest(prompt=p, max_new=n)) for p, n in reqs]
    jcli.drain()

    eng = ServingEngine(model, _ecfg(EngineConfig, max_len), device="cpu")
    cli = EngineClient(eng, device="cpu")
    th = [cli.submit(InferenceRequest(prompt=p, max_new=n)) for p, n in reqs]
    streamed = {h.rid: list(h.tokens()) for h in th}
    for a, b in zip(jh, th):
        assert b.status is RequestStatus.COMPLETED
        np.testing.assert_array_equal(b.result(), a.result())
        assert streamed[b.rid] == list(a.result())
        assert b.record.tokens == len(a.result())
    for f in ("mixed_steps", "prefill_chunks", "useful_tokens", "wasted_tokens",
              "prefills", "chunks", "completed_requests"):
        assert getattr(eng.telemetry, f) == getattr(jeng.telemetry, f), f
    if max_len == 2048:
        assert ops.auto_k_splits(max_len) > 1


def test_cpu_path_launches_no_kernel(pair):
    *_, cfg, model = pair
    kernel.reset_launches()
    cli = EngineClient(ServingEngine(model, _ecfg(EngineConfig, 64), device="cpu"),
                       device="cpu")
    h = cli.submit(InferenceRequest(prompt=np.arange(10), max_new=3))
    assert len(h.result()) == 3
    assert all(n == 0 for n in kernel.LAUNCHES.values())


def test_cancel_frees_the_slot(pair):
    *_, cfg, model = pair
    eng = ServingEngine(model, EngineConfig(max_len=64, decode_batch=1, decode_chunk=2,
                                            prefill_chunk=8), device="cpu")
    cli = EngineClient(eng, device="cpu")
    a = cli.submit(InferenceRequest(prompt=np.arange(6), max_new=20))
    b = cli.submit(InferenceRequest(prompt=np.arange(6) + 1, max_new=3))
    cli.tick()
    assert a.status is RequestStatus.STREAMING and a.delivered > 0
    assert b.status is RequestStatus.QUEUED
    assert a.cancel()
    assert a.status is RequestStatus.CANCELLED
    assert cli.session.slots.occupancy == 0.0
    assert not a.cancel()
    assert len(b.result()) == 3                 # the freed slot serves the next request
    assert cli.idle


def test_unported_options_raise(pair):
    """Speculative decoding is ported (``test_torch_spec.py``): ``spec_k=2``
    builds a mixed engine whose sessions take that depth; ``mixed_step=False``
    (see ``test_torch_prefill.py``) builds a legacy engine."""
    *_, cfg, model = pair
    eng = ServingEngine(model, EngineConfig(max_len=64, spec_k=2), device="cpu")
    assert eng.mixed and eng.new_session().spec_k == 2
    assert not ServingEngine(model, EngineConfig(max_len=64, mixed_step=False),
                             device="cpu").mixed


def test_paged_kv_needs_a_pageable_model(pair):
    """paged_kv=True on a config without supports_paged_kv raises
    ValueError, in the port as in JAX."""
    jmodel, _, cfg, _ = pair
    ncfg = dataclasses.replace(cfg, supports_decode=False)
    model = Model(ncfg, device="cpu")
    assert not model.supports_paged_kv
    with pytest.raises(ValueError, match="paged_kv"):
        ServingEngine(model, EngineConfig(max_len=64, paged_kv=True), device="cpu")
    jm = JaxModel(dataclasses.replace(jmodel.cfg, supports_decode=False))
    with pytest.raises(ValueError, match="paged_kv"):
        JaxServingEngine(jm, None, JaxEngineConfig(max_len=64, paged_kv=True))


def test_submit_bounds(pair):
    *_, cfg, model = pair
    cli = EngineClient(ServingEngine(model, EngineConfig(max_len=32), device="cpu"),
                       device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        cli.submit(InferenceRequest(prompt=np.arange(30), max_new=5))
    assert not cli.session.fits(30, 5) and cli.session.fits(27, 5)
    assert cli.session.load == 0
    cli.submit(InferenceRequest(prompt=np.arange(3), max_new=2))
    assert cli.session.load == 1
    h = cli.submit(InferenceRequest(prompt=np.arange(4), max_new=0))
    cli.drain()
    assert h.status is RequestStatus.COMPLETED and len(h.result()) == 0
    assert cli.session.load == 0 and cli.idle


def test_temperature_sampling_is_seeded(pair):
    """temperature > 0 draws from torch generators seeded by EngineConfig.seed:
    the same seed gives the same streams (jax.random's bits are not matched)."""
    *_, cfg, model = pair
    outs = []
    for _ in range(2):
        eng = ServingEngine(model, EngineConfig(max_len=64, decode_batch=2, decode_chunk=3,
                                                prefill_chunk=8, temperature=0.8, seed=3),
                            device="cpu")
        cli = EngineClient(eng, device="cpu")
        hs = [cli.submit(InferenceRequest(prompt=np.arange(n) + 5, max_new=6)) for n in (4, 9, 7)]
        outs.append([h.result() for h in hs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
        assert len(a) == 6 and ((a >= 0) & (a < cfg.vocab_size)).all()
