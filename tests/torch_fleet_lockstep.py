"""Shared pieces of the port-vs-JAX fleet tests (``tests/test_torch_fleet*.py``).

``_one_thread`` (autouse where imported) runs the port's tiny steps on
one intra-op thread.  ``models`` is a module fixture: the JAX qwen3-0.6b.reduce() params (seed 0)
and the port model converted from them, plus a cache of JAX engines by
engine config (one compile per config for the module).  ``_fleets`` builds
one trace's JAX and port runtimes (the port on the CPU, its
``_model_cache`` holding the converted model, so each tier's engine comes
from its own ``TierSpec``), and ``assert_lockstep`` holds their reports to
each other, the wall-time fields aside.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.fleet import runtime as jrt
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.fleet import runtime as prt
from repro_torch.models import Model

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's steps here are tiny: one intra-op thread runs them faster
    than a pool, and keeps these files from oversubscribing the cores that
    parallel test workers share.  Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WALL_EVENT = ("wall_s", "admit_s", "dispatch_s", "sync_s")
WALL_TELEMETRY = ("tokens_per_s", "kv_flush_s")
WALL_SUMMARY = ("goodput_tokens_per_s_wall",)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    # JAX engines by engine config: one compile per config for the module
    return dict(cfg=cfg, jax=(jmodel, jparams), port=model, jax_engines={})


def _engine_key(spec):
    return (spec.max_len, spec.decode_batch, spec.decode_chunk, spec.mixed_step,
            spec.prefill_chunk, spec.paged_kv, spec.page_size, spec.num_pages,
            spec.prefix_reuse, spec.spec_k)


def _jax_engine(models, spec):
    key = _engine_key(spec)
    if key not in models["jax_engines"]:
        jmodel, jparams = models["jax"]
        models["jax_engines"][key] = JaxServingEngine(jmodel, jparams, JaxEngineConfig(
            max_len=spec.max_len, decode_batch=spec.decode_batch, temperature=0.0,
            decode_chunk=spec.decode_chunk, mixed_step=spec.mixed_step,
            prefill_chunk=spec.prefill_chunk, paged_kv=spec.paged_kv,
            page_size=spec.page_size, num_pages=spec.num_pages,
            prefix_reuse=spec.prefix_reuse, spec_k=spec.spec_k))
    return models["jax_engines"][key]


def _adopt(models, j, p):
    """Put the shared weights into a JAX and a port runtime of one trace."""
    for spec in j.tiers:
        j._engines[spec.name] = _jax_engine(models, spec)
    for spec in p.tiers:
        mkey = (spec.arch, spec.param_seed, tuple(sorted((spec.model_overrides or {}).items())))
        p._model_cache[mkey] = models["port"]
    return j, p


def _fleets(models, builder, **kw):
    return _adopt(models, getattr(jrt, builder)(**kw), getattr(prt, builder)(device="cpu", **kw))


def _events(rt):
    return [{k: v for k, v in e.items() if k not in WALL_EVENT} for e in rt.tracer.to_list()]


def _drop(d, keys):
    return {k: v for k, v in d.items() if k not in keys}


def assert_lockstep(j, p, jr, pr):
    assert pr.mode_trace == jr.mode_trace
    assert [dataclasses.asdict(d) for d in pr.decisions] == \
        [dataclasses.asdict(d) for d in jr.decisions]
    assert all(d.explains() for d in pr.decisions)
    assert [dataclasses.asdict(r) for r in pr.requests.records] == \
        [dataclasses.asdict(r) for r in jr.requests.records]
    assert pr.requests.dropped == jr.requests.dropped
    assert sorted(pr.outputs) == sorted(jr.outputs)
    for rid, toks in jr.outputs.items():
        got = pr.outputs[rid]
        assert got.dtype == np.asarray(toks).dtype and got.tobytes() == np.asarray(toks).tobytes()
    assert len(pr.metrics.records) == len(jr.metrics.records) == pr.ticks == jr.ticks
    for a, b in zip(pr.metrics.records, jr.metrics.records):
        assert (a.t, a.mode, a.demand_rps, a.cost_rate) == (b.t, b.mode, b.demand_rps, b.cost_rate)
        for f in ("weights", "ready", "served_rps", "latency_s", "utilization"):
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)))
    assert _events(p) == _events(j)
    assert {t: _drop(v, WALL_TELEMETRY) for t, v in pr.telemetry.items()} == \
        {t: _drop(v, WALL_TELEMETRY) for t, v in jr.telemetry.items()}
    assert _drop(pr.summary(), WALL_SUMMARY) == _drop(jr.summary(), WALL_SUMMARY)
    assert pr.kv_store == jr.kv_store
    assert (pr.useful_tokens, pr.wasted_tokens) == (jr.useful_tokens, jr.wasted_tokens)
