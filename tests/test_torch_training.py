"""The port's training substrate against the JAX package (CPU).

* AdamW ``update`` and ``lr_at`` against JAX's on random trees (three
  updates): fp32 and bf16 moments, clipping on and off,
  ``stacked_update_dtype="bfloat16"`` (a (6, 8, 16) JAX leaf takes it,
  as six port leaves of a 6-layer stack; a (3, 8, 16) leaf does not).
  Parameters and moments at atol/rtol 1e-6, but where they are computed in
  bf16 (XLA on the CPU keeps chains of bf16 ops in fp32, torch rounds each
  op) a moment within two bf16 ulps of the leaf's largest moment and a
  parameter within two bf16 ulps of lr per step.
* ``batch_for_step`` equal to JAX's for the dense, vlm and encoder
  families, and the prefetch iterator.
* The checkpoint counterparts of ``tests/test_checkpoint.py``: round
  trip (bf16 exact, written in place), latest and gc, a crash mid-write,
  a shape mismatch, async.
* ``StepGuard`` and ``StragglerPolicy`` as ``tests/test_training.py``
  holds them.
* Three ``make_train_step`` steps at A=2 against JAX's jitted step on the
  same batches (qwen3-0.6b ``reduce()``, fp32, lr 1e-3): loss, grad norm
  and lr at rtol 1e-6, every JAX leaf of the parameters and first moments
  after each step, the per-head ``q_norm``/``k_norm`` copies equal.  The
  parameters are held to atol 0.05·lr per step taken (rtol 1e-3): AdamW
  moves an element by about lr·m̂/(sqrt(v̂) + eps) a step, a direction that
  depends on the gradient's value only where |g| is near eps = 1e-8, and
  there an fp32 difference of 1e-10 in g moves the step by a percent of
  lr (the worst element moved 1.07e-5, 1.1% of lr).
* Accumulation equivalence (A=4 against A=1 on the same 8 sequences), loss
  descent over 60 steps on one repeated batch (as JAX's
  ``test_loss_descends_small_model``), resume determinism from a
  checkpoint, ``params_to_jax``/``adamw_state_from_jax``, the eval step,
  and the launcher: the crash-and-resume drill of
  ``tests/test_launchers.py`` with ``--device cpu``, the card by default
  (which raises here), and the mesh flags refused.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxInputShape
from repro.models import Model as JaxModel
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import PrefetchIterator as JaxPrefetch
from repro.training.data import batch_for_step as jax_batch_for_step
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed.fault_tolerance import StepGuard, StragglerPolicy
from repro_torch.models import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from repro_torch.training.data import DataConfig, PrefetchIterator, batch_for_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The steps here are tiny: one intra-op thread runs them faster than a
    pool, and keeps this file from oversubscribing the cores that parallel
    test workers share.  Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(rng):
    shapes = {"stacked": (6, 8, 16), "short": (3, 8, 16), "mat": (8, 16), "vec": (16,)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("moment_dtype,grad_clip,stacked", [
    ("float32", 1.0, "float32"), ("float32", 0.0, "float32"), ("bfloat16", 1.0, "float32"),
    ("float32", 1.0, "bfloat16"), ("bfloat16", 0.5, "bfloat16")])
def test_adamw_matches_jax(moment_dtype, grad_clip, stacked):
    """JAX's (6, 8, 16) leaf is six port leaves, views of one tensor with
    ``stack`` 6, as the trainer passes a stacked leaf's layers; the others
    are whole tensors."""
    kw = dict(lr=1e-2, moment_dtype=moment_dtype, grad_clip=grad_clip,
              stacked_update_dtype=stacked, warmup_steps=2, decay_steps=5)
    jcfg, cfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p = _tree(rng)
    keys = ["mat", "short", "vec"]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    whole = {k: torch.tensor(v) for k, v in p.items()}
    tp = [whole["stacked"][i] for i in range(6)] + [whole[k] for k in keys]
    stack = [6] * 6 + [0] * len(keys)
    jstate, tstate = jopt.init(jp, jcfg), opt.init(tp, cfg)
    for i in range(3):
        g = {k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p.items()}
        jp, jstate, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp, jcfg)
        tg = [torch.tensor(g["stacked"][j]) for j in range(6)] + [torch.tensor(g[k]) for k in keys]
        _, tstate, tm = opt.update(tg, tstate, tp, cfg, stack=stack)
        assert int(tstate.step) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        jm_ = {k: np.asarray(v, np.float32) for k, v in jstate.m.items()}
        tm_ = dict(zip(keys, tstate.m[6:]), stacked=torch.stack(tstate.m[:6]))
        for k in p:
            # XLA on the CPU keeps chains of bf16 ops in fp32 (excess precision)
            # where torch rounds each op, the two products of b1·m + (1 - b1)·g
            # included: a moment kept or computed in bf16 is held to two bf16
            # ulps of the leaf's largest moment, and a leaf whose update runs in
            # bf16 to two bf16 ulps of lr per step taken
            bf16_math = stacked == "bfloat16" and k == "stacked"
            bf16 = moment_dtype == "bfloat16" or bf16_math
            np.testing.assert_allclose(whole[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=2 ** -7 * kw["lr"] * (i + 1) if bf16_math else 1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(
                tm_[k].float().numpy(), jm_[k], rtol=2 ** -8 if bf16 else 1e-6,
                atol=2 ** -7 * float(np.abs(jm_[k]).max()) if bf16 else 1e-6, err_msg=k)
        assert tstate.m[0].dtype == getattr(torch, moment_dtype)


def test_stacked_update_dtype_rule():
    cfg = opt.AdamWConfig(stacked_update_dtype="bfloat16")
    assert opt._wdt(cfg, torch.zeros(6, 8, 16), 0) == torch.bfloat16
    assert opt._wdt(cfg, torch.zeros(3, 8, 16), 0) == torch.float32
    assert opt._wdt(cfg, torch.zeros(8, 16), 6) == torch.bfloat16      # a layer of 6
    assert opt._wdt(cfg, torch.zeros(8, 16), 4) == torch.float32       # a layer of 4
    assert opt._wdt(cfg, torch.zeros(16), 28) == torch.float32         # a norm: (L, d)


def test_lr_schedule_matches_jax():
    kw = dict(lr=3e-4, warmup_steps=7, decay_steps=50, min_lr_ratio=0.1)
    for s in (0, 1, 6, 7, 8, 30, 50, 80):
        np.testing.assert_allclose(float(opt.lr_at(opt.AdamWConfig(**kw), torch.tensor(s))),
                                   float(jopt.lr_at(jopt.AdamWConfig(**kw), jnp.int32(s))),
                                   rtol=1e-7)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llava-next-mistral-7b", "hubert-xlarge"])
def test_batch_for_step_matches_jax(arch):
    jcfg, cfg = jax_get_config(arch).reduce(), get_config(arch).reduce()
    shape, jshape = InputShape("t", "train", 600, 4), JaxInputShape("t", "train", 600, 4)
    for step in (0, 5):
        a = batch_for_step(cfg, shape, DataConfig(seed=3, accum_steps=2), step, n_patches=8)
        b = jax_batch_for_step(jcfg, jshape, JaxDataConfig(seed=3, accum_steps=2), step,
                               n_patches=8)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_iterator_matches_jax():
    jcfg, cfg = jax_get_config("qwen3-0.6b").reduce(), get_config("qwen3-0.6b").reduce()
    it = PrefetchIterator(cfg, InputShape("t", "train", 16, 8), DataConfig(seed=3, accum_steps=2),
                          start_step=5, prefetch=2)
    jit = JaxPrefetch(jcfg, JaxInputShape("t", "train", 16, 8), JaxDataConfig(seed=3, accum_steps=2),
                      start_step=5, prefetch=2)
    for want in (5, 6, 7):
        (s, a), (js, b) = next(it), next(jit)
        assert s == js == want
        np.testing.assert_array_equal(a["inputs"], b["inputs"])
        np.testing.assert_array_equal(a["targets"], b["targets"])
    it.close()
    jit.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g),
                       "h": torch.randn((4, 4), generator=g).to(torch.bfloat16),
                       "b": torch.zeros(16)},
            "opt": {"m": torch.ones((8, 16)) * 0.5 + seed, "step": torch.tensor(7, dtype=torch.int32)}}


def _like():
    return {"params": {"w": torch.empty((8, 16)), "h": torch.empty((4, 4), dtype=torch.bfloat16),
                       "b": torch.empty(16)},
            "opt": {"m": torch.empty((8, 16)), "step": torch.tensor(0, dtype=torch.int32)}}


def _equal(a, b):
    for (pa, x), (pb, y) in zip(ckpt._flatten(a), ckpt._flatten(b)):
        assert pa == pb and x.dtype == y.dtype
        assert torch.equal(x, y), pa


def test_checkpoint_roundtrip_in_place(tmp_path):
    d = str(tmp_path / "ck")
    state = _state()
    path = ckpt.save(d, state, step=3)
    like = _like()
    ptr = like["params"]["w"].data_ptr()
    restored, step = ckpt.restore_latest(d, like)
    assert step == 3
    _equal(state, restored)
    assert restored["params"]["w"].data_ptr() == ptr           # written in place
    import json
    with open(os.path.join(path, "META.json")) as f:
        dtypes = {e["path"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes["params/h"] == "bfloat16" and dtypes["opt/step"] == "int32"


def test_checkpoint_latest_picks_newest_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 5, 9, 12):
        ckpt.save(d, _state(s), step=s, keep=2)
    assert ckpt.available_steps(d) == [9, 12]
    restored, step = ckpt.restore_latest(d, _like())
    assert step == 12
    _equal(_state(12), restored)


def test_checkpoint_crash_mid_write_ignored(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, _state(1), step=1)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    with open(os.path.join(d, "step_00000009.tmp", "leaf_00000.npy"), "wb") as f:
        f.write(b"garbage")
    _, step = ckpt.restore_latest(d, _like())
    assert step == 1


def test_checkpoint_shape_mismatch_rejected_untouched(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, _state(), step=1)
    bad = _like()
    bad["params"]["w"] = torch.zeros((4, 4))
    before = bad["params"]["b"].clone()
    with pytest.raises(ValueError):
        ckpt.restore(os.path.join(d, "step_00000001"), bad)
    assert torch.equal(bad["params"]["b"], before)              # nothing written


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ck")
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ac.save(_state(s), step=s)
    ac.wait()
    assert ckpt.available_steps(d) == [2, 3]
    restored, step = ckpt.restore_latest(d, _like())
    assert step == 3
    _equal(_state(3), restored)


# ---------------------------------------------------------------------------
# step-level resilience
# ---------------------------------------------------------------------------


def test_step_guard_retries_and_skips():
    calls = {"n": 0}

    def flaky_step(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return x, None, {"loss": torch.tensor(1.0)}

    guard = StepGuard(max_retries=1, max_skips=2)
    out = guard.run(flaky_step, 42)
    assert out[0] == 42 and calls["n"] == 2

    def always_bad(x):
        raise RuntimeError("dead")

    assert guard.run(always_bad, 1) is None
    assert guard.skipped == 1
    with pytest.raises(RuntimeError):
        guard.run(always_bad, 1)
        guard.run(always_bad, 1)
    nan = StepGuard(max_retries=1, max_skips=5)
    assert nan.run(lambda: (None, None, {"loss": torch.tensor(float("nan"))})) is None
    assert nan.skipped == 1


def test_straggler_policy():
    sp = StragglerPolicy(factor=3.0)
    assert not sp.observe(1.0)
    for _ in range(5):
        assert not sp.observe(1.1)
    assert sp.observe(10.0)
    assert sp.flagged == 1
    assert sp.deadline_s == pytest.approx(3.0 * sp.ewma_s)


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    """JAX's qwen3-0.6b reduce() params and jitted step (lr 1e-3), shared."""
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    jocfg = jopt.AdamWConfig(lr=LR, warmup_steps=1)
    return jcfg, jparams, jocfg, jax.jit(jax_make_train_step(jmodel, jocfg))


def _port(jparams, cfg=None):
    cfg = cfg or get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return model


def test_three_steps_match_jax(qwen):
    jcfg, jparams, jocfg, jstep = qwen
    model = _port(jparams)
    cfg, ocfg = model.cfg, opt.AdamWConfig(lr=LR, warmup_steps=1)
    step, state = ts.make_train_step(model, ocfg), ts.init_state(model, ocfg)
    jp, js = jparams, jopt.init(jparams, jocfg)
    view = convert.leaf_view(cfg)
    named = dict(model.named_parameters())
    shape = JaxInputShape("t", "train", 32, 4)
    for s in range(3):
        batch = jax_batch_for_step(jcfg, shape, JaxDataConfig(seed=3, accum_steps=2), s)
        jp, js, jm = jstep(jp, js, batch)
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, err_msg=k)
        assert int(state.step) == int(js.step) == s + 1
        jl = convert.unstack_leaves(view, jax.tree.map(np.asarray, jp))
        jmom = convert.unstack_leaves(view, jax.tree.map(np.asarray, js.m))
        for leaf, a, mom, tm in zip(view, jl, jmom, state.m):
            got = convert.leaf_tensor(named, leaf).detach().numpy()
            np.testing.assert_allclose(got, a, atol=0.05 * LR * (s + 1), rtol=1e-3,
                                       err_msg=leaf.key)
            np.testing.assert_allclose(tm.numpy(), mom, atol=1e-7, rtol=1e-3, err_msg=leaf.key)
        for layer in model.layers:
            qk = layer.attn.qk_norm.detach()
            H = cfg.n_heads
            assert torch.equal(qk[:H], qk[:1].expand(H, -1))
            assert torch.equal(qk[H:], qk[H:H + 1].expand(cfg.n_kv_heads, -1))
    # the port's params as JAX's tree and state, one step on, still agree
    jp2 = convert.params_to_jax(model)
    st2 = convert.adamw_state_from_jax(jax.tree.map(np.asarray, js), model)
    assert int(st2.step) == 3
    for a, b in zip(jax.tree.leaves(jp2), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, atol=0.15 * LR, rtol=1e-3)


def test_params_to_jax_inverts_params_from_jax(qwen):
    _, jparams, _, _ = qwen
    back = convert.params_to_jax(_port(jparams))
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_accumulation_equivalence(qwen):
    """A=4 microbatches == A=1 with the same total batch (grad averaging)."""
    jcfg, jparams, _, _ = qwen
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (8, 33)).astype(np.int32)
    b1 = {"inputs": toks[None, :, :-1], "targets": toks[None, :, 1:]}
    b4 = {"inputs": toks.reshape(4, 2, 33)[..., :-1], "targets": toks.reshape(4, 2, 33)[..., 1:]}
    outs = []
    for b in (b1, b4):
        model = _port(jparams)
        ocfg = opt.AdamWConfig(lr=LR, warmup_steps=1)
        _, m = ts.make_train_step(model, ocfg)(ts.init_state(model, ocfg), b)
        outs.append((convert.params_to_jax(model), float(m["loss"])))
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5)
    d = [float(np.max(np.abs(a - b))) for a, b in zip(jax.tree.leaves(outs[0][0]),
                                                       jax.tree.leaves(outs[1][0]))]
    assert max(d) < 5e-3


def test_loss_descends_small_model():
    """60 optimizer steps on one repeated batch (JAX's memorization test)."""
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, decay_steps=300)
    step, state = ts.make_train_step(model, ocfg), ts.init_state(model, ocfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 4, 33)).astype(np.int32)
    batch = {"inputs": toks[..., :-1], "targets": toks[..., 1:]}
    losses = []
    for _ in range(60):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_training_resume_determinism(tmp_path):
    """A restart from step k reproduces the uninterrupted run exactly."""
    cfg = get_config("qwen3-0.6b").reduce()
    shape = InputShape("tiny", "train", 32, 4)
    dcfg = DataConfig(seed=7, accum_steps=2)
    ocfg = opt.AdamWConfig(lr=LR, warmup_steps=1)
    d = str(tmp_path / "ck")

    def fresh():
        model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
        return model, ts.make_train_step(model, ocfg), ts.init_state(model, ocfg)

    model, step, state = fresh()
    for s in range(4):
        state, _ = step(state, batch_for_step(cfg, shape, dcfg, s))
        if s == 1:
            ckpt.save(d, ts.checkpoint_state(model, state), step=s + 1)
    ref = convert.params_to_jax(model)

    model2, step2, state2 = fresh()
    start = ts.restore_latest(d, model2, state2)
    assert start == 2 and int(state2.step) == 2
    for s in range(start, 4):
        state2, _ = step2(state2, batch_for_step(cfg, shape, dcfg, s))
    for a, b in zip(jax.tree.leaves(convert.params_to_jax(model2)), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_non_finite_loss_leaves_the_model_untouched():
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
    ocfg = opt.AdamWConfig(lr=LR, warmup_steps=1)
    step, state = ts.make_train_step(model, ocfg), ts.init_state(model, ocfg)
    with torch.no_grad():
        model.final_norm[0] = float("nan")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    toks = np.zeros((1, 2, 9), np.int32)
    assert StepGuard().run(step, state, {"inputs": toks[..., :-1],
                                         "targets": toks[..., 1:]}) is None
    assert int(state.step) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) or (torch.isnan(v) == torch.isnan(before[k])).all()



def _fresh_trainer():
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
    ocfg = opt.AdamWConfig(lr=LR, warmup_steps=1)
    batch = batch_for_step(cfg, InputShape("tiny", "train", 32, 4),
                           DataConfig(seed=5, accum_steps=2), 0)
    return model, ts.make_train_step(model, ocfg), ts.init_state(model, ocfg), batch


def _leaves(model, state):
    """(the JAX leaves' values, first moments, second moments), copied."""
    view, named = convert.leaf_view(model.cfg), dict(model.named_parameters())
    return ([convert.leaf_tensor(named, leaf).detach().clone() for leaf in view],
            [m.clone() for m in state.m], [v.clone() for v in state.v])


def test_a_failure_before_the_update_is_retried_once(monkeypatch):
    """A step that fails in its forward has written nothing: ``StepGuard``
    reruns it on the same batch and the result is one step's worth, equal
    to an uninterrupted step."""
    want_model, want_step, want_state, batch = _fresh_trainer()
    want_state, _ = want_step(want_state, batch)
    model, step, state, _ = _fresh_trainer()
    real, calls = model.loss, {"n": 0}

    def flaky_loss(b):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return real(b)

    monkeypatch.setattr(model, "loss", flaky_loss)
    guard = StepGuard()
    state, _ = guard.run(step, state, batch)
    assert guard.skipped == 0 and calls["n"] == 1 + 2      # one failure, then A=2 microbatches
    assert int(state.step) == 1
    for got, want in zip(_leaves(model, state), _leaves(want_model, want_state)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_a_failure_inside_the_update_is_not_retried(tmp_path, monkeypatch):
    """A step that fails after the update began writing the parameters and
    moments in place raises ``StepStateLost`` through ``StepGuard``, with no
    retry: each JAX leaf (and its moments) holds either its value before the
    step or its value one step on, never two steps' worth.  Restoring the
    checkpoint taken before the step and stepping again then gives one
    uninterrupted step exactly."""
    from repro_torch.distributed.fault_tolerance import StepStateLost

    want_model, want_step, want_state, batch = _fresh_trainer()
    want_state, _ = want_step(want_state, batch)
    model, step, state, _ = _fresh_trainer()
    d = str(tmp_path / "ck")
    ckpt.save(d, ts.checkpoint_state(model, state), step=0)
    before = _leaves(model, state)
    real, calls = opt._wdt, {"n": 0}

    def failing_wdt(*a):                  # the third leaf's update raises
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("CUDA out of memory")
        return real(*a)

    monkeypatch.setattr(opt, "_wdt", failing_wdt)
    guard = StepGuard()
    with pytest.raises(StepStateLost):
        guard.run(step, state, batch)
    assert calls["n"] == 3 and guard.skipped == 0 and int(state.step) == 0
    monkeypatch.undo()
    after, one = _leaves(model, state), _leaves(want_model, want_state)
    moved = []
    for got, old, new in zip(after, before, one):
        for a, b, c in zip(got, old, new):
            assert not torch.equal(b, c)
            assert torch.equal(a, b) or torch.equal(a, c)
            moved.append(torch.equal(a, c))
    n = len(after[0])
    per_leaf = [moved[i::n] for i in range(n)]   # (param, m, v) of each leaf
    assert all(len(set(p)) == 1 for p in per_leaf)
    assert sum(p[0] for p in per_leaf) == 2       # the two largest leaves took their update
    assert ts.restore_latest(d, model, state) == 0
    state, _ = step(state, batch)
    for got, want in zip(_leaves(model, state), one):
        for a, b in zip(got, want):
            assert torch.equal(a, b)

def test_eval_step_is_the_ce():
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu").init_(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    ce = ts.make_eval_step(model)(model, batch)
    assert ce.grad_fn is None
    np.testing.assert_allclose(float(ce), float(model.train_().loss(batch)[1]["ce"].detach()))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _run(args, check=True):
    # one intra-op thread, as in this process (tiny steps; shared cores)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m"] + args, capture_output=True, text=True,
                       timeout=600, env=env, cwd=REPO)
    if check:
        assert p.returncode == 0, p.stderr[-3000:]
    return p


def test_train_cli_with_resume(tmp_path):
    base = ["repro_torch.launch.train", "--arch", "qwen3-0.6b", "--reduced", "--steps", "30",
            "--seq-len", "64", "--global-batch", "4", "--accum", "2", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "10", "--device", "cpu"]
    p = _run(base + ["--simulate-failure-at", "25"], check=False)
    assert p.returncode == 17
    assert "step    20 loss" in p.stdout and "done" not in p.stdout
    p = _run(base)
    assert "resumed from step 20" in p.stdout
    assert "step    29 loss" in p.stdout
    assert "done" in p.stdout


def test_train_cli_defaults_to_the_card():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])
    for flag in (["--data-parallel", "2"], ["--model-parallel", "2"], ["--compress-grads"]):
        with pytest.raises(NotImplementedError, match="item 16"):
            train.main(["--reduced", "--device", "cpu"] + flag)
