"""The port's control plane (``repro_torch.core``) against the JAX package.

* the §3 policy math (``core/policy.py``): ``tests/test_policy.py``'s
  properties run on the same random inputs through both packages -- modes
  equal, weights within ``RTOL`` (8 float32 ulps: both compute in float32,
  and a sum may be reduced in another order), replica counts equal but
  where XLA flushes a subnormal quotient to zero -- and Tables 1 and 2;
* ``ModeController`` step sequences (hysteresis, dwell, EWMA demand,
  measured service rates, the latency-aware variant): every decision
  equal, its weights within ``RTOL``;
* the analytic simulator's tick records over ``tests/test_orchestrator.py``'s
  scenarios: modes and ready replicas equal, weights and served load
  within ``RTOL``, queue latency and utilization within ``KNEE_RTOL``
  (1e-5: near saturation the M/D/c latency's knee multiplies the weights'
  last-ulp differences).

Everything runs on the CPU (``device="cpu"``); the card runs the same
functions on the fleet's tiers (``chip_smoke.py`` phase 5j).
"""
import dataclasses

import pytest

pytest.importorskip("hypothesis")

import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings

from repro.configs.sd21 import PAPER_COST_PER_INFERENCE, paper_deployment_units
from repro.core import policy as jpolicy
from repro.core.capacity import CapacityPool as JaxCapacityPool
from repro.core.capacity import synthetic_outage as jax_outage
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.controller import ModeController as JaxModeController
from repro.core.simulator import ClusterSimulator as JaxClusterSimulator
from repro.core.simulator import SimConfig as JaxSimConfig
from repro.core.simulator import bursty as jax_bursty
from repro.core.simulator import steady as jax_steady
from repro_torch.core import policy
from repro_torch.core.capacity import CapacityPool, synthetic_outage
from repro_torch.core.controller import ControllerConfig, ModeController, speculation_k
from repro_torch.core.deployment import DUProfile
from repro_torch.core.simulator import ClusterSimulator, SimConfig, bursty, steady
from torch_fleet_lockstep import _one_thread  # noqa: F401  (an autouse fixture)

RTOL = 8 * 2.0 ** -23          # 8 float32 ulps
KNEE_RTOL = 1e-5
CPU = torch.device("cpu")

finite_floats = st.floats(min_value=1e-4, max_value=1e4, allow_nan=False)


@st.composite
def du_arrays(draw, n_min=1, n_max=8):
    n = draw(st.integers(n_min, n_max))
    cost = draw(st.lists(finite_floats, min_size=n, max_size=n))
    t_max = draw(st.lists(finite_floats, min_size=n, max_size=n))
    avail = draw(st.lists(st.booleans(), min_size=n, max_size=n))
    return (np.array(cost, np.float32), np.array(t_max, np.float32), np.array(avail, bool))


def _pair(name, *args):
    """``policy.name`` of both packages on the same numpy inputs."""
    j = np.asarray(getattr(jpolicy, name)(*(jnp.asarray(a) for a in args)))
    p = getattr(policy, name)(*(torch.as_tensor(np.array(a)) for a in args)).numpy()
    return j, p


def _close(j, p):
    assert j.shape == p.shape and j.dtype == p.dtype, (j.dtype, p.dtype)
    np.testing.assert_allclose(p, j, rtol=RTOL, atol=0)


@given(du_arrays())
@settings(max_examples=100, deadline=None)
def test_weights_and_throughputs_match_jax(arrs):
    cost, t_max, avail = arrs
    latency = np.sqrt(t_max)
    _close(*_pair("cost_weights", cost, avail))
    _close(*_pair("latency_aware_cost_weights", cost, latency, avail))
    j, p = _pair("capacity_weights", avail)
    np.testing.assert_array_equal(p, j)
    _close(*_pair("t_target", t_max, avail))
    _close(*_pair("t_adjusted", t_max, avail))
    # the port's own properties, as tests/test_policy.py holds JAX's
    w = policy.cost_weights(torch.as_tensor(cost), torch.as_tensor(avail)).numpy()
    assert np.all(w >= 0) and np.all(w[~avail] == 0)
    if avail.any():
        assert abs(w.sum() - 1.0) < 1e-3
        idx = np.nonzero(avail)[0]
        assert all(w[i] >= w[k] - 1e-5 for i in idx for k in idx if cost[i] < cost[k])


@given(du_arrays(), st.floats(min_value=0.0, max_value=1e5),
       st.lists(st.integers(0, 4), min_size=8, max_size=8))
@settings(max_examples=100, deadline=None)
def test_switch_and_policy_step_match_jax(arrs, demand, req):
    cost, t_max, avail = arrs
    n = len(cost)
    pool = np.where(avail, 3, 0).astype(np.int32)
    requested = np.asarray(req[:n], np.int32)
    supply = float(np.sum(requested * t_max.astype(np.float64)))
    if abs(supply - demand) <= 1e-5 * max(abs(demand), 1.0):
        return          # the f32 comparison boundary: a sum order may decide it
    dem = np.float32(demand)
    jm, pm = _pair("switch_mode", requested, pool, t_max, dem)
    assert int(jm) == int(pm)
    cph = cost * 3.0
    jout = jpolicy.policy_step(*(jnp.asarray(a) for a in (cost, cph, t_max, requested, pool, dem)))
    pout = policy.policy_step(*(torch.as_tensor(np.array(a))
                                for a in (cost, cph, t_max, requested, pool, dem)))
    assert int(jout[0]) == int(pout[0])
    for a, b in zip(jout[1:], pout[1:]):
        _close(np.asarray(a), b.numpy())
    for mode in (policy.COST_OPTIMIZED, policy.CAPACITY_OPTIMIZED):
        j = np.asarray(jpolicy.select_weights(jnp.int32(mode), jnp.asarray(cost),
                                              jnp.asarray(avail)))
        p = policy.select_weights(torch.tensor(mode, dtype=torch.int32), torch.as_tensor(cost),
                                  torch.as_tensor(avail)).numpy()
        _close(j, p)
    j = np.asarray(jpolicy.desired_replicas_for_demand(jnp.asarray(jout[1]), jnp.asarray(t_max),
                                                       jnp.float32(demand)))
    p = policy.desired_replicas_for_demand(pout[1], torch.as_tensor(t_max),
                                           torch.tensor(demand, dtype=torch.float32)).numpy()
    # XLA's CPU backend flushes float32 subnormals to zero and the port
    # does not: a quotient below float32's smallest normal is ceil'd to 0
    # replicas there and to 1 here (a known difference, nowhere near a
    # demand the fleet sees)
    w = pout[1].numpy()
    q = (w * np.float32(demand)) / np.maximum(t_max, np.float32(1e-9))
    sub = (q > 0) & (q < np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(p[~sub], j[~sub])
    assert (p[sub] == 1).all() and (j[sub] == 0).all()
    for name in ("throughput_constraint_ok",):
        a, b = _pair(name, requested, t_max, dem)
        assert bool(a) == bool(b)
    a, b = _pair("capacity_constraint_ok", requested, pool)
    assert bool(a) == bool(b)
    _close(*_pair("total_cost_rate", requested, cph))
    _close(*_pair("supply", requested, t_max, np.asarray(jout[1])))


def test_float64_inputs_round_to_float32_as_jax():
    """The controller hands float64 numpy to the policy; both packages
    compute in float32 (JAX runs without x64)."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        cost = rng.uniform(1e-3, 1e3, 5)
        avail = rng.random(5) < 0.8
        j = np.asarray(jpolicy.cost_weights(cost, avail))
        p = policy.cost_weights(policy.as_f32(cost, CPU), policy.as_bool(avail, CPU)).numpy()
        assert p.dtype == j.dtype == np.float32
        _close(j, p)


def _port_profiles(jax_profiles):
    return [DUProfile(**dataclasses.asdict(d)) for d in jax_profiles]


def test_paper_tables_1_and_2():
    t_max = np.array([105.0, 130.0, 90.0, 61.0, 60.0], np.float32)
    avail = np.ones(5, bool)
    j, p = _pair("t_adjusted", t_max, avail)
    np.testing.assert_array_equal(p, j)
    assert np.allclose(p, [89.2, 89.2, 89.2, 61.0, 60.0], atol=0.05)
    for du in _port_profiles(paper_deployment_units()):
        paper = PAPER_COST_PER_INFERENCE[du.name]
        assert abs(du.cost_per_inference - paper) / paper < 0.02


def test_sums_run_left_to_right():
    """Every sum over the units is the float32 left fold, so the card (whose
    reductions pair terms in their own order) takes the CPU's decisions."""
    rng = np.random.default_rng(0)
    for n in range(1, 9):
        for _ in range(50):
            x = (rng.uniform(0.0, 1.0, n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
            want = np.float32(0.0)
            for v in x:
                want = np.float32(want + v)
            assert policy._sum(torch.tensor(x)).item() == want
    cost = torch.tensor([0.3, 0.7, 0.1, 0.9, 0.2], dtype=torch.float32)
    w = policy.cost_weights(cost, torch.ones(5, dtype=torch.bool))
    inv = 1.0 / cost
    np.testing.assert_array_equal(w.numpy(), (inv / policy._sum(inv)).numpy())


def test_speculation_k_grants():
    assert speculation_k(policy.COST_OPTIMIZED, 4, None) == 4
    assert speculation_k(policy.COST_OPTIMIZED, 4, 0.5) == 4
    assert speculation_k(policy.COST_OPTIMIZED, 4, 0.1) == 0
    assert speculation_k(policy.CAPACITY_OPTIMIZED, 4, 0.9) == 0
    assert speculation_k(policy.COST_OPTIMIZED, 0, 0.9) == 0


def test_controller_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    profiles = _port_profiles(paper_deployment_units())
    with pytest.raises(RuntimeError, match="CUDA"):
        ModeController(profiles)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterSimulator(profiles, [CapacityPool(base_capacity=1)] * 5, steady(1.0))


CONFIGS = {
    "faithful": {},
    "hysteresis_dwell": dict(hysteresis_margin=0.25, min_dwell_s=4.0),
    "ewma": dict(demand_ewma_alpha=0.2, hysteresis_margin=0.1),
    "latency_aware": dict(latency_aware=True),
}


def _decision(d):
    return (int(d.mode), bool(d.switched), float(d.demand_seen), d.tentative.tolist(),
            bool(d.cap_violated), float(d.supply_possible), float(d.hold_supply),
            int(d.prev_mode), d.t_max_used.tolist())


@pytest.mark.parametrize("measured", [False, True], ids=["profile", "measured"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_mode_controller_sequences_match_jax(config, measured):
    jdus = paper_deployment_units()
    j = JaxModeController(jdus, JaxControllerConfig(**CONFIGS[config]))
    p = ModeController(_port_profiles(jdus), ControllerConfig(**CONFIGS[config]), device="cpu")
    rng = np.random.default_rng(2 * list(CONFIGS).index(config) + measured)
    switches = 0
    for step in range(300):
        t = float(step)
        demand = float(rng.choice([50.0, 400.0, 900.0, 2500.0]) * rng.uniform(0.8, 1.2))
        pool = rng.integers(0, 12, 5) * (rng.random(5) < 0.85)
        requested = rng.integers(0, 12, 5)
        mt = rng.uniform(5.0, 150.0, 5) if measured else None
        jd = j.step(t, demand, requested, pool, measured_t_max=mt, cost_rate=0.5)
        pd = p.step(t, demand, requested, pool, measured_t_max=mt, cost_rate=0.5)
        assert _decision(pd) == _decision(jd), step
        assert pd.weights.dtype == np.asarray(jd.weights).dtype == np.float32
        _close(np.asarray(jd.weights), pd.weights)
        switches += pd.switched
    assert switches > 3                     # the sequence exercised the step


def _pools(cls, n=5, cap=20, delay=10.0):
    return [cls(base_capacity=cap, provision_delay_s=delay) for _ in range(n)]


def _scenario(name):
    """(port simulator, JAX simulator) of one tests/test_orchestrator.py
    scenario, with the same DUs, pools and demand."""
    jdus = paper_deployment_units()
    pdus = _port_profiles(jdus)
    pools = {cls: _pools(cls) for cls in (CapacityPool, JaxCapacityPool)}
    kw = dict(duration_s=900)
    demand = {CapacityPool: steady(400.0), JaxCapacityPool: jax_steady(400.0)}
    ctl = {}
    if name == "failover":
        pools[CapacityPool][0].events.append(synthetic_outage(300, 600))
        pools[JaxCapacityPool][0].events.append(jax_outage(300, 600))
    elif name == "bursty":
        pools = {cls: _pools(cls, cap=40) for cls in pools}
        demand = {CapacityPool: bursty(300.0, 500.0, 180, 40, seed=1),
                  JaxCapacityPool: jax_bursty(300.0, 500.0, 180, 40, seed=1)}
        kw = dict(duration_s=1200)
    elif name == "hysteresis":
        pools = {cls: _pools(cls, cap=3, delay=5.0) for cls in pools}
        demand = {CapacityPool: bursty(500.0, 450.0, 60, 20, seed=5),
                  JaxCapacityPool: jax_bursty(500.0, 450.0, 60, 20, seed=5)}
        kw = dict(duration_s=1200)
        ctl = dict(hysteresis_margin=0.2, min_dwell_s=120.0, demand_ewma_alpha=0.2)
    port = ClusterSimulator(pdus, pools[CapacityPool], demand[CapacityPool],
                            SimConfig(controller=ControllerConfig(**ctl), **kw), device="cpu")
    jax_ = JaxClusterSimulator(jdus, pools[JaxCapacityPool], demand[JaxCapacityPool],
                               JaxSimConfig(controller=JaxControllerConfig(**ctl), **kw))
    return port, jax_


@pytest.mark.parametrize("name", ["steady", "failover", "bursty", "hysteresis"])
def test_simulator_tick_records_match_jax(name):
    port, jax_ = _scenario(name)
    plog, jlog = port.run(), jax_.run()
    assert len(plog.records) == len(jlog.records) > 0
    for pr, jr in zip(plog.records, jlog.records):
        assert (pr.t, pr.mode, pr.demand_rps) == (jr.t, jr.mode, jr.demand_rps)
        np.testing.assert_array_equal(pr.ready, jr.ready)
        for f in ("weights", "served_rps"):
            np.testing.assert_allclose(getattr(pr, f), getattr(jr, f), rtol=RTOL, atol=1e-9)
        for f in ("latency_s", "utilization"):
            np.testing.assert_allclose(getattr(pr, f), getattr(jr, f), rtol=KNEE_RTOL, atol=1e-9)
        assert pr.dropped_rps == pytest.approx(jr.dropped_rps, rel=RTOL, abs=1e-6)
        assert pr.cost_rate == jr.cost_rate
    ps, js = plog.summary(), jlog.summary()
    assert ps["mode_switches"] == js["mode_switches"]
    for k in ps:
        assert ps[k] == pytest.approx(js[k], rel=KNEE_RTOL), k
