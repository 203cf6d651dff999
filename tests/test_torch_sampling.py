"""Temperature > 0 sampling of the port against the JAX model's logits
(qwen3-0.6b.reduce(), CPU).

jax.random and torch's generators give different numbers from one seed,
so the port's draws are held to the distribution, not to JAX's stream: a
chi-square test of the draws' counts against N·softmax(JAX logits / T),
over the tokens whose expected count is at least 5 (the rest pooled into
one bin), must give p > 1e-3.  The seeds are fixed, so the result is the
same on every run.

* the first-token draw: ``ServingEngine._sample`` on the JAX prefill's
  last-position logits, N rows at once;
* the decode chunk's draw: ``ServingEngine._decode_steps`` (the step the
  card captures) over N identical slots that hold one prompt's cache,
  against the JAX decode's logits for that prompt.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.serving import EngineConfig, ServingEngine

N = 8192              # draws (first token) and identical slots (decode chunk)
PROMPT = 9
MIN_EXPECTED = 5
P_MIN = 1e-3
# the reduced model's random weights give logits of spread ~0.24, nearly
# uniform at T = 1; at these temperatures a sampler at 1.1 T or 0.9 T
# fails (p < 1e-24 at T = 0.1, < 0.005 at T = 0.2)
TEMPERATURES = [0.1, 0.2]


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("qwen3-0.6b").reduce()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("qwen3-0.6b").reduce()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, cfg, model


def _p_value(draws: np.ndarray, logits: np.ndarray, temperature: float) -> float:
    """Chi-square p of ``draws`` against softmax(logits / T), bins of
    expected count < MIN_EXPECTED pooled."""
    z = logits.astype(np.float64) / temperature
    p = np.exp(z - z.max())
    want = len(draws) * p / p.sum()
    got = np.bincount(draws, minlength=len(p)).astype(np.float64)
    big = want >= MIN_EXPECTED
    f_obs, f_exp = got[big], want[big]
    if not big.all():
        f_obs, f_exp = np.append(f_obs, got[~big].sum()), np.append(f_exp, want[~big].sum())
    assert big.sum() >= 50, "too few bins for the test to mean anything"
    return chisquare(f_obs, f_exp * f_obs.sum() / f_exp.sum()).pvalue


def _prompt(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT))


@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_first_token_draw_matches_softmax(pair, temperature):
    jmodel, jparams, cfg, model = pair
    ecfg = dict(max_len=32, temperature=temperature, seed=1)
    jeng = JaxServingEngine(jmodel, jparams, JaxEngineConfig(**ecfg))
    logits = np.array(jeng.prefill({"inputs": jnp.asarray(_prompt(cfg))})[0])[0]
    eng = ServingEngine(model, EngineConfig(**ecfg), device="cpu")
    gen = torch.Generator().manual_seed(2)
    draws = eng._sample(torch.from_numpy(logits).expand(N, -1), gen).numpy()
    assert _p_value(draws, logits, temperature) > P_MIN


@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_decode_chunk_draw_matches_softmax(pair, temperature):
    """One decode step of the chunk over N slots that all hold the prompt
    and carry the same token: each slot's draw is one sample of
    softmax(JAX decode logits / T)."""
    jmodel, jparams, cfg, model = pair
    max_len = 16
    prompt = _prompt(cfg)
    tok = 7
    jeng = JaxServingEngine(jmodel, jparams, JaxEngineConfig(max_len=max_len))
    _, pcache = jeng.prefill({"inputs": jnp.asarray(prompt)})
    jcache = jeng._expand_cache(pcache, 1, PROMPT)
    jl, _ = jeng.decode(jnp.full((1, 1), tok, jnp.int32), jcache, jnp.full((1,), PROMPT))
    logits = np.asarray(jl)[0]

    eng = ServingEngine(model, EngineConfig(max_len=max_len, decode_batch=N,
                                            temperature=temperature, seed=3), device="cpu")
    st = eng._session_state()
    _, pc = model.prefill(torch.from_numpy(prompt))
    for buf, leaf in zip(st.cache, pc):
        buf[:, :, :PROMPT] = leaf                       # every slot holds the prompt
    st.tok.fill_(tok)
    st.stage(np.full(N, PROMPT), np.zeros(N), np.ones(N), np.zeros(N))
    emitted = eng._decode_call(st, 1)
    assert (emitted.numpy() == tok).all()
    assert _p_value(st.tok.numpy(), logits, temperature) > P_MIN
