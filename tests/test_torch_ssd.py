"""The port's SSD plain versions at a strong decay, and the bf16 chunk
kernel's slice policy (CPU).

* ``ref.ssd_ref`` (the exact recurrence) and ``ref.ssd_chunked`` (the chunk
  form ``ops.ssd`` runs on the CPU, and one of the two oracles the card
  tests hold the CUDA kernels to) against the JAX ``ssd_ref`` at A =
  -exp(3 + 0.5 N(0, 1)) with unit x, where a 128-token chunk's cumulative
  log-decay reaches about -2000 and the chunk form's exponents cum_t - cum_s
  carry about eps |cum| of rounding; and against the JAX ``models/mamba2.py``
  ``ssd_chunked`` where it takes the length (S % 128 == 0).  Tolerance:
  atol 5e-4, rtol 1e-3 on y and the state, as ``tests/test_kernels.py``.
  Nothing is asserted about ``ssd_pallas``'s own accuracy.
* ``kernel.chunk_rows``: the channels per CTA of the bf16 chunk kernel, the
  widest of 64, 32 and 16 that divides the head's P channels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import mamba2 as jmamba2
from repro_torch.kernels.ssd_scan import kernel, ref

SCAN_TOL = dict(atol=5e-4, rtol=1e-3)


def _strong_decay_inputs(seed, S, B=2, H=2, P=32, N=16):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(3 + 0.5 N(0, 1));
    a random fp32 state0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0).astype(np.float32)
    A = (-np.exp(3.0 + 0.5 * rng.standard_normal(H))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("plain", [ref.ssd_ref, ref.ssd_chunked])
@pytest.mark.parametrize("S", [100, 128, 173, 256])
def test_ssd_plain_strong_decay_vs_jax(plain, S):
    args = _strong_decay_inputs(S + 40, S)
    got = plain(*(torch.from_numpy(a) for a in args))
    want = [jax_ssd_ref(*(jnp.asarray(a) for a in args))]
    if S % 128 == 0:
        want.append(jmamba2.ssd_chunked(*(jnp.asarray(a) for a in args)))
    for w in want:
        for g, e in zip(got, w):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), **SCAN_TOL)


@pytest.mark.parametrize("P,rows", [
    (64, 64),    # zamba2-2.7b: one slice per head (80 CTAs at B=1, 640 at B=8)
    (128, 64),   # two slices of 64
    (192, 64),
    (32, 32),
    (96, 32),    # 32 divides it, 64 does not
    (16, 16),
    (48, 16),    # only 16 divides it
    (80, 16),
    (112, 16),
])
def test_chunk_rows(P, rows):
    assert kernel.chunk_rows(P) == rows
    assert P % rows == 0 and rows in kernel.ROW_SLICES
