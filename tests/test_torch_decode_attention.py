"""The plain versions of the port's attention kernels against the JAX Pallas
kernels, run as the JAX package's own tests run them on the CPU
(``interpret=True``).  Shapes and ragged lengths are those of
``tests/test_mixed_batch.py`` and ``tests/test_decode_fastpath.py``.
Tolerance: fp32 atol 2e-5, rtol 1e-3.  The CUDA kernels themselves are
held against these plain versions on the card (``test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as jkernel
from repro.kernels.decode_attention import ops as jops
from repro_torch.kernels.decode_attention import kernel, ops, ref

TOL = dict(atol=2e-5, rtol=1e-3)


def _inputs(seed, B, S, Hkv, G, D, Q=None):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    qshape = (B, Hkv * G, D) if Q is None else (B, Q, Hkv * G, D)
    q = rng.standard_normal(qshape).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("Hkv,G,Q", [(2, 4, 5), (1, 8, 1), (2, 2, 8)])
def test_mixed_plain_vs_pallas(Hkv, G, Q):
    B, S, D = 3, 64, 32
    q, k, v = _inputs(0, B, S, Hkv, G, D, Q)
    lens = np.array([0, 17, S - Q], np.int32)
    want = jkernel.mixed_attention_pallas(*_j(q, k, v, lens), block_k=16, interpret=True)
    got = ops.mixed_attention(*_t(q, k, v, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mixed_plain_on_window_view():
    """The engine passes k[:, :W]; the plain version reads the view."""
    B, S, Hkv, G, D, Q, W = 2, 64, 2, 2, 32, 4, 32
    q, k, v = _inputs(1, B, S, Hkv, G, D, Q)
    lens = np.array([3, W - Q], np.int32)
    want = jkernel.mixed_attention_pallas(*_j(q, k[:, :W], v[:, :W], lens), block_k=16,
                                          interpret=True)
    tq, tk, tv, tl = _t(q, k, v, lens)
    got = ops.mixed_attention(tq, tk[:, :W], tv[:, :W], tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,Hkv,G,D", [(64, 2, 4, 32), (512, 1, 8, 32)])
def test_decode_plain_vs_pallas(S, Hkv, G, D):
    B = 4
    q, k, v = _inputs(2, B, S, Hkv, G, D)
    lens = np.array([S, S // 2 + 17, 3, 1], np.int32)
    want = jkernel.decode_attention_pallas(*_j(q, k, v, lens), block_k=min(128, S),
                                           interpret=True)
    got = ops.decode_attention(*_t(q, k, v, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k_splits", [2, 4, 8])
@pytest.mark.parametrize("S,Hkv,G,D", [(1024, 2, 4, 64), (512, 1, 8, 32)])
def test_splitk_plain_vs_pallas(k_splits, S, Hkv, G, D):
    B = 4
    q, k, v = _inputs(3, B, S, Hkv, G, D)
    # ragged: full, mid-chunk, inside the first chunk (later chunks empty), nearly empty
    lens = np.array([S, S // 2 + 17, S // k_splits - 3, 2], np.int32)
    want = jkernel.decode_attention_splitk(*_j(q, k, v, lens), k_splits=k_splits,
                                           block_k=128, interpret=True)
    got = ref.decode_attention_splitk(*_t(q, k, v, lens), k_splits=k_splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_splitk_partial_empty_chunk_is_identity():
    B, S, Hkv, G, D, K = 2, 256, 2, 2, 32, 4
    q, k, v = _inputs(4, B, S, Hkv, G, D)
    lens = torch.tensor([10, S], dtype=torch.int32)
    m, l, acc = ref.decode_attention_splitk_partial(*_t(q, k, v), lens, k_splits=K)
    assert m.shape == (B, Hkv, K, G) and acc.shape == (B, Hkv, K, G, D)
    assert torch.all(m[0, :, 1:] == ref.NEG_INF)
    assert torch.all(l[0, :, 1:] == 0) and torch.all(acc[0, :, 1:] == 0)
    assert torch.isfinite(ref.splitk_combine(m, l, acc, torch.float32)).all()


def test_auto_k_splits_matches_jax():
    for S in (64, 512, 1024, 2047, 2048, 3072, 4096, 32768):
        assert ops.auto_k_splits(S) == jops.auto_k_splits(S), S
    assert ops.auto_k_splits(4096) == 8


def test_cpu_tensors_take_the_plain_version():
    kernel.reset_launches()
    q, k, v = _inputs(5, 2, 64, 2, 2, 32)
    ops.decode_attention(*_t(q, k, v), torch.tensor([5, 64], dtype=torch.int32))
    assert all(n == 0 for n in kernel.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        kernel.decode_attention_cuda(*_t(q, k, v), torch.tensor([5, 64], dtype=torch.int32))
