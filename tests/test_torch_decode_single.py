"""The single-stage decode's cluster split, on the CPU.

The CUDA kernel (``csrc/decode_attention.cu``: ``cluster_mma_kernel`` in
bf16, ``cluster_f32_kernel`` in fp32) splits a sequence's keys over a
thread-block cluster of ``kernel.cluster_split(S, B·Hkv, per_sm)`` CTAs
(``per_sm`` the kernel's CTAs an SM holds, by dtype and head dim), CTA c
walking ``kernel.cluster_chunks(S, C)[c]``, and merges the CTAs' (m, l,
acc) states in rank order with the log-sum-exp rescale.  Here that
chunk-and-merge, computed with the port's plain split-K partial
(``ref.decode_attention_splitk_partial`` over each chunk) and a merge in
rank order, is held against the JAX package's ``decode_attention_pallas``
and ``decode_attention_paged``, run as its own tests run them on the CPU
(``interpret=True``), at every C the chooser gives for S in {64, 544,
1024, 1536, 2032}, with lengths at every chunk edge.  Tolerance: fp32
atol 2e-5, rtol 1e-3.  The kernels themselves are held against the plain
versions on the card (``test_torch_gpu.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as jkernel
from repro_torch.kernels.decode_attention import kernel, ops, ref

TOL = dict(atol=2e-5, rtol=1e-3)
# B·Hkv of the recovery tier (3 slots of reduce()'s 2 kv heads), qwen3 at
# B=3, phase 6's and zamba2's (B=8, 32 kv heads)
B_HKV = (6, 24, 64, 256)
PER_SM = sorted({n for by_d in kernel.CLUSTER_CTAS_PER_SM.values() for n in by_d.values()})
LENGTHS = (64, 544, 1024, 1536, 2032)
Hkv, G, D = 2, 2, 32
# pages of 16 (the engine's default) up to 1024 keys; beyond, larger pages
# keep the interpret-mode paged kernel's grid (B, Hkv, n_blocks) small
PAGE = {64: 16, 544: 16, 1024: 16, 1536: 48, 2032: 127}
CASES = sorted({(S, kernel.cluster_split(S, bh, n))
                for S in LENGTHS for bh in B_HKV for n in PER_SM})


def _edges(S: int) -> list:
    """Lengths at every chunk edge of every C the chooser gives at S."""
    out = {1, S}
    for s, C in CASES:
        if s == S:
            for lo, end in kernel.cluster_chunks(S, C):
                out |= {lo, lo + 1, end - 1, end}
    return sorted(n for n in out if 1 <= n <= S)


@functools.cache
def _case(S: int):
    """Inputs (numpy, seeded) and the JAX kernels' outputs at S."""
    rng = np.random.default_rng(S)
    lens = np.array(_edges(S), np.int32)
    B = len(lens)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    want = np.asarray(jkernel.decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, lens)), block_k=S, interpret=True))
    # the same keys through a pool: shuffled pages, the trash page (0) past each length
    ps = PAGE[S]
    nb = S // ps
    P = 1 + B * nb
    tbl = (1 + rng.permutation(P - 1)[: B * nb]).reshape(B, nb).astype(np.int32)
    tbl[np.arange(nb)[None, :] >= -(-lens // ps)[:, None]] = 0
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    want_paged = np.asarray(jkernel.decode_attention_paged(
        *(jnp.asarray(a) for a in (q, kp, vp, tbl, lens)), interpret=True))
    return (q, k, v, lens, want), (q, kp, vp, tbl, lens, want_paged)


def _chunk_and_merge(q, k, v, lens, C: int) -> torch.Tensor:
    """The cluster kernel's arithmetic: each CTA's chunk state by the plain
    split-K partial, merged in rank order 0..C-1 with the LSE rescale."""
    B, S = k.shape[:2]
    states = []
    for lo, end in kernel.cluster_chunks(S, C):
        chunk_lens = (lens - lo).clamp(0, end - lo).to(torch.int32)
        states.append(ref.decode_attention_splitk_partial(
            q, k[:, lo:end], v[:, lo:end], chunk_lens, k_splits=1))
    m_star = torch.stack([m[:, :, 0] for m, _, _ in states]).amax(0)
    l_star = torch.zeros_like(m_star)
    out = torch.zeros(states[0][2][:, :, 0].shape)
    for m, l, acc in states:
        a = torch.exp(m[:, :, 0] - m_star)
        l_star = l_star + l[:, :, 0] * a
        out = out + acc[:, :, 0] * a[..., None]
    out = out / l_star.clamp(min=1e-30)[..., None]
    return out.reshape(B, q.shape[1], q.shape[2])


@pytest.mark.parametrize("S", LENGTHS + (1, 127, 128, 129, 300, 4095, 4096, 32768))
def test_cluster_split_chooser(S):
    """C is a power of two <= 8 (the portable cluster size), so the grid's
    (C, Hkv, B) splits into whole (C, 1, 1) clusters; its chunks are whole
    128-key tiles in order, none empty at the full length; it is the
    largest such C with C·B·Hkv <= 132 times the CTAs an SM holds; and it
    is 1 at the fleet's default max_len of 64."""
    tiles = -(-S // kernel.CLUSTER_KEYS)
    for per_sm in PER_SM:
        wave = kernel.CLUSTER_SMS * per_sm
        for bh in B_HKV + (1, 3, 8, 66, 67, 132, 133, 198, 199, 264, 265):
            C = kernel.cluster_split(S, bh, per_sm)
            assert C in (1, 2, 4, 8) and C <= max(1, tiles)
            assert C == 1 or C * bh <= wave
            bigger = 2 * C
            assert bigger > min(kernel.CLUSTER_MAX, tiles) or bigger * bh > wave
            chunks = kernel.cluster_chunks(S, C)
            assert len(chunks) == C and chunks[0][0] == 0 and chunks[-1][1] == S
            for (lo, end), (nxt, _) in zip(chunks, chunks[1:] + [(S, S)]):
                assert lo < end == nxt and lo % kernel.CLUSTER_KEYS == 0
                assert end % kernel.CLUSTER_KEYS == 0 or end == S
        if S <= 64:
            assert all(kernel.cluster_split(S, bh, per_sm) == 1 for bh in B_HKV)


def test_cluster_split_at_the_served_shapes():
    per_sm = kernel.CLUSTER_CTAS_PER_SM
    bf16, f32 = per_sm[torch.bfloat16], per_sm[torch.float32]
    assert all(per_sm[dt].keys() == set(kernel.HEAD_DIMS) for dt in per_sm)
    # qwen3 (B=8, Hkv=8, D=128) at phase 6's 1024 keys and the served
    # max_len 1536: 2 CTAs a head in bf16 (one CTA an SM), 4 in fp32 (two)
    assert kernel.cluster_split(1024, 64, bf16[128]) == 2
    assert kernel.cluster_split(1536, 64, bf16[128]) == 2
    assert kernel.cluster_split(1024, 64, f32[128]) == 4
    # the recovery tier (reduce(): fp32, 2 kv heads of 32; B=3, 544 keys):
    # 4, as many as its 5 tiles allow; zamba2 (B=8, 32 kv heads of 80) in
    # bf16 and the default fleet's 64 keys: 1
    assert kernel.cluster_split(544, 6, f32[32]) == 4
    assert kernel.cluster_split(512, 256, bf16[80]) == 1
    assert kernel.cluster_split(64, 6, f32[32]) == 1


@pytest.mark.parametrize("S,C", CASES)
def test_cluster_merge_vs_jax(S, C):
    (q, k, v, lens, want), _ = _case(S)
    got = _chunk_and_merge(*(torch.from_numpy(a) for a in (q, k, v, lens)), C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("S,C", CASES)
def test_cluster_merge_vs_jax_paged(S, C):
    """The pool gathered into logical order (``ref.gather_pages``), then
    chunked and merged as the paged kernel walks it."""
    _, (q, kp, vp, tbl, lens, want) = _case(S)
    tq, tkp, tvp, ttbl, tlens = (torch.from_numpy(a) for a in (q, kp, vp, tbl, lens))
    k, v = ref.gather_pages(tkp, ttbl), ref.gather_pages(tvp, ttbl)
    np.testing.assert_allclose(_chunk_and_merge(tq, k, v, tlens, C).numpy(), want, **TOL)


@pytest.mark.parametrize("S", LENGTHS)
def test_single_stage_ops_vs_jax(S):
    """What ``ops.decode_attention`` runs on the CPU below the split-K
    threshold (the plain single-stage versions), on the same inputs."""
    (q, k, v, lens, want), (_, kp, vp, tbl, _, want_paged) = _case(S)
    assert ops.auto_k_splits(S) == 1
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, kp, vp)),
                               torch.from_numpy(lens), page_table=torch.from_numpy(tbl))
    np.testing.assert_allclose(got.numpy(), want_paged, **TOL)


def test_cluster_wrappers_take_cuda_tensors_only():
    q, k, v, lens, _ = _case(64)[0]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.decode_attention_cuda(*(torch.from_numpy(a) for a in (q, k, v, lens)), cluster=2)
