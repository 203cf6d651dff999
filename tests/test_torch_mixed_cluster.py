"""The fp32 mixed step's cluster split, on the CPU.

The CUDA kernel (``csrc/decode_attention.cu``: ``cluster_mixed_f32_kernel``)
gives each (sequence, kv head) ``kernel.mixed_blocks(Q, G)`` blocks of 16
(query, head) rows (``kernel.mixed_rows``: row r of block n is chunk query
(16n + r) // G, head (16n + r) % G, the JAX kernel's ``_regroup_q_chunk``
order), splits each block's keys over a thread-block cluster of
``kernel.mixed_cluster`` CTAs (``cluster_split`` over B·Hkv·blocks), CTA c
walking ``kernel.cluster_chunks(S, C)[c]`` with each row's own causal limit
(keys below cache_len + query + 1; a row with no key in a chunk keeps the
identity state m = -1e30, l = 0, acc = 0), and merges the CTAs' (m, l, acc)
states in rank order with the log-sum-exp rescale.  Here that
chunk-and-merge, written out plainly, is held against the JAX package's
``mixed_attention_pallas`` and ``mixed_attention_paged``, run as its own
tests run them on the CPU (``interpret=True``), at every C the chooser gives
for windows of 64, 544, 1024 and 2032 keys, with cache lengths that put row
limits on each side of every chunk edge, at fp32, D=32, 2 kv heads, G 1 and
2, Q 1, 8 and 13 (13 x 2 = 26 rows: a full block and a partial one).
Tolerance: fp32 atol 2e-5, rtol 1e-3.  The kernel itself is held against
the plain version on the card (``test_torch_gpu.py``).
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as jkernel
from repro_torch.kernels.decode_attention import kernel, ops

TOL = dict(atol=2e-5, rtol=1e-3)
Hkv, D = 2, 32
WINDOWS = (64, 544, 1024, 2032)
# blocks B·Hkv·mixed_blocks of the recovery tier (3 slots of 2 kv heads,
# Q 8, G 2), of 26-row blocks there, of phase 6 (B=8, 8 kv heads) and of a
# 128-block launch
BLOCKS = (6, 12, 64, 128)
PER_SM = sorted({n for by_d in kernel.MIXED_CTAS_PER_SM.values() for n in by_d.values()})
# pages of 16 (the engine's default) up to 544 keys; beyond, larger pages
# keep the interpret-mode paged kernel's grid (B, Hkv, n_blocks) small
PAGE = {64: 16, 544: 16, 1024: 64, 2032: 127}
CASES = sorted({(S, kernel.cluster_split(S, n, per)) for S in WINDOWS for n in BLOCKS
                for per in PER_SM})
QG = [(Q, G) for Q in (1, 8, 13) for G in (1, 2)]


def _cache_lens(S: int, Q: int) -> list:
    """Cache lengths whose rows' limits (cache_len + i + 1, i < Q) fall on
    each side of every chunk edge of every C the chooser gives at S."""
    edges = {S}
    for s, C in CASES:
        if s == S:
            edges |= {e for chunk in kernel.cluster_chunks(S, C) for e in chunk if e > 0}
    out = {0, S - Q}
    for e in edges:     # every limit below e; limits on both sides of e; all above
        out |= {e - Q - 1, e - (Q + 1) // 2, e}
    return sorted(n for n in out if 0 <= n <= S - Q)


@functools.cache
def _case(S: int, Q: int, G: int):
    """Inputs (numpy, seeded) and the JAX kernels' outputs: contiguous, and
    the same shapes through a pool of shuffled pages, the trash page (0)
    past each cache_len + Q."""
    rng = np.random.default_rng(S + 100 * Q + G)
    cl = np.array(_cache_lens(S, Q), np.int32)
    B = len(cl)
    q = rng.standard_normal((B, Q, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    want = np.asarray(jkernel.mixed_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, cl)), block_k=S, interpret=True))
    ps = PAGE[S]
    nb = S // ps
    P = 1 + B * nb
    tbl = (1 + rng.permutation(P - 1)[: B * nb]).reshape(B, nb).astype(np.int32)
    tbl[np.arange(nb)[None, :] >= -(-(cl + Q) // ps)[:, None]] = 0
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    want_paged = np.asarray(jkernel.mixed_attention_paged(
        *(jnp.asarray(a) for a in (q, kp, vp, tbl, cl)), interpret=True))
    return (q, k, v, cl, want), (q, kp, vp, tbl, cl, want_paged)


def _gather(pages: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """The pool in logical order: key t of row b at row t % ps of page tbl[b, t // ps]."""
    B, nb = tbl.shape
    return pages[tbl.long()].reshape(B, nb * pages.shape[1], *pages.shape[2:])


def _chunk_and_merge(q, k, v, cl, C: int) -> torch.Tensor:
    """The cluster kernel's arithmetic: for each 16-row block of each kv
    head, each CTA's (m, l, acc) over its chunk with per-row limits (the
    identity state where a row has no key there), merged in rank order
    0..C-1 with the LSE rescale, scattered back through the row map."""
    B, Q, Hq, _ = q.shape
    S = k.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    out = torch.full(q.shape, float("nan"))
    for n in range(kernel.mixed_blocks(Q, G)):
        qi, g = (torch.tensor(a) for a in zip(*kernel.mixed_rows(Q, G, n)))
        lim = cl[:, None].long() + qi[None, :] + 1                 # (B, rows)
        for h in range(Hkv):
            qb = q[:, qi, h * G + g]                               # (B, rows, D)
            states = []
            for lo, end in kernel.cluster_chunks(S, C):
                s = torch.einsum("brd,bkd->brk", qb, k[:, lo:end, h]) * scale
                seen = torch.arange(lo, end)[None, None, :] < lim[..., None]
                m = torch.where(seen, s, torch.tensor(-1e30)).amax(-1)
                p = torch.where(seen, torch.exp(s - m[..., None]), torch.tensor(0.0))
                states.append((m, p.sum(-1), torch.einsum("brk,bkd->brd", p, v[:, lo:end, h])))
            m_star = torch.stack([m for m, _, _ in states]).amax(0)
            l_star, o = torch.zeros_like(m_star), torch.zeros_like(qb)
            for m, l, acc in states:
                a = torch.exp(m - m_star)
                l_star = l_star + l * a
                o = o + acc * a[..., None]
            out[:, qi, h * G + g] = o / l_star.clamp(min=1e-30)[..., None]
    return out


def test_mixed_row_map_is_the_tpu_regroup():
    """Blocks of at most 16 rows cover the Q·G rows once, in the order of
    the JAX kernel's ``_regroup_q_chunk``: block n's row r is
    ``qg[b, h, 16n + r]``."""
    rng = np.random.default_rng(0)
    for Q, G in QG + [(200, 4), (3, 16), (1, 16), (500, 2)]:
        n_blk = kernel.mixed_blocks(Q, G)
        rows = [kernel.mixed_rows(Q, G, n) for n in range(n_blk)]
        assert n_blk == -(-Q * G // kernel.MIXED_ROWS)
        assert all(1 <= len(r) <= kernel.MIXED_ROWS for r in rows)
        assert all(len(r) == kernel.MIXED_ROWS for r in rows[:-1])
        flat = [x for r in rows for x in r]
        assert flat == [(i // G, i % G) for i in range(Q * G)]
        if Q > 13:
            continue
        q = rng.standard_normal((2, Q, Hkv * G, 4)).astype(np.float32)
        qg = np.asarray(jkernel._regroup_q_chunk(jnp.asarray(q), Hkv))
        for n, block in enumerate(rows):
            for r, (i, g) in enumerate(block):
                for h in range(Hkv):
                    np.testing.assert_array_equal(qg[:, h, 16 * n + r], q[:, i, h * G + g])


def test_mixed_cluster_chooser():
    """``mixed_cluster`` is ``cluster_split`` over B·Hkv·blocks with the
    kernel's CTAs an SM: a power of two <= 8, one wave, no more CTAs than
    128-key tiles; at phase 6's shape (B=8, 8 kv heads, Q 8, G 2, D 128,
    2048 keys; one CTA an SM) 2, at the recovery tier (B=3, 2 kv heads of
    32, Q 8, G 2, 544 keys; two an SM) 4, at prefill_paged's suffix of 500
    queries (63 blocks a kv head) and at 64 keys 1."""
    per_sm = kernel.MIXED_CTAS_PER_SM[torch.float32]
    assert per_sm.keys() == set(kernel.HEAD_DIMS)
    for S in WINDOWS + (1, 127, 128, 129, 4096):
        tiles = -(-S // kernel.CLUSTER_KEYS)
        for d in kernel.HEAD_DIMS:
            for B, H, Q, G in ((8, 8, 8, 2), (3, 2, 8, 2), (3, 2, 13, 2), (1, 8, 500, 2),
                               (1, 1, 1, 1), (8, 32, 8, 1)):
                C = kernel.mixed_cluster(S, B, H, Q, G, d)
                blocks = B * H * kernel.mixed_blocks(Q, G)
                assert C == kernel.cluster_split(S, blocks, per_sm[d])
                assert C in (1, 2, 4, 8) and C <= max(1, tiles)
                assert C == 1 or C * blocks <= kernel.CLUSTER_SMS * per_sm[d]
    assert kernel.mixed_cluster(2048, 8, 8, 8, 2, 128) == 2
    assert kernel.mixed_cluster(544, 3, 2, 8, 2, 32) == 4
    assert kernel.mixed_cluster(4096, 1, 8, 500, 2, 128) == 1
    assert kernel.mixed_cluster(64, 3, 2, 8, 2, 32) == 1


@pytest.mark.parametrize("Q,G", QG)
@pytest.mark.parametrize("S,C", CASES)
def test_mixed_cluster_merge_vs_jax(S, C, Q, G):
    (q, k, v, cl, want), _ = _case(S, Q, G)
    got = _chunk_and_merge(*(torch.from_numpy(a) for a in (q, k, v, cl)), C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("Q,G", QG)
@pytest.mark.parametrize("S,C", CASES)
def test_mixed_cluster_merge_vs_jax_paged(S, C, Q, G):
    """The pool gathered into logical order, then chunked and merged as the
    paged kernel walks it through the table."""
    _, (q, kp, vp, tbl, cl, want) = _case(S, Q, G)
    tq, tkp, tvp, ttbl, tcl = (torch.from_numpy(a) for a in (q, kp, vp, tbl, cl))
    got = _chunk_and_merge(tq, _gather(tkp, ttbl), _gather(tvp, ttbl), tcl, C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("S", WINDOWS)
def test_mixed_ops_vs_jax(S):
    """What ``ops.mixed_attention`` runs on the CPU (the plain version), on
    the same inputs, both layouts."""
    Q, G = 13, 2
    (q, k, v, cl, want), (_, kp, vp, tbl, _, want_paged) = _case(S, Q, G)
    got = ops.mixed_attention(*(torch.from_numpy(a) for a in (q, k, v, cl)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = ops.mixed_attention(*(torch.from_numpy(a) for a in (q, kp, vp)),
                              torch.from_numpy(cl), page_table=torch.from_numpy(tbl))
    np.testing.assert_allclose(got.numpy(), want_paged, **TOL)


def test_mixed_wrappers_take_cuda_tensors_only():
    (q, k, v, cl, _), (_, kp, vp, tbl, _, _) = _case(64, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mixed_attention_cuda(*(torch.from_numpy(a) for a in (q, k, v, cl)))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mixed_attention_paged_cuda(*(torch.from_numpy(a) for a in (q, kp, vp, tbl, cl)))
