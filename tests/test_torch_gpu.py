"""Card-only tests of the port: every CUDA kernel against its plain version
(the paged kernels at page sizes 4, 8, 16 and 64; the flash-attention
forward causal and not, windowed, with Sk > Sq, at ragged lengths 1 to
2000, G 1, 2 and 4, head_dim 64, 80 and 128, and on strided views; the
decode and split-K kernels also at zamba2's head_dim 80 and G 1; the WKV6
recurrence at lengths 1 to 2000, 1 to 192 heads of 16, 32 and 64, with a
zero or random initial state, a slow and a strong decay, strided views,
every value-column slice width of the bf16 chunk kernel, and which kernel
the profiler sees (bf16: ``wkv6_chunk_kernel``, fp32: ``wkv6_kernel``,
one launch per call); the SSD scan
at lengths 1 to 2000, P 32 and 64, N 16 and 64, at zamba2's prefill shape,
with a slow and a strong decay, a random state, at the bf16 chunk kernel's
edges (1, 15, 16, 17, 63, 64, 65 and 2000 tokens, 64-token chunks of
16-token sub-chunks), every (N, channels per CTA) instantiation of it,
the state carried across two calls, on strided views, and which kernel
the profiler sees (bf16: ``ssd_chunk_kernel``, fp32: ``ssd_kernel``, one
launch per call); the RMSNorm in both forms at widths 128, 2560 and 5120
over 1 to 2000 rows; the single-stage decode, one launch split over a
thread-block cluster, in both dtypes, contiguous and paged (page sizes 5,
12, 16, 64), at D 32-128, G 1-16 (G = 32 on ``flash_rows_kernel``), every
cluster size at lengths 1, 127, 128, 129, each side of every chunk edge
and S, B 1, 3 and 8, NaN past every length and in every pool row not
held, two calls bit-equal, a strided ``q[:, 0]`` view, and which kernel
the profiler sees (``cluster_mma_kernel`` in bf16, ``cluster_f32_kernel``
in fp32, one per call, no memset); the split-K decode in one launch (the
last CTA of each sequence and kv head merges the chunk states), both
dtypes and layouts, K 2, 4 and 8, D 32-128, G 1, 2 and 20, at lengths
4096, 2049, each side of a chunk edge, 17, 1 and 0, against the plain
merge of its own chunk states and the plain decode, 20 launches bit-equal,
its counters 0 after every launch, grown for a larger call and kept for a
smaller one, one buffer per stream, dropped after a refused launch, and
contiguous and paged calls back to back; the fp32 mixed step, blocks of 16
(query, head) rows split over a thread-block cluster, at D 32-128, G 1, 2
and 4, Q 1, 8, 13, 64 and 200, every cluster size with cache lengths on
each side of every chunk edge, through window views and column slices of
tables (page sizes 1, 16, 48), at prefill_paged's suffix shape, NaN past
every cache_len + Q and in every pool row not held, repeats and a strided
q view bit-equal, and which kernel the profiler sees
(``cluster_mixed_f32_kernel``; ``flash_rows_kernel`` at G = 32)); and the
engine's steps as CUDA graphs on a reduced fp32 qwen3: sessions (both
layouts, the single-stage and the split-K decode, warmed or captured at
first use, greedy and at temperature 0.8) and ``generate`` token-exact with
``graphs=False`` and with equal launch counts, replays after the lengths,
flags, chunk tokens and tables change bit-equal to eager, N replays
counting N graphs' launches, and the split-K counters never made under a
capture; and the speculative verify step captured per ("spec", Qs,
window) on the same model at a 16-token vocabulary: speculating sessions
at Qs 2, 4, 8 and 16 (both layouts) token-exact with ``graphs=False``,
launches equal and the mixed-step kernel once a layer per mixed and
verify step, seeded temperature streams equal, replays after the
lengths, tables and drafts change bit-equal to eager, N replays counting
N graphs' launches, and the verdict as the graph's only output; and the
fleet's failover drill (the demo fleet, both layouts) with captured
replicas against eager ones: decisions and tokens equal.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card, which
skips when ``torch.cuda.is_available()`` is false.  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 atol 2e-5 / rtol 1e-3; bf16 atol 2e-2, and each output
row's largest error within a tenth of that row's RMS -- the sums run in
another order than the plain version's einsum, p rounds to bf16 before
the PV product and outputs round at one ulp (2^-8 relative).  The row
check is there because an output element at length L is only about
sqrt(e / L) in size (0.026 at L=4096), below the flat bf16 atol.  The
WKV6 and SSD kernels compute in fp32 from the same inputs as their plain
versions in both dtypes (the bf16 WKV6 and SSD kernels' products in 3xTF32,
about fp32's precision), so they are held at the scan tolerance of
``tests/test_kernels.py`` (atol 5e-4, rtol 1e-3) on y and the final state.
The RMSNorm kernel and its plain version round the same fp32 function once:
fp32 atol 2e-5 / rtol 1e-3, bf16 within one bf16 ulp (rtol 2^-7), and the
fused form's rounded sum bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel, ops, ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.kernels.rmsnorm import kernel as norm_kernel
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.rmsnorm import ref as norm_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-3), torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
BF16_ROW_FRAC = 0.1
# the unnormalised split-K accumulator sums up to S / k_splits terms
ACC_ATOL = {torch.float32: 8e-5, torch.bfloat16: 8e-2}


@pytest.fixture(scope="module", autouse=True)
def _kernels_built():
    """Every kernel library built before any test traces one: a profiler
    session that holds nvcc's build (~40 s for decode_attention.cu) leaves
    later sessions in the process recording no device activity every other
    time."""
    if torch.cuda.is_available():
        from repro_torch.kernels import _build

        _build.build([m.SOURCE for m in (kernel, flash_kernel, wkv_kernel, ssd_kernel,
                                         norm_kernel)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kv(rng, B, S, Hkv, D, dtype, dev):
    k = torch.as_tensor(rng.standard_normal((B, S, Hkv, D)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, S, Hkv, D)), dtype=torch.float32)
    return k.to(dev, dtype), v.to(dev, dtype)


def _close(out, want, dtype):
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        diff = (out.float() - want.float()).abs().amax(-1)
        rms = want.float().pow(2).mean(-1).sqrt()
        assert bool((diff <= BF16_ROW_FRAC * rms + 1e-6).all()), \
            float((diff / rms.clamp(min=1e-6)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hkv,G,D", [(1024, 8, 2, 128), (512, 2, 4, 64), (64, 1, 8, 32)])
def test_decode_kernel_vs_plain(cuda, dtype, S, Hkv, G, D):
    rng = np.random.default_rng(0)
    B = 4
    k, v = _kv(rng, B, S, Hkv, D, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Hkv * G, D)), dtype=torch.float32).to(cuda, dtype)
    lens = torch.tensor([S, S // 2 + 17, 1, 2], dtype=torch.int32, device=cuda)
    out = kernel.decode_attention_cuda(q, k, v, lens)
    _close(out, ref.decode_attention(q, k, v, lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_splits", [2, 8])
def test_splitk_kernels_vs_plain(cuda, dtype, k_splits):
    rng = np.random.default_rng(1)
    B, S, Hkv, G, D = 4, 4096, 8, 2, 128
    k, v = _kv(rng, B, S, Hkv, D, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Hkv * G, D)), dtype=torch.float32).to(cuda, dtype)
    # full, mid-chunk, inside the first chunk (later chunks wholly empty), one token
    lens = torch.tensor([S, 2049, 17, 1], dtype=torch.int32, device=cuda)
    m, l, acc = kernel.splitk_partial_cuda(q, k, v, lens, k_splits=k_splits)
    m_r, l_r, acc_r = ref.decode_attention_splitk_partial(q, k, v, lens, k_splits=k_splits)
    torch.testing.assert_close(m, m_r, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_r, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(acc, acc_r, atol=ACC_ATOL[dtype], rtol=1e-3)
    empty = m_r <= -1e29
    assert bool(empty.any()) and bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())
    # the one launch: against the plain merge of the kernel's own partials,
    # and end to end
    out = kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=k_splits)
    _close(out, ref.splitk_combine(m, l, acc, dtype), dtype)
    _close(out, ref.decode_attention(q, k, v, lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q", [1, 8, 32])
def test_mixed_kernel_vs_plain_window_view(cuda, dtype, Q):
    rng = np.random.default_rng(2)
    B, S, Hkv, G, D, W = 4, 4096, 8, 2, 128, 2048
    k, v = _kv(rng, B, S, Hkv, D, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Q, Hkv * G, D)), dtype=torch.float32).to(cuda, dtype)
    lens = torch.tensor([0, 17, 511, W - Q], dtype=torch.int32, device=cuda)
    kw, vw = k[:, :W], v[:, :W]                   # strided window views, read in place
    assert not kw.is_contiguous()
    out = kernel.mixed_attention_cuda(q, kw, vw, lens)
    _close(out, ref.mixed_attention(q, kw, vw, lens), dtype)


def _paged(rng, B, nb, ps, Hkv, D, lens, dtype, dev):
    """A pool of 1 + B·nb pages, shuffled tables whose rows 1.. share row
    0's first two pages, TRASH_PAGE (0) past each length."""
    P = 1 + B * nb
    k, v = _kv(rng, P, ps, Hkv, D, dtype, dev)
    tbl = rng.permutation(np.arange(1, P))[: B * nb].reshape(B, nb)
    tbl[1:, :2] = tbl[0, :2]
    used = -(-np.asarray(lens) // ps)
    tbl[np.arange(nb)[None, :] >= used[:, None]] = 0
    return k, v, torch.as_tensor(tbl, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [4, 8, 16, 64])
def test_paged_decode_kernel_vs_plain(cuda, dtype, ps):
    rng = np.random.default_rng(4)
    B, Hkv, G, D, S = 4, 8, 2, 128, 1024
    nb = S // ps
    lens_np = np.array([S, ps + 1, 1, ps])
    k, v, tbl = _paged(rng, B, nb, ps, Hkv, D, lens_np, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Hkv * G, D)), dtype=torch.float32).to(cuda, dtype)
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device=cuda)
    out = kernel.decode_attention_paged_cuda(q, k, v, tbl, lens)
    _close(out, ref.decode_attention_paged(q, k, v, tbl, lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [4, 8, 16, 64])
def test_paged_splitk_kernels_vs_plain(cuda, dtype, ps):
    rng = np.random.default_rng(5)
    B, Hkv, G, D, S = 4, 8, 2, 128, 4096
    nb = S // ps
    K = ops.auto_paged_k_splits(nb, ps)
    assert K == 8
    lens_np = np.array([S, 2049, 17, 1])
    k, v, tbl = _paged(rng, B, nb, ps, Hkv, D, lens_np, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Hkv * G, D)), dtype=torch.float32).to(cuda, dtype)
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device=cuda)
    m, l, acc = kernel.paged_splitk_partial_cuda(q, k, v, tbl, lens, k_splits=K)
    m_r, l_r, acc_r = ref.decode_attention_paged_splitk_partial(q, k, v, tbl, lens, k_splits=K)
    torch.testing.assert_close(m, m_r, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_r, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(acc, acc_r, atol=ACC_ATOL[dtype], rtol=1e-3)
    empty = m_r <= -1e29
    assert bool(empty.any()) and bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())
    _close(kernel.decode_attention_paged_splitk_cuda(q, k, v, tbl, lens, k_splits=K),
           ref.decode_attention_paged(q, k, v, tbl, lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [4, 8, 16, 64])
def test_paged_mixed_kernel_vs_plain_truncated_table(cuda, dtype, ps):
    rng = np.random.default_rng(6)
    B, Hkv, G, D, Q, S, W = 4, 8, 2, 128, 8, 4096, 2048
    nb = S // ps
    cl_np = np.array([0, 17, 511, W - Q])
    k, v, tbl = _paged(rng, B, nb, ps, Hkv, D, cl_np + Q, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Q, Hkv * G, D)), dtype=torch.float32).to(cuda, dtype)
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device=cuda)
    view = tbl[:, :W // ps]                        # a column slice, read in place
    assert not view.is_contiguous()
    out = kernel.mixed_attention_paged_cuda(q, k, v, view, cl)
    _close(out, ref.mixed_attention_paged(q, k, v, view, cl), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_mixed_kernel_prefill_paged_shape(cuda, dtype):
    """``Model.prefill_paged``'s call: B=1, a suffix of Q=1000 queries after
    a 1024-token cached prefix, through one table row whose batch stride is
    0 (as numpy's new leading axis gives)."""
    rng = np.random.default_rng(7)
    Hkv, G, D, ps, nb, start, Q = 8, 2, 128, 16, 256, 1024, 1000
    k, v, tbl = _paged(rng, 1, nb, ps, Hkv, D, [start + Q], dtype, cuda)
    row = tbl[0].as_strided((1, nb), (0, 1))
    assert row.stride(0) == 0
    q = torch.as_tensor(rng.standard_normal((1, Q, Hkv * G, D)), dtype=torch.float32).to(cuda, dtype)
    cl = torch.tensor([start], dtype=torch.int32, device=cuda)
    out = kernel.mixed_attention_paged_cuda(q, k, v, row, cl)
    _close(out, ref.mixed_attention_paged(q, k, v, row, cl), dtype)


def test_ops_dispatch_counts_launches(cuda):
    rng = np.random.default_rng(3)
    B, Hkv, G, D = 2, 2, 2, 64
    kernel.reset_launches()
    for S in (512, 2048):
        k, v = _kv(rng, B, S, Hkv, D, torch.float32, cuda)
        q = torch.as_tensor(rng.standard_normal((B, Hkv * G, D)), dtype=torch.float32).to(cuda)
        lens = torch.tensor([S, 5], dtype=torch.int32, device=cuda)
        _close(ops.decode_attention(q, k, v, lens), ref.decode_attention(q, k, v, lens),
               torch.float32)
    q4 = torch.as_tensor(rng.standard_normal((B, 4, Hkv * G, D)), dtype=torch.float32).to(cuda)
    ops.mixed_attention(q4, k, v, lens)
    for nb in (32, 128):                           # 512 and 2048 logical keys at ps=16
        kp, vp, tbl = _paged(rng, B, nb, 16, Hkv, D, [nb * 16, 5], torch.float32, cuda)
        plens = torch.tensor([nb * 16, 5], dtype=torch.int32, device=cuda)
        _close(ops.decode_attention(q, kp, vp, plens, page_table=tbl),
               ref.decode_attention_paged(q, kp, vp, tbl, plens), torch.float32)
    ops.mixed_attention(q4, kp, vp, plens - 4, page_table=tbl)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == {"decode_attention": 1, "decode_attention_splitk": 1,
                               "decode_attention_splitk_partial": 0, "mixed_attention": 1,
                               "decode_attention_paged": 1, "decode_attention_paged_splitk": 1,
                               "decode_attention_paged_splitk_partial": 0,
                               "mixed_attention_paged": 1}


def test_kernel_rejects_bad_layout(cuda):
    k = torch.zeros((1, 64, 2, 64), device=cuda)
    q = torch.zeros((1, 4, 64), device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernel.decode_attention_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2), k, lens)
    with pytest.raises(ValueError):
        kernel.decode_attention_cuda(q, k, k, lens.long())
    pool = torch.zeros((4, 16, 2, 64), device=cuda)
    tbl = torch.ones((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernel.decode_attention_paged_cuda(q, pool, pool, tbl.long(), lens)
    with pytest.raises(ValueError):
        kernel.decode_attention_paged_cuda(q, pool.transpose(1, 2).contiguous().transpose(1, 2),
                                           pool, tbl, lens)
    with pytest.raises(ValueError):
        kernel.paged_splitk_partial_cuda(q, pool, pool, tbl, lens, k_splits=3)


def _flash_inputs(rng, B, Sq, Sk, Hkv, G, D, dtype, dev):
    q = torch.as_tensor(rng.standard_normal((B, Sq, Hkv * G, D)), dtype=torch.float32)
    k, v = _kv(rng, B, Sk, Hkv, D, dtype, dev)
    return q.to(dev, dtype), k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 17, 100, 700, 2000])
def test_flash_kernel_vs_plain_causal_ragged(cuda, dtype, S):
    """The main-path shape (Hkv 8, G 2, D 128, causal) at lengths no tile divides."""
    rng = np.random.default_rng(S)
    q, k, v = _flash_inputs(rng, 1, S, S, 8, 2, 128, dtype, cuda)
    out = flash_kernel.flash_attention_cuda(q, k, v, causal=True)
    _close(out, flash_ref.flash_attention(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,Hkv,G,D,causal,window", [
    (256, 256, 4, 1, 64, False, 0),
    (256, 256, 2, 4, 128, False, 96),
    (300, 300, 8, 2, 128, True, 96),
    (100, 700, 4, 2, 64, True, 0),
    (100, 700, 2, 4, 128, True, 96),
    (64, 333, 8, 1, 128, False, 0),
])
def test_flash_kernel_vs_plain_masks(cuda, dtype, Sq, Sk, Hkv, G, D, causal, window):
    """Non-causal, sliding windows, queries right-aligned to longer keys."""
    rng = np.random.default_rng(Sq + Sk + G)
    q, k, v = _flash_inputs(rng, 2, Sq, Sk, Hkv, G, D, dtype, cuda)
    out = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
    _close(out, flash_ref.flash_attention(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q, k and v as the prefill passes them: slices of one fused projection."""
    rng = np.random.default_rng(9)
    B, S, Hq, Hkv, D = 2, 333, 16, 8, 128
    fused = torch.as_tensor(rng.standard_normal((B, S, Hq + 2 * Hkv, D)),
                            dtype=torch.float32).to(cuda, dtype)
    q, k, v = fused[:, :, :Hq], fused[:, :, Hq:Hq + Hkv], fused[:, :, Hq + Hkv:]
    assert not q.is_contiguous()
    out = flash_kernel.flash_attention_cuda(q, k, v, causal=True)
    want = flash_ref.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    _close(out, want, dtype)


def test_flash_dispatch_counts_launches(cuda):
    rng = np.random.default_rng(10)
    q, k, v = _flash_inputs(rng, 1, 50, 50, 2, 2, 64, torch.float32, cuda)
    flash_kernel.reset_launches()
    out = flash_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES == {"flash_attention": 1}
    _close(out, flash_ref.attention_ref(q, k, v), torch.float32)


def test_flash_kernel_rejects_bad_layout(cuda):
    q = torch.zeros((1, 8, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_kernel.flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 3, 64), device=cuda)
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError):                 # D not innermost
        flash_kernel.flash_attention_cuda(q, q.transpose(2, 3).contiguous().transpose(2, 3), q)
    with pytest.raises(TypeError):
        flash_kernel.flash_attention_cuda(q, q.double(), q)


def _wkv_inputs(rng, B, S, H, N, dtype, dev, *, mu=-2.0, state=True):
    """r, k, v in ``dtype``; logw = -exp(mu + 0.5 N(0,1)) fp32: mu = -2 as
    the model makes it (a log-decay near w0 = -2), -5 a slow decay (the
    state keeps thousands of tokens), 2 or 3 a strong one (log-decays of
    -7 to -20 a token); u in ``dtype``; state0 fp32 or None."""
    r, k, v = (torch.as_tensor(rng.standard_normal((B, S, H, N)), dtype=torch.float32)
               .to(dev, dtype) for _ in range(3))
    logw = -torch.exp(torch.as_tensor(mu + 0.5 * rng.standard_normal((B, S, H, N)),
                                      dtype=torch.float32)).to(dev)
    u = torch.as_tensor(rng.standard_normal((H, N)) * 0.5, dtype=torch.float32).to(dev, dtype)
    s0 = (torch.as_tensor(rng.standard_normal((B, H, N, N)), dtype=torch.float32).to(dev)
          if state else None)
    return r, k, v, logw, u, s0


def _wkv_close(r, k, v, logw, u, s0):
    """The kernel against both plain versions, on y and the final state."""
    y, st = wkv_kernel.wkv6_cuda(r, k, v, logw, u, s0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    B, _, H, N = r.shape
    zeros = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    for f in (wkv_ref.wkv6_ref, wkv_ref.wkv6_chunked):
        y_p, st_p = f(r, k, v, logw, u, zeros if s0 is None else s0)
        torch.testing.assert_close(y, y_p, atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(st, st_p, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 17, 64, 100, 700, 2000])
def test_wkv6_kernel_vs_plain(cuda, dtype, N, S):
    """Lengths no 32-token block divides, B=2, 4 heads, a random state0."""
    rng = np.random.default_rng(S + N)
    _wkv_close(*_wkv_inputs(rng, 2, S, 4, N, dtype, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1, 64])
def test_wkv6_kernel_main_path_shape(cuda, dtype, H):
    """Model.prefill's call at rwkv6-7b (B=1, S=2000, N=64) from a zero state
    (state0 None), at 64 heads and at one."""
    rng = np.random.default_rng(H)
    _wkv_close(*_wkv_inputs(rng, 1, 2000, H, 64, dtype, cuda, state=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [100, 2000])
def test_wkv6_kernel_slow_decay(cuda, dtype, S):
    """logw = -exp(-5 + 0.5 N(0,1)): a fault at a token-block boundary
    cannot hide behind a short memory here."""
    rng = np.random.default_rng(S + 1)
    _wkv_close(*_wkv_inputs(rng, 2, S, 4, 64, dtype, cuda, mu=-5.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mu", [2.0, 3.0])
@pytest.mark.parametrize("S", [100, 2000])
def test_wkv6_kernel_strong_decay(cuda, dtype, mu, S):
    """logw = -exp(mu + 0.5 N(0,1)), mu 2 or 3: a chunk's cumulative
    log-decay reaches -500 to -1300, so an exponent taken as a product of a
    growing and a shrinking factor would overflow fp32; every exponent of
    the chunk kernel is the difference of two stored cumsums, <= 0."""
    rng = np.random.default_rng(S + int(10 * mu))
    _wkv_close(*_wkv_inputs(rng, 2, S, 4, 64, dtype, cuda, mu=mu))


@pytest.mark.parametrize("B,H,N,cols", [(2, 4, 16, 16), (2, 4, 32, 16), (1, 128, 32, 32),
                                        (2, 4, 64, 16), (1, 48, 64, 32), (3, 64, 64, 64)])
def test_wkv6_chunk_kernel_every_slice_width(cuda, B, H, N, cols):
    """Each (N, value columns per CTA) instantiation of the bf16 chunk
    kernel, reached through the wrapper's own choice of slice width (the
    same on a 114- or a 132-SM card), from a random state."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert wkv_kernel.chunk_cols(B, H, N, sms) == cols
    rng = np.random.default_rng(B * H + N)
    _wkv_close(*_wkv_inputs(rng, B, 150, H, N, torch.bfloat16, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_reads_strided_views(cuda, dtype):
    """r, k, v, logw as slices of wider buffers (batch and sequence strides
    that are not the dense ones), read in place."""
    rng = np.random.default_rng(11)
    B, S, H, N = 2, 333, 4, 64
    fused = torch.as_tensor(rng.standard_normal((B, S, 3, H, N)),
                            dtype=torch.float32).to(cuda, dtype)
    r, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    assert not r.is_contiguous()
    *_, logw, u, s0 = _wkv_inputs(rng, B, 2 * S, H, N, dtype, cuda)
    logw = logw[:, ::2]
    _wkv_close(r, k, v, logw, u, s0)
    y, st = wkv_kernel.wkv6_cuda(r, k, v, logw, u, s0)
    y_c, st_c = wkv_kernel.wkv6_cuda(r.contiguous(), k.contiguous(), v.contiguous(),
                                     logw.contiguous(), u, s0)
    assert torch.equal(y, y_c) and torch.equal(st, st_c)


def test_wkv6_bf16_kernel_rejects_misaligned_views(cuda):
    """The bf16 kernel stages r, k, v, logw with 16-byte copies: a view off
    a 16-byte boundary raises, and the same view in fp32 (read by plain
    loads) runs."""
    B, S, H, N = 1, 40, 2, 16
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.zeros((B, S, H * N + 1), device=cuda, dtype=dtype)
        x = buf[:, :, 1:].unflatten(-1, (H, N))
        logw = torch.full((B, S, H, N), -0.1, device=cuda)
        u = torch.zeros((H, N), device=cuda, dtype=dtype)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="16-byte"):
                wkv_kernel.wkv6_cuda(x, x, x, logw, u)
        else:
            y, _ = wkv_kernel.wkv6_cuda(x, x, x, logw, u)
            assert bool((y == 0).all())


def test_wkv6_dispatch_counts_launches(cuda):
    rng = np.random.default_rng(12)
    r, k, v, logw, u, _ = _wkv_inputs(rng, 1, 50, 2, 32, torch.float32, cuda)
    wkv_kernel.reset_launches()
    y, st = wkv_ops.wkv6(r, k, v, logw, u)
    torch.cuda.synchronize()
    assert wkv_kernel.LAUNCHES == {"wkv6": 1}
    zeros = torch.zeros((1, 2, 32, 32), device=cuda)
    y_p, st_p = wkv_ref.wkv6_ref(r, k, v, logw, u, zeros)
    torch.testing.assert_close(y, y_p, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(st, st_p, atol=5e-4, rtol=1e-3)


def test_wkv6_kernel_rejects_bad_layout(cuda):
    x = torch.zeros((1, 8, 2, 128), device=cuda)
    u = torch.zeros((2, 128), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        wkv_kernel.wkv6_cuda(x, x, x, x, u)
    x = torch.zeros((1, 8, 2, 64), device=cuda)
    u = torch.zeros((2, 64), device=cuda)
    with pytest.raises(TypeError):                  # logw must be fp32
        wkv_kernel.wkv6_cuda(x.bfloat16(), x.bfloat16(), x.bfloat16(), x.bfloat16(),
                             u.bfloat16())
    with pytest.raises(TypeError):                  # u in r's dtype
        wkv_kernel.wkv6_cuda(x, x, x, x, u.bfloat16())
    with pytest.raises(ValueError):                 # (H, N) not dense
        wkv_kernel.wkv6_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), x, x, x, u)
    with pytest.raises(ValueError):                 # state0 of the wrong shape
        wkv_kernel.wkv6_cuda(x, x, x, x, u, torch.zeros((1, 2, 64, 32), device=cuda))


# ---------------------------------------------------------------------------
# zamba2's shared attention: head_dim 80, one q head per kv head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_vs_plain_head_dim_80(cuda, dtype):
    rng = np.random.default_rng(20)
    B, S, Hkv, D = 4, 1024, 32, 80
    k, v = _kv(rng, B, S, Hkv, D, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Hkv, D)), dtype=torch.float32).to(cuda, dtype)
    lens = torch.tensor([S, S // 2 + 17, 1, 33], dtype=torch.int32, device=cuda)
    _close(kernel.decode_attention_cuda(q, k, v, lens), ref.decode_attention(q, k, v, lens),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splitk_kernels_vs_plain_head_dim_80(cuda, dtype):
    """The hybrid decode step's call: max_len 4096 (K=8), 32 kv heads of 80."""
    rng = np.random.default_rng(21)
    B, S, Hkv, D, K = 8, 4096, 32, 80, 8
    assert ops.auto_k_splits(S) == K
    k, v = _kv(rng, B, S, Hkv, D, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Hkv, D)), dtype=torch.float32).to(cuda, dtype)
    lens = torch.tensor([S, 2049, 17, 1, 600, 1999, 3000, 4095], dtype=torch.int32, device=cuda)
    m, l, acc = kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K)
    m_r, l_r, acc_r = ref.decode_attention_splitk_partial(q, k, v, lens, k_splits=K)
    torch.testing.assert_close(m, m_r, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_r, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(acc, acc_r, atol=ACC_ATOL[dtype], rtol=1e-3)
    out = ops.decode_attention(q, k, v, lens)
    _close(out, ref.splitk_combine(m, l, acc, dtype), dtype)
    _close(out, ref.decode_attention(q, k, v, lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 17, 100, 700, 2000])
def test_flash_kernel_vs_plain_head_dim_80(cuda, dtype, S):
    """The hybrid prefill's call (32 q and 32 kv heads of 80, causal), with
    q, k and v as slices of one fused projection, as the prefill passes them."""
    rng = np.random.default_rng(S + 80)
    H, D = 32, 80
    fused = torch.as_tensor(rng.standard_normal((1, S, 3 * H, D)),
                            dtype=torch.float32).to(cuda, dtype)
    q, k, v = fused[:, :, :H], fused[:, :, H:2 * H], fused[:, :, 2 * H:]
    out = flash_kernel.flash_attention_cuda(q, k, v, causal=True)
    _close(out, flash_ref.flash_attention(q.contiguous(), k.contiguous(), v.contiguous()), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_vs_plain_head_dim_80_masks(cuda, dtype):
    rng = np.random.default_rng(81)
    for Sq, Sk, G, causal, window in ((256, 256, 1, False, 0), (100, 700, 2, True, 96)):
        q, k, v = _flash_inputs(rng, 2, Sq, Sk, 4, G, 80, dtype, cuda)
        out = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
        _close(out, flash_ref.flash_attention(q, k, v, causal=causal, window=window), dtype)


# ---------------------------------------------------------------------------
# the Mamba-2 SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, B, S, H, P, N, dtype, dev, *, slow=False, state=True, mu=None):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1)) fp32; A =
    -exp(0.3 N(0, 1)), or with ``slow`` -1e-3 times that, where the state
    keeps thousands of steps, or with ``mu`` -exp(mu + 0.5 N(0, 1)) from the
    same draw; state0 fp32 or None.  With ``slow`` x is
    scaled by 1/16 (exact in bf16), so y keeps the scale of the fast case
    (mean |y| ~9 rather than ~130) that the scan tolerance is set for: at
    unit x the two plain versions alone differ by up to 2.9e-3 at S=2000,
    fp32 summation order over 2000 steps, not a fault."""
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)
    x = f32(rng.standard_normal((B, S, H, P)) / (16.0 if slow else 1.0)).to(dtype)
    dt = torch.nn.functional.softplus(f32(rng.standard_normal((B, S, H))))
    z = f32(rng.standard_normal(H))
    A = -torch.exp(mu + 0.5 * z) if mu is not None else (
        -(1e-3 if slow else 1.0) * torch.exp(0.3 * z))
    Bm, Cm = (f32(rng.standard_normal((B, S, N))).to(dtype) for _ in range(2))
    s0 = f32(rng.standard_normal((B, H, P, N))) if state else None
    return x, dt, A, Bm, Cm, s0


def _ssd_close(x, dt, A, Bm, Cm, s0):
    """The kernel against both plain versions, on y and the final state."""
    y, st = ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, s0)
    B, _, H, P = x.shape
    zeros = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    for f in (ssd_ref.ssd_ref, ssd_ref.ssd_chunked):
        y_p, st_p = f(x, dt, A, Bm, Cm, zeros if s0 is None else s0)
        torch.testing.assert_close(y, y_p, atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(st, st_p, atol=5e-4, rtol=1e-3)
    return y, st


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,N", [(32, 16), (32, 64), (64, 16), (64, 64)])
@pytest.mark.parametrize("S", [1, 17, 100, 700, 2000])
def test_ssd_kernel_vs_plain(cuda, dtype, P, N, S):
    """Lengths no 32-token block divides, B=2, 3 heads, a random state0."""
    rng = np.random.default_rng(S + P + N)
    _ssd_close(*_ssd_inputs(rng, 2, S, 3, P, N, dtype, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_main_path_shape(cuda, dtype):
    """Model.prefill's call at zamba2-2.7b (B=1, S=2000, H=80, P=N=64) from
    a zero state (state0 None)."""
    rng = np.random.default_rng(30)
    _ssd_close(*_ssd_inputs(rng, 1, 2000, 80, 64, 64, dtype, cuda, state=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [100, 2000])
def test_ssd_kernel_slow_decay(cuda, dtype, S):
    """A about -1e-3: a fault at a token-block boundary cannot hide behind a
    short memory here."""
    rng = np.random.default_rng(S + 31)
    _ssd_close(*_ssd_inputs(rng, 2, S, 4, 64, 64, dtype, cuda, slow=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [100, 2000])
def test_ssd_kernel_strong_decay(cuda, dtype, S):
    """A = -exp(3 + 0.5 N(0, 1)) at unit x: a 64-token chunk's cumulative
    log-decay reaches about -2000, so an exponent taken from the chunk's
    cumsum as a whole would carry about its rounding; the chunk kernel takes
    every exponent from sub-chunk cumsums of at most 16 terms."""
    rng = np.random.default_rng(S + 35)
    _ssd_close(*_ssd_inputs(rng, 2, S, 4, 64, 64, dtype, cuda, mu=3.0))


@pytest.mark.parametrize("mu", [None, 3.0])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 2000])
def test_ssd_chunk_kernel_edges(cuda, mu, S):
    """The bf16 chunk kernel at the edges of its 16-token sub-chunks and
    64-token chunks (and a whole prefill), from a random state, at the
    default and a strong decay."""
    rng = np.random.default_rng(S + 36 + (0 if mu is None else 1000))
    _ssd_close(*_ssd_inputs(rng, 2, S, 3, 64, 64, torch.bfloat16, cuda, mu=mu))


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("B,H,P,rows", [(1, 80, 64, 64), (1, 40, 32, 32), (2, 4, 48, 16)])
def test_ssd_chunk_kernel_every_slice_width(cuda, B, H, P, N, rows):
    """Each (N, channels per CTA) instantiation of the bf16 chunk kernel,
    reached through the wrapper's own choice of slice width (P=48: three
    slices of 16), from a random state."""
    assert ssd_kernel.chunk_rows(P) == rows
    rng = np.random.default_rng(B * H + N)
    _ssd_close(*_ssd_inputs(rng, B, 150, H, P, N, torch.bfloat16, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_carries_state(cuda, dtype):
    """Two calls carrying the state (split at a token no chunk boundary
    falls on) equal one call."""
    rng = np.random.default_rng(37)
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, 2, 300, 4, 64, 64, dtype, cuda)
    y, st = ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, s0)
    h = 70
    y1, st1 = ssd_kernel.ssd_cuda(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], s0)
    y2, st2 = ssd_kernel.ssd_cuda(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(st2, st, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_strided_views(cuda, dtype):
    """x, B and C as mamba2_layer passes them: slices of one conv output
    (sequence stride H*P + 2N), dt a slice of a wider buffer; the result
    equals the kernel on contiguous copies bit for bit."""
    rng = np.random.default_rng(32)
    B, S, H, P, N = 2, 333, 4, 64, 64
    conv = torch.as_tensor(rng.standard_normal((B, S, H * P + 2 * N)),
                           dtype=torch.float32).to(cuda, dtype)
    x = conv[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    assert not x.is_contiguous() and not Bm.is_contiguous()
    _, dt, A, _, _, s0 = _ssd_inputs(rng, B, 2 * S, H, P, N, dtype, cuda)
    dt = dt[:, ::2]
    _ssd_close(x, dt, A, Bm, Cm, s0)
    y, st = ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, s0)
    y_c, st_c = ssd_kernel.ssd_cuda(x.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                                    Cm.contiguous(), s0)
    assert torch.equal(y, y_c) and torch.equal(st, st_c)


def test_ssd_dispatch_counts_launches(cuda):
    rng = np.random.default_rng(33)
    x, dt, A, Bm, Cm, _ = _ssd_inputs(rng, 1, 50, 2, 32, 16, torch.float32, cuda)
    ssd_kernel.reset_launches()
    y, st = ssd_ops.ssd(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES == {"ssd": 1}
    zeros = torch.zeros((1, 2, 32, 16), device=cuda)
    y_p, st_p = ssd_ref.ssd_ref(x, dt, A, Bm, Cm, zeros)
    torch.testing.assert_close(y, y_p, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(st, st_p, atol=5e-4, rtol=1e-3)


def test_ssd_kernel_rejects_bad_layout(cuda):
    rng = np.random.default_rng(34)
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, 1, 8, 2, 32, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="state size"):
        ssd_kernel.ssd_cuda(x, dt, A, torch.zeros((1, 8, 128), device=cuda),
                            torch.zeros((1, 8, 128), device=cuda))
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_kernel.ssd_cuda(x[..., :24], dt, A, Bm, Cm)
    with pytest.raises(TypeError):                  # dt must be fp32
        ssd_kernel.ssd_cuda(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(TypeError):                  # B and C in x's dtype
        ssd_kernel.ssd_cuda(x, dt, A, Bm.bfloat16(), Cm.bfloat16())
    with pytest.raises(ValueError):                 # (H, P) not dense
        ssd_kernel.ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="16-byte"):    # a sequence stride off 16 bytes
        wide = torch.zeros((1, 8, 17), device=cuda)
        ssd_kernel.ssd_cuda(x, dt, A, wide[..., :16], Cm)
    with pytest.raises(ValueError):                 # state0 of the wrong shape
        ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, s0[..., :8].contiguous())


def test_ssd_launch_rejects_a_bad_slice(cuda):
    """A channel slice the bf16 kernel has no instantiation for, or one that
    does not divide P, is refused, not run."""
    rng = np.random.default_rng(38)
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, 1, 8, 2, 32, 16, torch.bfloat16, cuda)
    ssd_kernel.reset_launches()
    for rows in (8, 48, 64):                        # no kernel; no kernel; > P
        with pytest.raises(RuntimeError, match="slice"):
            ssd_kernel.launch(x, dt, A, Bm, Cm, s0, rows)
    assert ssd_kernel.LAUNCHES == {"ssd": 0}


# ---------------------------------------------------------------------------
# RMSNorm, plain and fused with the residual add
# ---------------------------------------------------------------------------


def _norm_close(out, want, dtype):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), want.float(), atol=1e-5, rtol=2 ** -7)
    else:
        torch.testing.assert_close(out, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("M", [1, 7, 2000])
@pytest.mark.parametrize("d", [128, 2560, 5120])
def test_rmsnorm_kernel_vs_plain(cuda, dtype, fused, M, d):
    rng = np.random.default_rng(M + d)

    def t(shape, scale=1.0):
        return (torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32)
                .to(cuda, dtype))
    x, w = t((M, d), 3.0), t((d,))
    r = t((M, d)) if fused else None
    out, summed = norm_kernel.rmsnorm_cuda(x, w, r, eps=1e-6)
    want, want_sum = norm_ref.rmsnorm_ref(x, w, r, 1e-6)
    _norm_close(out, want, dtype)
    assert torch.equal(summed, want_sum)
    if not fused:
        assert summed is x


def test_rmsnorm_dispatch_counts_launches(cuda):
    x = torch.randn((2, 3, 256), device=cuda)
    w = torch.randn(256, device=cuda)
    norm_kernel.reset_launches()
    out = norm_ops.rms_norm(x, w)
    h, s = norm_ops.rmsnorm(x, w, x)
    torch.cuda.synchronize()
    assert norm_kernel.LAUNCHES == {"rmsnorm": 1, "rmsnorm_fused": 1}
    _norm_close(out, norm_ref.rmsnorm_ref(x, w)[0], torch.float32)
    _norm_close(h, norm_ref.rmsnorm_ref(x, w, x)[0], torch.float32)


def test_rmsnorm_kernel_rejects_bad_layout(cuda):
    x = torch.zeros((4, 256), device=cuda)
    w = torch.ones(256, device=cuda)
    with pytest.raises(ValueError):                 # not contiguous
        norm_kernel.rmsnorm_cuda(x.t().contiguous().t(), w)
    with pytest.raises(ValueError):                 # a width off 16-byte packs
        norm_kernel.rmsnorm_cuda(torch.zeros((4, 6), device=cuda), torch.ones(6, device=cuda))
    with pytest.raises(TypeError):                  # the weight in x's dtype
        norm_kernel.rmsnorm_cuda(x, w.bfloat16())
    with pytest.raises(ValueError):                 # the residual of another shape
        norm_kernel.rmsnorm_cuda(x, w, torch.zeros((2, 256), device=cuda))


# ---------------------------------------------------------------------------
# the bf16 tensor-core attention kernels (mixed step and flash forward)
# ---------------------------------------------------------------------------

MIXED_LENS = (0, 37, 203)        # cached lengths: none, and off any 64-key tile


def _mixed_inputs(rng, D, G, Q, dtype, dev, Hkv=2):
    """q (3, Q, Hkv·G, D) and a contiguous cache with room for every chunk."""
    B = len(MIXED_LENS)
    S = max(MIXED_LENS) + Q + 50
    k, v = _kv(rng, B, S, Hkv, D, dtype, dev)
    q = torch.as_tensor(rng.standard_normal((B, Q, Hkv * G, D)),
                        dtype=torch.float32).to(dev, dtype)
    return q, k, v, torch.tensor(MIXED_LENS, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("Q", [1, 3, 8, 32, 500])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
def test_mixed_mma_kernel_vs_plain(cuda, D, G, Q):
    """One to 63 m16 tiles per (b, kv head): the warps split each tile's
    keys 4 or 2 ways, or take an m-tile each."""
    rng = np.random.default_rng(D + 10 * G + Q)
    q, k, v, cl = _mixed_inputs(rng, D, G, Q, torch.bfloat16, cuda)
    out = kernel.mixed_attention_cuda(q, k, v, cl)
    _close(out, ref.mixed_attention(q, k, v, cl), torch.bfloat16)


@pytest.mark.parametrize("ps", [4, 5, 12, 16, 64])   # 5 and 12 take the division path
@pytest.mark.parametrize("Q", [1, 3, 8, 32, 500])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
def test_paged_mixed_mma_kernel_vs_plain(cuda, D, G, Q, ps):
    rng = np.random.default_rng(D + 10 * G + Q + ps)
    B, Hkv = len(MIXED_LENS), 2
    cl_np = np.array(MIXED_LENS)
    nb = -(-(cl_np.max() + Q + 50) // ps)
    k, v, tbl = _paged(rng, B, nb, ps, Hkv, D, cl_np + Q, torch.bfloat16, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Q, Hkv * G, D)),
                        dtype=torch.float32).to(cuda, torch.bfloat16)
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device=cuda)
    out = kernel.mixed_attention_paged_cuda(q, k, v, tbl, cl)
    _close(out, ref.mixed_attention_paged(q, k, v, tbl, cl), torch.bfloat16)


@pytest.mark.parametrize("Sq,Sk,Hkv,G,D,causal,window", [
    (300, 300, 2, 8, 128, True, 0),      # G = 8: 8 queries per 64-row block
    (333, 333, 1, 8, 64, False, 0),
    (150, 1000, 2, 8, 80, True, 0),      # Sq < Sk, G = 8
    (300, 300, 2, 4, 128, True, 16),     # rows whose first tile is wholly masked
    (256, 256, 4, 2, 64, False, 8),
    (70, 900, 2, 2, 80, True, 24),
])
def test_flash_mma_kernel_vs_plain(cuda, Sq, Sk, Hkv, G, D, causal, window):
    rng = np.random.default_rng(Sq + Sk + G + D)
    q, k, v = _flash_inputs(rng, 2, Sq, Sk, Hkv, G, D, torch.bfloat16, cuda)
    out = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
    _close(out, flash_ref.flash_attention(q, k, v, causal=causal, window=window),
           torch.bfloat16)


def _poisoned(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with NaN in the leading-axis-flattened rows ``rows``."""
    out = t.clone()
    out.view(-1, *t.shape[2:])[rows] = float("nan")
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_kernel_ignores_nan_past_the_lengths(cuda, dtype):
    """NaN in every cache row at or past cache_len + Q, read through a
    window view: the output is finite and equals the clean cache's."""
    rng = np.random.default_rng(30)
    D, G, Q = 128, 2, 8
    q, k, v, cl = _mixed_inputs(rng, D, G, Q, dtype, cuda, Hkv=8)
    B, S = k.shape[:2]
    W = S - 10
    pos = torch.arange(S, device=cuda)
    dead = (pos[None, :] >= (cl[:, None] + Q)).reshape(-1)
    kp, vp = _poisoned(k, dead), _poisoned(v, dead)
    clean = kernel.mixed_attention_cuda(q, k[:, :W], v[:, :W], cl)
    out = kernel.mixed_attention_cuda(q, kp[:, :W], vp[:, :W], cl)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, clean)
    _close(clean, ref.mixed_attention(q, k[:, :W], v[:, :W], cl), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [5, 12, 16])
def test_paged_mixed_kernel_ignores_nan_in_the_pool(cuda, dtype, ps):
    """NaN in the trash page (0) and in every pool row no sequence holds
    below its cache_len + Q (the tails of partly used pages), at page sizes
    that are and are not powers of two."""
    rng = np.random.default_rng(31 + ps)
    D, G, Q, Hkv = 128, 2, 8, 8
    B = len(MIXED_LENS)
    cl_np = np.array(MIXED_LENS)
    nb = -(-(cl_np.max() + Q + 50) // ps)
    k, v, tbl = _paged(rng, B, nb, ps, Hkv, D, cl_np + Q, dtype, cuda)
    q = torch.as_tensor(rng.standard_normal((B, Q, Hkv * G, D)),
                        dtype=torch.float32).to(cuda, dtype)
    cl = torch.as_tensor(cl_np, dtype=torch.int32, device=cuda)
    live = torch.zeros(k.shape[0] * ps, dtype=torch.bool, device=cuda)
    for b in range(B):
        pos = torch.arange(int(cl_np[b]) + Q, device=cuda)
        live[tbl[b, pos // ps].long() * ps + pos % ps] = True
    assert not bool(live[:ps].any())               # nothing live on the trash page
    kp, vp = _poisoned(k, ~live), _poisoned(v, ~live)
    clean = kernel.mixed_attention_paged_cuda(q, k, v, tbl, cl)
    out = kernel.mixed_attention_paged_cuda(q, kp, vp, tbl, cl)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, clean)
    _close(clean, ref.mixed_attention_paged(q, k, v, tbl, cl), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ignores_nan_past_the_sequence(cuda, dtype):
    """q, k and v as the first Sq / Sk rows of buffers whose later rows are
    NaN (the padding rows of the last query block and the keys past Sk)."""
    rng = np.random.default_rng(32)
    B, Sq, Sk, Hkv, G, D, extra = 2, 77, 333, 8, 2, 128, 100
    q, k, v = _flash_inputs(rng, B, Sq + extra, Sk + extra, Hkv, G, D, dtype, cuda)
    qn, kn, vn = (torch.cat([t[:, :n], torch.full_like(t[:, n:], float("nan"))], 1)
                  for t, n in ((q, Sq), (k, Sk), (v, Sk)))
    for causal, window in ((True, 0), (False, 0), (True, 40)):
        clean = flash_kernel.flash_attention_cuda(q[:, :Sq].contiguous(), k[:, :Sk].contiguous(),
                                                  v[:, :Sk].contiguous(), causal=causal,
                                                  window=window)
        out = flash_kernel.flash_attention_cuda(qn[:, :Sq], kn[:, :Sk], vn[:, :Sk],
                                                causal=causal, window=window)
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, clean)


def test_mixed_kernel_rejects_unaligned_bf16_q(cuda):
    k = torch.zeros((2, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    lens = torch.ones((2,), dtype=torch.int32, device=cuda)
    wide = torch.zeros((2, 4, 4 * 64 + 4), device=cuda, dtype=torch.bfloat16)
    q = wide[..., 4:].unflatten(-1, (4, 64))        # 8 bytes off, rows 520 bytes apart
    with pytest.raises(ValueError, match="16-byte"):
        kernel.mixed_attention_cuda(q, k, k, lens)
    pool = torch.zeros((4, 16, 2, 64), device=cuda, dtype=torch.bfloat16)
    tbl = torch.ones((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        kernel.mixed_attention_paged_cuda(q, pool, pool, tbl, lens)


# ---------------------------------------------------------------------------
# the bf16 split-K decode partial on the tensor cores (splitk_mma_kernel)
# ---------------------------------------------------------------------------

SPLIT_S = 1024                   # K=2, 4, 8: chunks of 4, 2 and 1 staged 128-key tiles


def _split_lens(S, K):
    """One token; inside the first chunk (every later chunk empty); on a
    chunk boundary; one past it; the whole cache."""
    ck = S // K
    return [1, ck // 2 + 3, ck, ck + 1, S]


def _partial_close(got, want, dtype):
    (m, l, acc), (m_r, l_r, acc_r) = got, want
    torch.testing.assert_close(m, m_r, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_r, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(acc, acc_r, atol=ACC_ATOL[dtype], rtol=1e-3)
    empty = m_r <= -1e29
    assert bool(empty.any())
    # a chunk wholly past the length is the identity state, exactly
    assert torch.equal(m[empty], m_r[empty])
    assert bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())


def _q(rng, B, Hq, D, dtype, dev):
    return torch.as_tensor(rng.standard_normal((B, Hq, D)), dtype=torch.float32).to(dev, dtype)


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
def test_splitk_mma_kernel_vs_plain(cuda, D, G, K):
    rng = np.random.default_rng(D + 10 * G + K)
    Hkv, lens_l = 2, _split_lens(SPLIT_S, K)
    B = len(lens_l)
    k, v = _kv(rng, B, SPLIT_S, Hkv, D, torch.bfloat16, cuda)
    q = _q(rng, B, Hkv * G, D, torch.bfloat16, cuda)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    _partial_close(kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K),
                   ref.decode_attention_splitk_partial(q, k, v, lens, k_splits=K),
                   torch.bfloat16)
    _close(kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K),
           ref.decode_attention(q, k, v, lens), torch.bfloat16)


@pytest.mark.parametrize("K", [2, 8])
@pytest.mark.parametrize("D,G", [(128, 2), (80, 1)])            # qwen3-0.6b, zamba2-2.7b
@pytest.mark.parametrize("ps", [4, 5, 12, 16, 64])   # 5 and 12 take the division path
def test_paged_splitk_mma_kernel_vs_plain(cuda, ps, D, G, K):
    rng = np.random.default_rng(ps + D + K)
    Hkv = 2
    nb = 8 * -(-SPLIT_S // (8 * ps))               # a multiple of every K
    lens_l = _split_lens(nb * ps, K)
    B = len(lens_l)
    k, v, tbl = _paged(rng, B, nb, ps, Hkv, D, lens_l, torch.bfloat16, cuda)
    q = _q(rng, B, Hkv * G, D, torch.bfloat16, cuda)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    _partial_close(kernel.paged_splitk_partial_cuda(q, k, v, tbl, lens, k_splits=K),
                   ref.decode_attention_paged_splitk_partial(q, k, v, tbl, lens, k_splits=K),
                   torch.bfloat16)
    _close(kernel.decode_attention_paged_splitk_cuda(q, k, v, tbl, lens, k_splits=K),
           ref.decode_attention_paged(q, k, v, tbl, lens), torch.bfloat16)


def _same_partials(got, clean):
    for a, b in zip(got, clean):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


@pytest.mark.parametrize("D,G", [(128, 2), (80, 1)])
def test_splitk_mma_kernel_ignores_nan_past_the_lengths(cuda, D, G):
    """NaN in every cache row at or past each length: the partials and the
    pair's output are finite and equal the clean cache's, bit for bit."""
    rng = np.random.default_rng(33 + D)
    Hkv, K = 2, 8
    lens_l = _split_lens(SPLIT_S, K)[:-1] + [SPLIT_S - 5]
    B = len(lens_l)
    k, v = _kv(rng, B, SPLIT_S, Hkv, D, torch.bfloat16, cuda)
    q = _q(rng, B, Hkv * G, D, torch.bfloat16, cuda)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    dead = (torch.arange(SPLIT_S, device=cuda)[None, :] >= lens[:, None]).reshape(-1)
    kn, vn = _poisoned(k, dead), _poisoned(v, dead)
    _same_partials(kernel.splitk_partial_cuda(q, kn, vn, lens, k_splits=K),
                   kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K))
    out = kernel.decode_attention_splitk_cuda(q, kn, vn, lens, k_splits=K)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K))


@pytest.mark.parametrize("ps", [5, 12, 16])
def test_paged_splitk_mma_kernel_ignores_nan_in_the_pool(cuda, ps):
    """NaN in the trash page (0) and in every pool row no sequence holds
    below its length, at page sizes that are and are not powers of two."""
    rng = np.random.default_rng(36 + ps)
    Hkv, G, D, K = 2, 2, 128, 8
    nb = 8 * -(-SPLIT_S // (8 * ps))
    lens_l = _split_lens(nb * ps, K)[:-1] + [nb * ps - 5]
    B = len(lens_l)
    k, v, tbl = _paged(rng, B, nb, ps, Hkv, D, lens_l, torch.bfloat16, cuda)
    q = _q(rng, B, Hkv * G, D, torch.bfloat16, cuda)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    live = torch.zeros(k.shape[0] * ps, dtype=torch.bool, device=cuda)
    for b, n in enumerate(lens_l):
        pos = torch.arange(n, device=cuda)
        live[tbl[b, pos // ps].long() * ps + pos % ps] = True
    assert not bool(live[:ps].any())               # nothing live on the trash page
    kn, vn = _poisoned(k, ~live), _poisoned(v, ~live)
    _same_partials(kernel.paged_splitk_partial_cuda(q, kn, vn, tbl, lens, k_splits=K),
                   kernel.paged_splitk_partial_cuda(q, k, v, tbl, lens, k_splits=K))
    out = kernel.decode_attention_paged_splitk_cuda(q, kn, vn, tbl, lens, k_splits=K)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, kernel.decode_attention_paged_splitk_cuda(q, k, v, tbl, lens,
                                                                      k_splits=K))


@pytest.mark.parametrize("offset", [0, 1])
def test_splitk_mma_kernel_reads_a_strided_q_view(cuda, offset):
    """The decode step's q[:, 0]: a view of the fused projection (B, 1,
    (Hq + 2 Hkv) D), here also 2 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(38 + offset)
    Hkv, G, D, K = 2, 2, 128, 8
    lens_l = _split_lens(SPLIT_S, K)
    B = len(lens_l)
    k, v = _kv(rng, B, SPLIT_S, Hkv, D, torch.bfloat16, cuda)
    width = offset + (Hkv * G + 2 * Hkv) * D
    fused = torch.as_tensor(rng.standard_normal((B, 1, width)),
                            dtype=torch.float32).to(cuda, torch.bfloat16)
    q = fused[:, :, offset:offset + Hkv * G * D].unflatten(-1, (Hkv * G, D))[:, 0]
    assert not q.is_contiguous() and q.data_ptr() % 16 == 2 * offset
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    qc = q.contiguous()
    _same_partials(kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K),
                   kernel.splitk_partial_cuda(qc, k, v, lens, k_splits=K))
    _partial_close(kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K),
                   ref.decode_attention_splitk_partial(qc, k, v, lens, k_splits=K),
                   torch.bfloat16)


def _device_kernels(fn, calls: int = 2) -> set:
    """Names of the device kernels that ``calls`` calls of ``fn`` launch,
    from a profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("dtype,G,name", [
    (torch.bfloat16, 2, "splitk_mma_kernel"),
    (torch.bfloat16, 16, "splitk_mma_kernel"),
    (torch.bfloat16, 32, "flash_rows_kernel"),     # past one m16 tile of rows
    (torch.float32, 2, "flash_rows_kernel"),
])
def test_splitk_partial_runs_the_expected_kernel(cuda, dtype, G, name):
    """Which kernel the split-K partial launches (contiguous and paged), by
    the profiler's kernel names, with one count per wrapper call (two calls
    per traced session)."""
    rng = np.random.default_rng(40 + G)
    Hkv, D, K, ps = 1, 128, 8, 16
    nb = SPLIT_S // ps
    lens_l = _split_lens(SPLIT_S, K)
    B = len(lens_l)
    k, v = _kv(rng, B, SPLIT_S, Hkv, D, dtype, cuda)
    kp, vp, tbl = _paged(rng, B, nb, ps, Hkv, D, lens_l, dtype, cuda)
    q = _q(rng, B, Hkv * G, D, dtype, cuda)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    calls = (lambda: kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K),
             lambda: kernel.paged_splitk_partial_cuda(q, kp, vp, tbl, lens, k_splits=K))
    # built and loaded outside the traced sessions, and the profiler warmed
    # up: a process's first traced session has missed its launches
    _device_kernels(lambda: [call() for call in calls], calls=1)
    other = "flash_rows_kernel" if name == "splitk_mma_kernel" else "splitk_mma_kernel"
    kernel.reset_launches()
    for call in calls:
        names = _device_kernels(call)
        assert any(name in n for n in names), names
        assert not any(other in n for n in names), names
    assert kernel.LAUNCHES["decode_attention_splitk_partial"] == 2
    assert kernel.LAUNCHES["decode_attention_paged_splitk_partial"] == 2
    _partial_close(calls[0](), ref.decode_attention_splitk_partial(q, k, v, lens, k_splits=K),
                   dtype)
    _partial_close(calls[1](), ref.decode_attention_paged_splitk_partial(
        q, kp, vp, tbl, lens, k_splits=K), dtype)
    # the split-K decode: the same kernel, one launch a call, and nothing
    # else (no combine, no memset of the counters)
    fused = (lambda: kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K),
             lambda: kernel.decode_attention_paged_splitk_cuda(q, kp, vp, tbl, lens, k_splits=K))
    _device_kernels(lambda: [call() for call in fused], calls=1)
    for call in fused:
        counts = _device_kernel_counts(call)
        assert len(counts) == 1 and name in next(iter(counts)), counts
        assert next(iter(counts.values())) == 2, counts


def _device_kernel_counts(fn, calls: int = 2) -> dict:
    """Launches by device kernel name that ``calls`` calls of ``fn`` make,
    from a profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "ssd_chunk_kernel<"),
                                        (torch.float32, "ssd_kernel<")])
def test_ssd_runs_the_expected_kernel(cuda, dtype, name):
    """bf16 runs the chunked tensor-core kernel, fp32 the serial token
    kernel, by the profiler's kernel names: exactly one device kernel per
    wrapper call (two calls per traced session), and nothing else."""
    rng = np.random.default_rng(42)
    args = _ssd_inputs(rng, 1, 300, 8, 64, 64, dtype, cuda)
    # built and loaded outside the traced sessions, and the profiler warmed up
    _device_kernel_counts(lambda: ssd_kernel.ssd_cuda(*args), calls=1)
    ssd_kernel.reset_launches()
    counts = _device_kernel_counts(lambda: ssd_kernel.ssd_cuda(*args))
    assert len(counts) == 1 and name in next(iter(counts)), counts
    assert next(iter(counts.values())) == 2, counts
    assert ssd_kernel.LAUNCHES == {"ssd": 2}
    _ssd_close(*args)


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "wkv6_chunk_kernel<"),
                                        (torch.float32, "wkv6_kernel<")])
def test_wkv6_runs_the_expected_kernel(cuda, dtype, name):
    """bf16 runs the chunked tensor-core kernel, fp32 the serial token
    kernel, by the profiler's kernel names: exactly one device kernel per
    wrapper call (two calls per traced session), and nothing else."""
    rng = np.random.default_rng(41)
    args = _wkv_inputs(rng, 1, 300, 8, 64, dtype, cuda)
    # built and loaded outside the traced sessions, and the profiler warmed
    # up: a process's first traced session has missed its launches
    _device_kernel_counts(lambda: wkv_kernel.wkv6_cuda(*args), calls=1)
    wkv_kernel.reset_launches()
    counts = _device_kernel_counts(lambda: wkv_kernel.wkv6_cuda(*args))
    assert len(counts) == 1 and name in next(iter(counts)), counts
    assert next(iter(counts.values())) == 2, counts
    assert wkv_kernel.LAUNCHES == {"wkv6": 2}
    _wkv_close(*args)


# ---------------------------------------------------------------------------
# the single-stage decode: one launch split over a thread-block cluster
# (cluster_mma_kernel in bf16, cluster_f32_kernel in fp32, G <= 16)
# ---------------------------------------------------------------------------

SINGLE_S = 1024


def _single_lens(S, C):
    """1, 127, 128, 129, each side of every chunk edge of a cluster of C,
    and S."""
    out = {1, 127, 128, 129, S}
    for lo, end in kernel.cluster_chunks(S, C):
        out |= {lo - 1, lo, lo + 1, end - 1, end, end + 1}
    return sorted(n for n in out if 1 <= n <= S)


def _batches(lens_l, B, S):
    """``lens_l`` in batches of B (the last filled up with S)."""
    for i in range(0, len(lens_l), B):
        part = lens_l[i:i + B]
        yield part + [S] * (B - len(part))


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_stage_kernel_vs_plain(cuda, dtype, D, G):
    """Every cluster size at lengths on each side of its chunk edges; G = 32
    (past one m16 tile of rows) takes flash_rows_kernel."""
    rng = np.random.default_rng(50 + D + G)
    Hkv, B = 2, 3
    for C in (1, 2, 4, 8):
        for lens_l in _batches(_single_lens(SINGLE_S, C), B, SINGLE_S):
            k, v = _kv(rng, B, SINGLE_S, Hkv, D, dtype, cuda)
            q = _q(rng, B, Hkv * G, D, dtype, cuda)
            lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
            _close(kernel.decode_attention_cuda(q, k, v, lens, cluster=C),
                   ref.decode_attention(q, k, v, lens), dtype)


@pytest.mark.parametrize("D,G", [(128, 2), (80, 1), (32, 16)])
@pytest.mark.parametrize("ps", [5, 12, 16, 64])      # 5 and 12 take the division path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_single_stage_kernel_vs_plain(cuda, dtype, ps, D, G):
    rng = np.random.default_rng(60 + ps + D)
    Hkv, B = 2, 3
    nb = -(-SINGLE_S // ps)
    S = nb * ps
    for C in (1, 2, 4, 8):
        for lens_l in _batches(_single_lens(S, C), B, S):
            k, v, tbl = _paged(rng, B, nb, ps, Hkv, D, lens_l, dtype, cuda)
            q = _q(rng, B, Hkv * G, D, dtype, cuda)
            lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
            _close(kernel.decode_attention_paged_cuda(q, k, v, tbl, lens, cluster=C),
                   ref.decode_attention_paged(q, k, v, tbl, lens), dtype)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_stage_kernel_batch_sizes(cuda, dtype, B):
    """qwen3-0.6b's heads (8 kv heads, G 2, D 128) at the chooser's cluster
    over 1024 keys (bf16: 8, 4 and 2 CTAs at B = 1, 3, 8; fp32, two CTAs
    an SM: 8, 8, 4) and over 544 (5 tiles: at most 4), contiguous and
    through 16-token pages."""
    rng = np.random.default_rng(70 + B)
    Hkv, G, D, ps = 8, 2, 128, 16
    for S in (SINGLE_S, 544):
        C = kernel.cluster_split(S, B * Hkv, kernel.CLUSTER_CTAS_PER_SM[dtype][D])
        for lens_l in _batches(_single_lens(S, C), B, S):
            k, v = _kv(rng, B, S, Hkv, D, dtype, cuda)
            q = _q(rng, B, Hkv * G, D, dtype, cuda)
            lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
            _close(kernel.decode_attention_cuda(q, k, v, lens),
                   ref.decode_attention(q, k, v, lens), dtype)
            kp, vp, tbl = _paged(rng, B, S // ps, ps, Hkv, D, lens_l, dtype, cuda)
            _close(kernel.decode_attention_paged_cuda(q, kp, vp, tbl, lens),
                   ref.decode_attention_paged(q, kp, vp, tbl, lens), dtype)


@pytest.mark.parametrize("D,G", [(128, 2), (80, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_stage_kernel_ignores_nan(cuda, dtype, D, G):
    """NaN in every cache row at or past each length, and in the trash page
    and every pool row no sequence holds below its length (page sizes 5 and
    16): the output is finite and equals the clean run's, bit for bit; two
    calls in a row are bit-equal."""
    rng = np.random.default_rng(80 + D)
    Hkv = 2
    lens_l = [1, 127, 128, 129, 383, 384, 385, SINGLE_S - 5]
    B = len(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    q = _q(rng, B, Hkv * G, D, dtype, cuda)
    k, v = _kv(rng, B, SINGLE_S, Hkv, D, dtype, cuda)
    dead = (torch.arange(SINGLE_S, device=cuda)[None, :] >= lens[:, None]).reshape(-1)
    clean = kernel.decode_attention_cuda(q, k, v, lens)
    assert torch.equal(clean, kernel.decode_attention_cuda(q, k, v, lens))
    out = kernel.decode_attention_cuda(q, _poisoned(k, dead), _poisoned(v, dead), lens)
    assert bool(torch.isfinite(out).all()) and torch.equal(out, clean)
    for ps in (5, 16):
        nb = -(-SINGLE_S // ps)
        kp, vp, tbl = _paged(rng, B, nb, ps, Hkv, D, lens_l, dtype, cuda)
        live = torch.zeros(kp.shape[0] * ps, dtype=torch.bool, device=cuda)
        for b, n in enumerate(lens_l):
            pos = torch.arange(n, device=cuda)
            live[tbl[b, pos // ps].long() * ps + pos % ps] = True
        assert not bool(live[:ps].any())           # nothing live on the trash page
        clean = kernel.decode_attention_paged_cuda(q, kp, vp, tbl, lens)
        assert torch.equal(clean, kernel.decode_attention_paged_cuda(q, kp, vp, tbl, lens))
        out = kernel.decode_attention_paged_cuda(q, _poisoned(kp, ~live), _poisoned(vp, ~live),
                                                 tbl, lens)
        assert bool(torch.isfinite(out).all()) and torch.equal(out, clean)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_stage_kernel_reads_a_strided_q_view(cuda, dtype, offset):
    """The decode step's q[:, 0]: a view of the fused projection (B, 1,
    (Hq + 2 Hkv) D), here also one element past a 16-byte boundary."""
    rng = np.random.default_rng(90 + offset)
    Hkv, G, D = 2, 2, 128
    lens_l = [1, 129, 600, SINGLE_S]
    B = len(lens_l)
    k, v = _kv(rng, B, SINGLE_S, Hkv, D, dtype, cuda)
    width = offset + (Hkv * G + 2 * Hkv) * D
    fused = torch.as_tensor(rng.standard_normal((B, 1, width)), dtype=torch.float32).to(cuda, dtype)
    q = fused[:, :, offset:offset + Hkv * G * D].unflatten(-1, (Hkv * G, D))[:, 0]
    assert not q.is_contiguous() and q.data_ptr() % 16 == offset * q.element_size()
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    got = kernel.decode_attention_cuda(q, k, v, lens)
    assert torch.equal(got, kernel.decode_attention_cuda(q.contiguous(), k, v, lens))
    _close(got, ref.decode_attention(q.contiguous(), k, v, lens), dtype)


_TRACE_CASES = [
    (torch.bfloat16, 2, "cluster_mma_kernel"),
    (torch.bfloat16, 16, "cluster_mma_kernel"),
    (torch.bfloat16, 32, "flash_rows_kernel"),     # past one m16 tile of rows
    (torch.float32, 2, "cluster_f32_kernel"),
    (torch.float32, 16, "cluster_f32_kernel"),
    (torch.float32, 32, "flash_rows_kernel"),
]

# Traced in a process of its own: late in a long pytest process a
# torch.profiler session came back empty for every kernel (``<<<>>>``
# launches included), while sessions in a fresh process recorded every
# launch.
_TRACE_SCRIPT = r"""
import json, sys
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.decode_attention import kernel

def counts(fn, calls):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}

out = {}
for dtype, G in json.loads(sys.argv[1]):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(95 + G)
    B, S, Hkv, D, ps = 4, 1024, 1, 128, 16
    k, v = (torch.as_tensor(rng.standard_normal((B, S, Hkv, D)), dtype=torch.float32).to("cuda", dt)
            for _ in range(2))
    P = 1 + B * (S // ps)
    kp, vp = (torch.as_tensor(rng.standard_normal((P, ps, Hkv, D)), dtype=torch.float32).to("cuda", dt)
              for _ in range(2))
    tbl = torch.as_tensor(1 + rng.permutation(P - 1)[: B * (S // ps)].reshape(B, S // ps),
                          dtype=torch.int32, device="cuda")
    q = torch.as_tensor(rng.standard_normal((B, Hkv * G, D)), dtype=torch.float32).to("cuda", dt)
    lens = torch.tensor([1, 129, 600, S], dtype=torch.int32, device="cuda")
    calls = {"decode_attention": lambda: kernel.decode_attention_cuda(q, k, v, lens),
             "decode_attention_paged": lambda: kernel.decode_attention_paged_cuda(
                 q, kp, vp, tbl, lens)}
    counts(lambda: [c() for c in calls.values()], 1)   # built, loaded, profiler warm
    for name, call in calls.items():
        for _ in range(3):                             # an empty trace is taken again
            kernel.reset_launches()
            c = counts(call, 2)
            if c:
                break
        out[f"{dtype}-{G}-{name}"] = dict(counts=c, launches=dict(kernel.LAUNCHES))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def single_stage_traces():
    """Device kernels by name, and LAUNCHES, for two calls of each
    single-stage wrapper at every case of ``_TRACE_CASES``, traced in a
    fresh process (``_TRACE_SCRIPT``)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cases = json.dumps([[str(dt).split(".")[-1], G] for dt, G, _ in _TRACE_CASES])
    run = subprocess.run([sys.executable, "-c", _TRACE_SCRIPT, cases], env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype,G,name", _TRACE_CASES)
def test_single_stage_runs_the_expected_kernel(cuda, single_stage_traces, dtype, G, name):
    """Which kernel the single-stage decode launches (contiguous and paged),
    by the profiler's kernel names: exactly one device kernel per wrapper
    call (two calls per traced session), no memset and no second kernel,
    and one count per call in LAUNCHES."""
    for wrapper in ("decode_attention", "decode_attention_paged"):
        got = single_stage_traces[f"{str(dtype).split('.')[-1]}-{G}-{wrapper}"]
        counts = got["counts"]
        assert len(counts) == 1 and name in next(iter(counts)), counts
        assert next(iter(counts.values())) == 2, counts
        assert got["launches"][wrapper] == 2 and sum(got["launches"].values()) == 2, got
    rng = np.random.default_rng(95 + G)
    Hkv, D, ps = 1, 128, 16
    lens_l = [1, 129, 600, SINGLE_S]
    B = len(lens_l)
    k, v = _kv(rng, B, SINGLE_S, Hkv, D, dtype, cuda)
    kp, vp, tbl = _paged(rng, B, SINGLE_S // ps, ps, Hkv, D, lens_l, dtype, cuda)
    q = _q(rng, B, Hkv * G, D, dtype, cuda)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    _close(kernel.decode_attention_cuda(q, k, v, lens), ref.decode_attention(q, k, v, lens), dtype)
    _close(kernel.decode_attention_paged_cuda(q, kp, vp, tbl, lens),
           ref.decode_attention_paged(q, kp, vp, tbl, lens), dtype)


# ---------------------------------------------------------------------------
# the split-K decode in one launch: the last CTA of each (sequence, kv head)
# to finish (of each row block, in flash_rows_kernel) merges the chunk states
# ---------------------------------------------------------------------------

FUSED_S = 4096


def _fused_lens(S, K):
    """The whole cache, 2049, on a chunk boundary, one past it, 17, 1, 0."""
    ck = S // K
    return [S, 2049, ck, ck + 1, 17, 1, 0]


def _fused_case(rng, paged, K, Hkv, G, D, lens_l, dtype, dev, ps=16):
    """q and the four calls over a 4096-key cache (contiguous, or 16-token
    pages through shuffled tables): the one launch, the chunk states alone,
    the plain split-K decode and the plain single-stage decode."""
    B = len(lens_l)
    q = _q(rng, B, Hkv * G, D, dtype, dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    if paged:
        k, v, tbl = _paged(rng, B, FUSED_S // ps, ps, Hkv, D, lens_l, dtype, dev)
        calls = (lambda: kernel.decode_attention_paged_splitk_cuda(q, k, v, tbl, lens, k_splits=K),
                 lambda: kernel.paged_splitk_partial_cuda(q, k, v, tbl, lens, k_splits=K),
                 lambda: ref.decode_attention_paged_splitk(q, k, v, tbl, lens, k_splits=K),
                 lambda: ref.decode_attention_paged(q, k, v, tbl, lens))
    else:
        k, v = _kv(rng, B, FUSED_S, Hkv, D, dtype, dev)
        calls = (lambda: kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=K),
                 lambda: kernel.splitk_partial_cuda(q, k, v, lens, k_splits=K),
                 lambda: ref.decode_attention_splitk(q, k, v, lens, k_splits=K),
                 lambda: ref.decode_attention(q, k, v, lens))
    return q, lens, calls


def _counters_zero(q):
    torch.cuda.synchronize()
    assert not bool(kernel.split_counters(q, 0).any())


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("G", [1, 2, 20])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_splitk_vs_plain(cuda, dtype, K, D, G, paged):
    """The one launch against the plain merge of the kernel's own chunk
    states, the plain split-K decode, and the plain decode on the rows of
    nonzero length; a zero-length row is exactly 0; the counters are all 0
    after it.  G = 20 (three row blocks of flash_rows_kernel, a counter
    each) takes flash_rows_kernel in bf16 too."""
    rng = np.random.default_rng(100 + K + D + G + 7 * paged)
    q, lens, (fused, partial, plain, plain_decode) = _fused_case(
        rng, paged, K, 2, G, D, _fused_lens(FUSED_S, K), dtype, cuda)
    out = fused()
    _close(out, ref.splitk_combine(*partial(), dtype), dtype)
    _close(out, plain(), dtype)
    live = lens > 0
    _close(out[live], plain_decode()[live], dtype)
    assert bool((out[~live] == 0).all())
    _counters_zero(q)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype,G", [(torch.bfloat16, 2), (torch.float32, 2),
                                     (torch.bfloat16, 20)])
def test_fused_splitk_is_deterministic(cuda, dtype, G, paged):
    """20 launches in a row give the same bits, whichever CTA merged; the
    counters are 0 after each."""
    rng = np.random.default_rng(130 + G + paged)
    q, _, (fused, *_) = _fused_case(rng, paged, 8, 8, G, 128, _fused_lens(FUSED_S, 8), dtype,
                                    cuda)
    first = fused()
    _counters_zero(q)
    for _ in range(20):
        assert torch.equal(fused(), first)
        _counters_zero(q)


def test_fused_splitk_counters_grow_and_stay(cuda):
    """The counters of a stream: made zeroed on first use; a call whose
    B·Hkv·(row blocks) exceeds the buffer gets a larger zeroed one; a call
    that fits keeps it; another stream has its own."""
    rng = np.random.default_rng(140)
    kernel._COUNTERS.clear()
    small = _fused_case(rng, False, 8, 2, 2, 128, [4096, 17], torch.bfloat16, cuda)
    big = _fused_case(rng, True, 4, 8, 20, 64, _fused_lens(FUSED_S, 4), torch.float32, cuda)
    for q, lens, (fused, _, plain, _) in (small, big, small):
        before = kernel._COUNTERS.get((q.device.index, torch.cuda.current_stream().cuda_stream))
        _close(fused(), plain(), q.dtype)
        _counters_zero(q)
        buf = kernel.split_counters(q, 0)
        need = q.shape[0] * 8 * 3 if q.dtype == torch.float32 else q.shape[0] * 2
        assert buf.numel() >= need
        if before is not None and before.numel() >= need:
            assert buf is before                       # kept, not remade
    assert kernel.split_counters(big[0], 0).numel() == big[0].shape[0] * 8 * 3
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        q, _, (fused, _, plain, _) = small
        out = fused()
        mine = kernel.split_counters(q, 0)
    side.synchronize()
    assert mine is not kernel.split_counters(q, 0)
    _close(out, plain(), q.dtype)
    assert not bool(mine.any())


def test_fused_splitk_layouts_back_to_back(cuda):
    """Contiguous and paged calls of other shapes and dtypes back to back on
    one stream, no synchronisation between them: each equals the same call
    made alone, bit for bit, and the counters end at 0."""
    rng = np.random.default_rng(150)
    cases = [_fused_case(rng, False, 8, 8, 2, 128, _fused_lens(FUSED_S, 8), torch.bfloat16, cuda),
             _fused_case(rng, True, 4, 2, 20, 80, _fused_lens(FUSED_S, 4), torch.float32, cuda),
             _fused_case(rng, True, 8, 8, 2, 128, _fused_lens(FUSED_S, 8), torch.bfloat16, cuda),
             _fused_case(rng, False, 2, 4, 1, 64, _fused_lens(FUSED_S, 2), torch.float32, cuda)]
    alone = []
    for q, _, (fused, *_) in cases:
        alone.append(fused())
        torch.cuda.synchronize()
    together = [fused() for _ in range(3) for _, _, (fused, *_) in cases]
    _counters_zero(cases[0][0])
    for i, out in enumerate(together):
        assert torch.equal(out, alone[i % len(cases)])


def test_fused_splitk_failed_launch_drops_counters(cuda):
    """A launch the library refuses (here a head dim it has no kernel for)
    raises, and drops the stream's counters, so the next call starts from a
    fresh zeroed buffer."""
    rng = np.random.default_rng(160)
    B, S, Hkv, G, D, K = 2, 256, 2, 2, 48, 2
    k, v = _kv(rng, B, S, Hkv, D, torch.float32, cuda)
    q = _q(rng, B, Hkv * G, D, torch.float32, cuda)
    lens = torch.tensor([S, 3], dtype=torch.int32, device=cuda)
    ctr = kernel.split_counters(q, B * Hkv)
    key = (q.device.index, torch.cuda.current_stream().cuda_stream)
    assert kernel._COUNTERS[key] is ctr
    out = torch.empty((B, 1, Hkv * G, D), device=cuda)
    launches = dict(kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="decode_attention_splitk"):
        kernel._rows(q.unsqueeze(1), k, v, lens, add=0, splits=K, out=out,
                     partial=kernel._split_state(q, Hkv, K, D), name="decode_attention_splitk",
                     counters=ctr)
    assert key not in kernel._COUNTERS
    assert kernel.LAUNCHES == launches                 # a refused launch is not counted


# ---------------------------------------------------------------------------
# the fp32 mixed step: blocks of 16 (query, head) rows whose keys are split
# over a thread-block cluster (cluster_mixed_f32_kernel, G <= 16)
# ---------------------------------------------------------------------------

MIXED_S = 1024


def _mixed_cl(S, Q, C):
    """Cache lengths (at most S - Q) whose rows' limits cache_len + i + 1
    lie all below, on both sides of, and all above every chunk edge of a
    cluster of C, and 0 and S - Q."""
    out = {0, S - Q}
    for lo, end in kernel.cluster_chunks(S, C):
        for e in (lo, end):
            out |= {e - Q - 1, e - (Q + 1) // 2, e}
    return sorted(n for n in out if 0 <= n <= S - Q)


def _f32_mixed_q(rng, B, Q, Hq, D, dev):
    return torch.as_tensor(rng.standard_normal((B, Q, Hq, D)), dtype=torch.float32).to(dev)


@pytest.mark.parametrize("Q", [1, 8, 13, 64, 200])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
def test_fp32_mixed_cluster_kernel_vs_plain(cuda, D, G, Q):
    """A window view k[:, :S] of a longer cache, every cluster size (and
    the chooser's), cache lengths on each side of every chunk edge; rows
    Q·G not a multiple of 16 leave a partial last block."""
    rng = np.random.default_rng(200 + D + 10 * G + Q)
    Hkv, B = 2, 3
    k, v = _kv(rng, B, MIXED_S + 64, Hkv, D, torch.float32, cuda)
    kw, vw = k[:, :MIXED_S], v[:, :MIXED_S]
    q = _f32_mixed_q(rng, B, Q, Hkv * G, D, cuda)
    for C in (1, 2, 4, 8):
        for cl_l in _batches(_mixed_cl(MIXED_S, Q, C), B, MIXED_S - Q):
            cl = torch.tensor(cl_l, dtype=torch.int32, device=cuda)
            want = ref.mixed_attention(q, kw, vw, cl)
            _close(kernel._mixed(q, kw, vw, cl, "mixed_attention", cluster=C), want,
                   torch.float32)
    _close(kernel.mixed_attention_cuda(q, kw, vw, cl), want, torch.float32)


@pytest.mark.parametrize("Q", [1, 8, 13, 64, 200])
@pytest.mark.parametrize("D,G", [(128, 2), (32, 2), (80, 1), (64, 4)])
@pytest.mark.parametrize("ps", [1, 16, 48])
def test_fp32_mixed_cluster_kernel_paged_truncated_table(cuda, ps, D, G, Q):
    """Through a column slice tables[:, :w] of wider tables (read in place),
    at every cluster size, cache lengths on each side of every chunk edge."""
    rng = np.random.default_rng(300 + ps + D + Q)
    Hkv, B = 2, 3
    w = -(-MIXED_S // ps)
    S = w * ps
    for C in (1, 2, 4, 8):
        for cl_l in _batches(_mixed_cl(S, Q, C), B, S - Q):
            cl_np = np.array(cl_l)
            k, v, tbl = _paged(rng, B, w + 8, ps, Hkv, D, cl_np + Q, torch.float32, cuda)
            view = tbl[:, :w]
            assert not view.is_contiguous()
            q = _f32_mixed_q(rng, B, Q, Hkv * G, D, cuda)
            cl = torch.as_tensor(cl_np, dtype=torch.int32, device=cuda)
            want = ref.mixed_attention_paged(q, k, v, view, cl)
            _close(kernel._mixed(q, k, v, cl, "mixed_attention_paged", view, cluster=C), want,
                   torch.float32)
            _close(kernel.mixed_attention_paged_cuda(q, k, v, view, cl), want, torch.float32)


@pytest.mark.parametrize("Q", [21, 500])
def test_fp32_mixed_cluster_kernel_prefill_paged_shape(cuda, Q):
    """``Model.prefill_paged``'s call in fp32: B=1, a suffix of Q queries
    after a 1024-token cached prefix, through one table row of batch stride
    0, qwen3-0.6b's heads (8 kv heads, G 2, D 128)."""
    rng = np.random.default_rng(400 + Q)
    Hkv, G, D, ps, nb, start = 8, 2, 128, 16, 256, 1024
    k, v, tbl = _paged(rng, 1, nb, ps, Hkv, D, [start + Q], torch.float32, cuda)
    row = tbl[0].as_strided((1, nb), (0, 1))
    q = _f32_mixed_q(rng, 1, Q, Hkv * G, D, cuda)
    cl = torch.tensor([start], dtype=torch.int32, device=cuda)
    # 3 blocks of 16 rows a kv head at Q = 21: clusters of 4; 63 at Q = 500: 1
    assert kernel.mixed_cluster(nb * ps, 1, Hkv, Q, G, D) == (4 if Q == 21 else 1)
    _close(kernel.mixed_attention_paged_cuda(q, k, v, row, cl),
           ref.mixed_attention_paged(q, k, v, row, cl), torch.float32)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_fp32_mixed_cluster_kernel_ignores_nan(cuda, C):
    """NaN in every cache row at or past cache_len + Q (through a window
    view) and in the trash page and every pool row no sequence holds below
    its cache_len + Q (page sizes 16 and 48), at Q 13, G 2 (a partial
    block): the output is finite and equals the clean run's bit for bit,
    and two calls in a row are bit-equal."""
    rng = np.random.default_rng(500 + C)
    Hkv, G, D, Q = 2, 2, 128, 13
    cl_l = [0, 127 - Q, 128 - 7, 255, 511 - Q, MIXED_S - Q]
    B = len(cl_l)
    cl = torch.tensor(cl_l, dtype=torch.int32, device=cuda)
    q = _f32_mixed_q(rng, B, Q, Hkv * G, D, cuda)
    k, v = _kv(rng, B, MIXED_S + 32, Hkv, D, torch.float32, cuda)
    dead = (torch.arange(MIXED_S + 32, device=cuda)[None, :] >= (cl[:, None] + Q)).reshape(-1)
    run = functools.partial(kernel._mixed, name="mixed_attention", cluster=C)
    clean = run(q, k[:, :MIXED_S], v[:, :MIXED_S], cl)
    assert torch.equal(clean, run(q, k[:, :MIXED_S], v[:, :MIXED_S], cl))
    kn, vn = _poisoned(k, dead), _poisoned(v, dead)
    out = run(q, kn[:, :MIXED_S], vn[:, :MIXED_S], cl)
    assert bool(torch.isfinite(out).all()) and torch.equal(out, clean)
    _close(clean, ref.mixed_attention(q, k[:, :MIXED_S], v[:, :MIXED_S], cl), torch.float32)
    for ps in (16, 48):
        nb = -(-MIXED_S // ps)
        kp, vp, tbl = _paged(rng, B, nb, ps, Hkv, D, np.array(cl_l) + Q, torch.float32, cuda)
        live = torch.zeros(kp.shape[0] * ps, dtype=torch.bool, device=cuda)
        for b, n in enumerate(cl_l):
            pos = torch.arange(n + Q, device=cuda)
            live[tbl[b, pos // ps].long() * ps + pos % ps] = True
        assert not bool(live[:ps].any())           # nothing live on the trash page
        prun = functools.partial(kernel._mixed, name="mixed_attention_paged", tables=tbl,
                                 cluster=C)
        clean = prun(q, kp, vp, cl)
        assert torch.equal(clean, prun(q, kp, vp, cl))
        out = prun(q, _poisoned(kp, ~live), _poisoned(vp, ~live), cl)
        assert bool(torch.isfinite(out).all()) and torch.equal(out, clean)


def test_fp32_mixed_cluster_kernel_repeats_bit_equal(cuda):
    """20 launches at phase 6's shape (B=8, Q 8, 8 kv heads, G 2, D 128, a
    2048-key window of a 4096-row cache; the chooser's C = 2) are bit-equal."""
    rng = np.random.default_rng(600)
    B, Hkv, G, D, Q, W = 8, 8, 2, 128, 8, 2048
    k, v = _kv(rng, B, 4096, Hkv, D, torch.float32, cuda)
    q = _f32_mixed_q(rng, B, Q, Hkv * G, D, cuda)
    cl = torch.tensor([1139, 561, 410, 1341, 623, 1147, 530, 306], dtype=torch.int32,
                      device=cuda)
    assert kernel.mixed_cluster(W, B, Hkv, Q, G, D) == 2
    first = kernel.mixed_attention_cuda(q, k[:, :W], v[:, :W], cl)
    for _ in range(19):
        assert torch.equal(kernel.mixed_attention_cuda(q, k[:, :W], v[:, :W], cl), first)
    _close(first, ref.mixed_attention(q, k[:, :W], v[:, :W], cl), torch.float32)


def test_fp32_mixed_kernel_reads_a_strided_q_view(cuda):
    """q as a view of the fused projection (B, Q, (Hq + 2 Hkv) D), one
    element past a 16-byte boundary: plain loads through q's strides."""
    rng = np.random.default_rng(700)
    Hkv, G, D, Q = 2, 2, 128, 13
    cl_l = [0, 129, 600]
    B = len(cl_l)
    k, v = _kv(rng, B, MIXED_S, Hkv, D, torch.float32, cuda)
    width = 1 + (Hkv * G + 2 * Hkv) * D
    fused = _f32_mixed_q(rng, B, Q, width, 1, cuda)[..., 0]
    q = fused[:, :, 1:1 + Hkv * G * D].unflatten(-1, (Hkv * G, D))
    assert not q.is_contiguous() and q.data_ptr() % 16 == 4
    cl = torch.tensor(cl_l, dtype=torch.int32, device=cuda)
    got = kernel.mixed_attention_cuda(q, k, v, cl)
    assert torch.equal(got, kernel.mixed_attention_cuda(q.contiguous(), k, v, cl))
    _close(got, ref.mixed_attention(q.contiguous(), k, v, cl), torch.float32)


_MIXED_TRACE_SCRIPT = r"""
import json
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.decode_attention import kernel

def counts(fn, calls):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}

out = {}
for G in (1, 2, 16, 32):
    rng = np.random.default_rng(800 + G)
    B, S, Hkv, D, ps, Q = 3, 1024, 1, 128, 16, 13
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32).to("cuda")
    k, v, q = f(B, S, Hkv, D), f(B, S, Hkv, D), f(B, Q, Hkv * G, D)
    P = 1 + B * (S // ps)
    kp, vp = f(P, ps, Hkv, D), f(P, ps, Hkv, D)
    tbl = torch.as_tensor(1 + rng.permutation(P - 1)[: B * (S // ps)].reshape(B, S // ps),
                          dtype=torch.int32, device="cuda")
    cl = torch.tensor([0, 300, S - Q], dtype=torch.int32, device="cuda")
    calls = {"mixed_attention": lambda: kernel.mixed_attention_cuda(q, k, v, cl),
             "mixed_attention_paged": lambda: kernel.mixed_attention_paged_cuda(
                 q, kp, vp, tbl, cl)}
    counts(lambda: [c() for c in calls.values()], 1)   # built, loaded, profiler warm
    for name, call in calls.items():
        for _ in range(3):                             # an empty trace is taken again
            kernel.reset_launches()
            c = counts(call, 2)
            if c:
                break
        out[f"{G}-{name}"] = dict(counts=c, launches=dict(kernel.LAUNCHES))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fp32_mixed_traces():
    """Device kernels by name, and LAUNCHES, for two calls of each fp32
    mixed wrapper at G 1, 2, 16 and 32, traced in a fresh process."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", _MIXED_TRACE_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("G,name", [(1, "cluster_mixed_f32_kernel"),
                                    (2, "cluster_mixed_f32_kernel"),
                                    (16, "cluster_mixed_f32_kernel"),
                                    (32, "flash_rows_kernel")])   # past 16 heads a kv head
def test_fp32_mixed_runs_the_expected_kernel(cuda, fp32_mixed_traces, G, name):
    """Which kernel the fp32 mixed step launches (contiguous and paged), by
    the profiler's kernel names: exactly one device kernel per wrapper
    call, and one count per call in LAUNCHES."""
    for wrapper in ("mixed_attention", "mixed_attention_paged"):
        got = fp32_mixed_traces[f"{G}-{wrapper}"]
        counts = got["counts"]
        assert len(counts) == 1 and name in next(iter(counts)), counts
        assert next(iter(counts.values())) == 2, counts
        assert got["launches"][wrapper] == 2 and sum(got["launches"].values()) == 2, got


# ---------------------------------------------------------------------------
# the engine's steps as CUDA graphs: captured against eager (graphs=False)
# on one reduced fp32 qwen3 (2 layers, 4 q / 2 kv heads, widened to
# head_dim 64 so that the flash prefill kernel takes it)
# ---------------------------------------------------------------------------


@functools.cache
def _graph_model():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduce(), head_dim=64)
    return Model(cfg, device="cuda").init_(torch.Generator("cuda").manual_seed(0))


def _graph_requests(vocab, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(p)), int(m))
            for p, m in zip(rng.integers(3, 90, n), rng.integers(1, 12, n))]


def _serve_graphs(graphs, *, warm=True, **ecfg_kw):
    """Serve ``_graph_requests`` through EngineClient; returns the streams,
    the launches of the served run (warming excluded) and the engine."""
    from repro_torch.serving import EngineClient, EngineConfig, InferenceRequest, ServingEngine

    model = _graph_model()
    kw = dict(max_len=256, decode_batch=3, decode_chunk=4, prefill_chunk=24)
    kw.update(ecfg_kw)
    eng = ServingEngine(model, EngineConfig(**kw), graphs=graphs)
    assert eng.graphs is graphs
    if warm:
        eng.warm_mixed_traces([kw["prefill_chunk"]])
        eng.warm_decode()
    for m in (kernel, norm_kernel):
        m.reset_launches()
    cli = EngineClient(eng)
    hs = [cli.submit(InferenceRequest(prompt=p, max_new=m))
          for p, m in _graph_requests(model.cfg.vocab_size)]
    cli.drain()
    launches = dict(kernel.LAUNCHES)
    return [h.result() for h in hs], launches, eng


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("max_len", [256, 2048])
def test_captured_session_equals_eager(cuda, paged, max_len):
    """Mixed steps and decode chunks replayed from CUDA graphs give the
    eager steps' streams token for token and the same launch counts (each
    replay adds its graph's launches); a served workload after warming
    prepares no new mixed bucket.  At max_len 2048 the decode is the
    one-launch split-K, whose counters must exist before its capture."""
    got, launches, eng = _serve_graphs(True, paged_kv=paged, max_len=max_len)
    warmed = eng.mixed_traces
    want, want_launches, eager = _serve_graphs(False, paged_kv=paged, max_len=max_len)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert launches == want_launches
    assert eng.mixed_traces == warmed == len(eng._windows(eng.chunk_quantum(24)))
    assert eager.mixed_traces <= warmed
    split = ("decode_attention_paged_splitk" if paged else "decode_attention_splitk")
    assert (launches[split] > 0) == (max_len == 2048)
    assert eng._graphs.captured == warmed + 1


def test_captured_session_without_warming_equals_eager(cuda):
    """Steps captured at their first use inside the pumps (no warm call)
    give the eager streams and launches too."""
    got, launches, eng = _serve_graphs(True, warm=False, paged_kv=True)
    want, want_launches, _ = _serve_graphs(False, warm=False, paged_kv=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert launches == want_launches and eng._graphs.captured >= 2


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_generate_equals_eager(cuda, temperature):
    """``generate``'s decode loop as one graph per (batch, steps): the first
    call captures, the second replays at another prompt; both equal eager,
    and a seeded temperature stream equals eager's."""
    from repro_torch.serving import EngineConfig, ServingEngine

    model = _graph_model()
    rng = np.random.default_rng(3)
    cfg = EngineConfig(max_len=256, temperature=temperature, seed=5)
    engines = [ServingEngine(model, cfg, graphs=g) for g in (True, False)]
    for plen in (20, 41):
        toks = rng.integers(0, model.cfg.vocab_size, (3, plen))
        for m in (kernel, norm_kernel):
            m.reset_launches()
        got = engines[0].generate({"inputs": toks}, 12, plen)
        launches = dict(kernel.LAUNCHES)
        kernel.reset_launches()
        want = engines[1].generate({"inputs": toks}, 12, plen)
        np.testing.assert_array_equal(got, want)
        assert launches == kernel.LAUNCHES
    assert engines[0]._graphs.captured == 1


def test_captured_temperature_session_equals_eager(cuda):
    """A seeded temperature > 0 session: the decode chunk's draws come from
    the generator registered with its graph, the mixed step's outside it;
    captured and eager give the same streams."""
    got, _, _ = _serve_graphs(True, temperature=0.8, seed=11)
    want, _, _ = _serve_graphs(False, temperature=0.8, seed=11)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("paged", [False, True])
def test_replay_reads_new_lengths_and_tables(cuda, paged):
    """A replay reads its step buffers as they stand: a mixed step and a
    decode chunk replayed after the lengths, flags, chunk tokens and block
    tables change equal the eager steps at the new values, bit for bit."""
    from repro_torch.serving import EngineConfig, ServingEngine

    model = _graph_model()
    rng = np.random.default_rng(21)
    B = 3
    ecfg = EngineConfig(max_len=256, decode_batch=B, decode_chunk=4, prefill_chunk=24,
                        paged_kv=paged)
    engines = [ServingEngine(model, ecfg, graphs=g) for g in (True, False)]
    Q, nb, P = engines[0].chunk_quantum(24), engines[0].max_blocks, engines[0].num_pages
    calls = []
    for _ in range(3):
        dec = rng.integers(0, 2, B)
        new = np.where(dec == 1, 1, rng.integers(0, Q + 1, B))
        calls.append((rng.integers(0, 200, B), new, dec, dec | (new > 0),
                      rng.integers(0, model.cfg.vocab_size, (B, Q)),
                      rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)))
    outs = []
    for eng in engines:
        st, got = eng._session_state(), []
        for lens, new, dec, upd, chunks, tables in calls:
            st.stage(lens, new, dec, upd, tables)
            st.chunk(Q).fill(chunks)
            logits, nxt = eng._mixed_call(st, Q, 256)
            got += [logits.clone(), nxt.clone()]
        for lens, _, dec, _, _, tables in calls:
            st.stage(lens, np.zeros(B), dec, np.zeros(B), tables)
            got += [eng._decode_call(st, 4).clone(), st.tok.clone()]
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], outs[0][2])
    assert engines[0]._graphs.captured == 2


def test_splitk_counters_are_never_made_under_capture(cuda):
    """The split-K decode's counters of the capture stream are made by the
    step's first (eager) call; a capture that would make them raises."""
    from repro_torch.serving import EngineConfig, ServingEngine

    kernel._COUNTERS.clear()
    eng = ServingEngine(_graph_model(), EngineConfig(max_len=2048, decode_batch=3))
    eng.warm_decode()
    assert (cuda.index or 0, eng._graphs.stream.cuda_stream) in kernel._COUNTERS
    rng = np.random.default_rng(31)
    k, v = _kv(rng, 2, 2048, 2, 64, torch.float32, cuda)
    q = _q(rng, 2, 4, 64, torch.float32, cuda)
    lens = torch.tensor([2048, 5], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="split-K counters"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            ops.decode_attention(q, k, v, lens)
    assert (cuda.index or 0, side.cuda_stream) not in kernel._COUNTERS


def test_capture_holds_off_the_garbage_collector(cuda):
    """A collection during a capture can destroy an unreachable engine's
    graphs, events and pinned buffers, which a capturing stream does not
    permit, and the capture is then invalidated (seen in a long pytest
    process, where finished clients and their engines wait in reference
    cycles): captures run with the automatic collector off, and it is back
    on after them.  A dead engine whose last reference drops inside the
    capture, with a collection due at every allocation, is freed after it."""
    import gc

    from repro_torch.serving import EngineConfig, ServingEngine

    cfg = EngineConfig(max_len=256, decode_batch=3, decode_chunk=4, prefill_chunk=24)
    dead = ServingEngine(_graph_model(), cfg)
    dead.warm_mixed_traces([24])
    dead.warm_decode()
    dead.cycle = dead                       # only a collection can free it
    holder = [dead]
    del dead
    eng = ServingEngine(_graph_model(), cfg)
    seen = []
    decode_steps = eng._decode_steps

    def body(st, steps):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
            holder.clear()
            _ = [[] for _ in range(5000)]          # allocations that would start collections
        return decode_steps(st, steps)

    eng._decode_steps = body
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        assert eng.warm_decode() == 1
    finally:
        gc.set_threshold(*thresholds)
    assert seen == [False] and gc.isenabled()
    gc.collect()
    st = eng._session_state()
    st.stage(np.array([5, 90, 0]), np.zeros(3), np.array([1, 1, 0]), np.zeros(3))
    eng._decode_call(st, 4)
    torch.cuda.synchronize()
    assert eng._graphs.captured == 1


def test_launches_after_replays_equal_eager(cuda):
    """N replays of the decode chunk count N times its graph's launches,
    as N eager calls do."""
    from repro_torch.serving import EngineConfig, ServingEngine

    ecfg = EngineConfig(max_len=2048, decode_batch=3, decode_chunk=4)
    counts = []
    for graphs in (True, False):
        eng = ServingEngine(_graph_model(), ecfg, graphs=graphs)
        st = eng._session_state()
        st.stage(np.array([5, 900, 0]), np.zeros(3), np.array([1, 1, 0]), np.zeros(3))
        kernel.reset_launches()
        for _ in range(5):
            eng._decode_call(st, 4)
        torch.cuda.synchronize()
        counts.append(dict(kernel.LAUNCHES))
    assert counts[0] == counts[1]
    assert counts[0]["decode_attention_splitk"] == 5 * 4 * _graph_model().cfg.n_layers



# ---------------------------------------------------------------------------
# speculative decoding: the verify step as a CUDA graph per ("spec", Qs,
# window), captured against eager on the graph model at a 16-token vocab
# (greedy streams on random weights loop, so drafts are accepted)
# ---------------------------------------------------------------------------


@functools.cache
def _spec_model():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduce(), head_dim=64, vocab_size=16)
    return Model(cfg, device="cuda").init_(torch.Generator("cuda").manual_seed(0))


def _serve_spec(graphs, spec_k, **ecfg_kw):
    """Serve seven requests (prompts 3-60, 6-30 new tokens) at draft depth
    ``spec_k`` with the mixed and verify grids and the decode chunk warmed;
    returns the streams, the served run's launches, the verify steps it
    dispatched and the session."""
    from repro_torch.serving import EngineClient, EngineConfig, InferenceRequest, ServingEngine

    model = _spec_model()
    kw = dict(max_len=256, decode_batch=3, decode_chunk=4, prefill_chunk=24, spec_k=spec_k)
    kw.update(ecfg_kw)
    eng = ServingEngine(model, EngineConfig(**kw), graphs=graphs)
    eng.warm_mixed_traces([kw["prefill_chunk"]])
    eng.warm_spec_traces([spec_k])
    eng.warm_decode()
    verify_steps = []
    spec_call = eng._spec_call

    def counted(st, Qs, aw):
        verify_steps.append((Qs, aw))
        return spec_call(st, Qs, aw)

    eng._spec_call = counted
    for m in (kernel, norm_kernel):
        m.reset_launches()
    rng = np.random.default_rng(1)
    cli = EngineClient(eng)
    hs = [cli.submit(InferenceRequest(prompt=rng.integers(0, 16, int(p)), max_new=int(m)))
          for p, m in zip(rng.integers(3, 60, 7), rng.integers(6, 30, 7))]
    cli.drain()
    return [h.result() for h in hs], dict(kernel.LAUNCHES), verify_steps, cli.session


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("spec_k", [1, 3, 4, 8])             # Qs 2, 4, 8, 16
def test_captured_spec_session_equals_eager(cuda, spec_k, paged):
    """Verify steps replayed from CUDA graphs give the eager streams token
    for token and the same launch counts; every verify step and mixed step
    launches the mixed-attention kernel once a layer; a warmed engine
    prepares no bucket while serving; the verify graphs' only output is
    the (3, B, Qs) verdict."""
    from repro_torch.serving import spec_quantum

    got, launches, steps, sess = _serve_spec(True, spec_k, paged_kv=paged)
    want, want_launches, want_steps, _ = _serve_spec(False, spec_k, paged_kv=paged)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert launches == want_launches and steps == want_steps
    Qs = spec_quantum(spec_k)
    assert steps and {q for q, _ in steps} == {Qs}
    eng = sess.eng
    tel = eng.telemetry
    assert tel.spec_rounds > 0 and 0 < tel.accepted_tokens <= tel.drafted_tokens
    mixed = "mixed_attention_paged" if paged else "mixed_attention"
    assert launches[mixed] == _spec_model().cfg.n_layers * (tel.mixed_steps + len(steps))
    # warmed: every bucket the pumps used was captured before them
    windows = eng._windows(Qs)
    assert eng.mixed_traces == len(eng._windows(eng.chunk_quantum(24))) + len(windows)
    spec_graphs = {k: g for k, g in sess.st.graphs.items() if k[0] == "spec"}
    assert sorted(k[2] for k in spec_graphs) == windows
    for g in spec_graphs.values():
        assert isinstance(g.outputs, torch.Tensor)
        assert g.outputs.shape == (3, 3, Qs) and g.outputs.dtype == torch.int32


@pytest.mark.parametrize("paged", [False, True])
def test_captured_spec_temperature_session_equals_eager(cuda, paged):
    """A seeded temperature > 0 speculating session: the verify step's
    draws come from the generator registered with its graph; captured and
    eager give the same streams."""
    got, _, steps, _ = _serve_spec(True, 4, paged_kv=paged, temperature=0.8, seed=11)
    want, _, want_steps, _ = _serve_spec(False, 4, paged_kv=paged, temperature=0.8, seed=11)
    assert steps == want_steps
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _spec_calls(rng, B, Qs, P, nb, vocab):
    """Three sets of verify inputs: lengths, new lengths (0 for an idle
    slot, else 1 + drafts), the carries and drafts, block tables."""
    calls = []
    for _ in range(3):
        new = np.where(rng.random(B) < 0.25, 0, rng.integers(1, Qs + 1, B))
        calls.append((rng.integers(0, 200, B), new, rng.integers(0, vocab, (B, Qs)),
                      rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)))
    return calls


@pytest.mark.parametrize("paged", [False, True])
def test_spec_replay_reads_new_lengths_tables_and_drafts(cuda, paged):
    """A verify step replayed after the lengths, tables and drafts change
    equals the eager step at the new values, bit for bit; its graph's only
    output is the verdict."""
    from repro_torch.serving import EngineConfig, ServingEngine

    model = _spec_model()
    rng = np.random.default_rng(41)
    B, Qs, aw = 3, 8, 256
    ecfg = EngineConfig(max_len=256, decode_batch=B, spec_k=4, paged_kv=paged)
    engines = [ServingEngine(model, ecfg, graphs=g) for g in (True, False)]
    calls = _spec_calls(rng, B, Qs, engines[0].num_pages, engines[0].max_blocks,
                        model.cfg.vocab_size)
    outs = []
    for eng in engines:
        st, got = eng._session_state(), []
        for lens, new, chunks, tables in calls:
            zero = np.zeros(B)
            st.stage(lens, new, zero, zero, tables)
            st.chunk(Qs).fill(chunks)
            got.append(eng._spec_call(st, Qs, aw).clone())
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], outs[0][1])
    assert engines[0]._graphs.captured == 1
    verdict = engines[0]._session_state().graphs[("spec", Qs, aw)].outputs
    assert isinstance(verdict, torch.Tensor)
    assert verdict.shape == (3, B, Qs) and verdict.dtype == torch.int32


def test_spec_launches_after_replays_equal_eager(cuda):
    """N replays of a verify step count N times its graph's launches, as N
    eager calls do: one mixed-attention launch a layer a step."""
    from repro_torch.serving import EngineConfig, ServingEngine

    model = _spec_model()
    B, Qs = 3, 16
    counts = []
    for graphs in (True, False):
        eng = ServingEngine(model, EngineConfig(max_len=256, decode_batch=B, spec_k=8),
                            graphs=graphs)
        st = eng._session_state()
        st.stage(np.array([5, 90, 0]), np.array([9, 16, 0]), np.zeros(B), np.zeros(B))
        st.chunk(Qs).fill(np.random.default_rng(5).integers(0, 16, (B, Qs)))
        kernel.reset_launches()
        for _ in range(5):
            eng._spec_call(st, Qs, 128)
        torch.cuda.synchronize()
        counts.append(dict(kernel.LAUNCHES))
    assert counts[0] == counts[1]
    assert counts[0]["mixed_attention"] == 5 * model.cfg.n_layers


# ---------------------------------------------------------------------------
# durable KV: frontiers extracted from and injected into the pools and slots
# the captured steps read, on the graph model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inject_roundtrip_bit_exact(cuda, dtype):
    """``extract_pages`` then ``_inject_pages`` into other pages of a second
    pool: every page bit-equal (a bf16 leaf travels as float32 on the host,
    which holds it exactly)."""
    from repro_torch.models import DecoderKVCache
    from repro_torch.serving import EngineConfig, ServingEngine

    eng = ServingEngine(_graph_model(), EngineConfig(max_len=256, paged_kv=True), graphs=False)
    gen = torch.Generator("cuda").manual_seed(3)
    shape = (2, 12, 16, 2, 64)
    pool = DecoderKVCache(*(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                            for _ in range(2)))
    pool2 = DecoderKVCache(*(torch.zeros(shape, device="cuda", dtype=dtype) for _ in range(2)))
    src, dst = [5, 2, 9], [1, 11, 3]
    kv = eng.extract_pages(pool, src)
    assert all(leaf.dtype == np.float32 and leaf.shape == (2, 3, 16, 2, 64) for leaf in kv)
    eng._inject_pages(pool2, kv, dst)
    for a, b in zip(pool, pool2):
        assert torch.equal(a[:, src], b[:, dst])
        assert not b[:, [0, 4]].any()
    with pytest.raises(ValueError, match="does not fit"):
        eng._inject_pages(pool2, kv, dst[:2])


@pytest.mark.parametrize("mixed", [True, False])
def test_restore_into_captured_session_equals_eager(cuda, mixed):
    """Frontiers taken mid-decode, restored into a fresh session whose
    graphs were captured before the restore (the inject writes the pool
    they read, in place), with two new requests beside them: the streams
    and launches equal ``graphs=False``'s, and the pumps capture nothing."""
    from repro_torch.serving import EngineConfig, ServingEngine

    model = _graph_model()
    reqs = _graph_requests(model.cfg.vocab_size, n=5, seed=4)
    out = []
    for graphs in (True, False):
        eng = ServingEngine(model, EngineConfig(max_len=256, decode_batch=3, decode_chunk=4,
                                                prefill_chunk=24, paged_kv=True,
                                                mixed_step=mixed), graphs=graphs)
        first = eng.new_session()
        for rid, (p, _) in enumerate(reqs[:3]):
            first.submit(rid, p[None], 40)
        first.pump()
        frs = dict(first.extract_frontiers())
        assert sorted(frs) == [0, 1, 2]
        for rid in frs:
            first.cancel(rid)
        eng.warm_mixed_traces([24])
        eng.warm_decode()
        captured = eng._graphs.captured if graphs else 0
        sess = eng.new_session()
        for m in (kernel, norm_kernel):
            m.reset_launches()
        for rid, (p, n) in enumerate(reqs):
            sess.submit(rid, p[None], 40 if rid in frs else n, frontier=frs.get(rid))
        rep = sess.pump()
        assert rep.recovered_tokens == sum(fr.tokens for fr in frs.values())
        while not sess.idle:
            sess.pump()
        torch.cuda.synchronize()
        if graphs:
            assert eng._graphs.captured == captured
        assert sess.allocator.live_pages == 0
        out.append(([sess.results[r] for r in range(len(reqs))], dict(kernel.LAUNCHES)))
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
    assert out[0][1] == out[1][1]


# ---------------------------------------------------------------------------
# the fleet on the card: captured replicas against eager ones
# ---------------------------------------------------------------------------


def _fleet_run(graphs, **kw):
    """The demo fleet (fp32 reduced qwen3) on the card, its engines
    captured (``graphs=True``) or eager."""
    from repro_torch.fleet.runtime import build_demo_fleet
    from repro_torch.serving import ServingEngine

    rt = build_demo_fleet(device="cuda", **kw)
    for spec in rt.tiers:
        eng = rt._engine_for(spec)
        rt._engines[spec.name] = ServingEngine(eng.model, eng.cfg, device="cuda", graphs=graphs)
    return rt, rt.run()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_captured_fleet_equals_eager(cuda, paged):
    """The failover drill on the card: replicas whose steps are CUDA graphs
    make the same decisions and serve the same tokens as eager replicas;
    every decision explains itself, and only captured replicas record
    ``engine.capture``."""
    import dataclasses

    runs = [_fleet_run(g, n_requests=24, rate=2.0, outage=(6.0, 12.0), paged=paged)
            for g in (True, False)]
    (crt, cap), (ert, eag) = runs
    assert cap.mode_trace == eag.mode_trace
    assert [dataclasses.asdict(d) for d in cap.decisions] == \
        [dataclasses.asdict(d) for d in eag.decisions]
    assert all(d.explains() for d in cap.decisions)
    assert [dataclasses.asdict(r) for r in cap.requests.records] == \
        [dataclasses.asdict(r) for r in eag.requests.records]
    assert sorted(cap.outputs) == sorted(eag.outputs)
    for rid in cap.outputs:
        np.testing.assert_array_equal(cap.outputs[rid], eag.outputs[rid])
    assert not cap.requests.dropped and cap.requests.total_retries() >= 1
    assert crt.tracer.select(name="engine.capture")
    assert not ert.tracer.select(name="engine.capture")
    assert not crt.tracer.select(name="engine.compile")
