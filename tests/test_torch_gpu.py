"""Card-only tests of the port: every CUDA kernel against its plain version
(the paged kernels at page sizes 4, 8, 16 and 64; the flash-attention
forward causal and not, windowed, with Sk > Sq, at ragged lengths 1 to
2000, G 1, 2 and 4, head_dim 64, 80 and 128, and on strided views; the
decode and split-K kernels also at zamba2's head_dim 80 and G 1; the WKV6
recurrence at lengths 1 to 2000, 1 to 64 heads of 16, 32 and 64, with a
zero or random initial state, a slow decay and strided views; the SSD scan
at lengths 1 to 2000, P 32 and 64, N 16 and 64, at zamba2's prefill shape,
with a slow decay, a random state and on strided views; the RMSNorm in
both forms at widths 128, 2560 and 5120 over 1 to 2000 rows).

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
versions in both dtypes, so they are held at the scan tolerance of
``tests/test_kernels.py`` (atol 5e-4, rtol 1e-3) on y and the final state.
The RMSNorm kernel and its plain version round the same fp32 function once:
fp32 atol 2e-5 / rtol 1e-3, bf16 within one bf16 ulp (rtol 2^-7), and the
fused form's rounded sum bit for bit.
"""
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
    # the combine on identical partials
    _close(kernel.splitk_combine_cuda(m_r, l_r, acc_r, dtype),
           ref.splitk_combine(m_r, l_r, acc_r, dtype), dtype)
    # and the pair end to end
    _close(kernel.decode_attention_splitk_cuda(q, k, v, lens, k_splits=k_splits),
           ref.decode_attention(q, k, v, lens), dtype)


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
    assert kernel.LAUNCHES == {"decode_attention": 1, "decode_attention_splitk_partial": 1,
                               "decode_attention_splitk_combine": 2, "mixed_attention": 1,
                               "decode_attention_paged": 1,
                               "decode_attention_paged_splitk_partial": 1,
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


def _wkv_inputs(rng, B, S, H, N, dtype, dev, *, slow=False, state=True):
    """r, k, v in ``dtype``; logw fp32 as the model makes it (-exp of a
    log-decay near w0 = -2), or with ``slow`` near -5, where the state
    keeps thousands of tokens; u in ``dtype``; state0 fp32 or None."""
    r, k, v = (torch.as_tensor(rng.standard_normal((B, S, H, N)), dtype=torch.float32)
               .to(dev, dtype) for _ in range(3))
    mu = -5.0 if slow else -2.0
    logw = -torch.exp(torch.as_tensor(mu + 0.5 * rng.standard_normal((B, S, H, N)),
                                      dtype=torch.float32)).to(dev)
    u = torch.as_tensor(rng.standard_normal((H, N)) * 0.5, dtype=torch.float32).to(dev, dtype)
    s0 = (torch.as_tensor(rng.standard_normal((B, H, N, N)), dtype=torch.float32).to(dev)
          if state else None)
    return r, k, v, logw, u, s0


def _wkv_close(r, k, v, logw, u, s0):
    """The kernel against both plain versions, on y and the final state."""
    y, st = wkv_kernel.wkv6_cuda(r, k, v, logw, u, s0)
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
    _wkv_close(*_wkv_inputs(rng, 2, S, 4, 64, dtype, cuda, slow=True))


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
    _close(kernel.splitk_combine_cuda(m_r, l_r, acc_r, dtype),
           ref.splitk_combine(m_r, l_r, acc_r, dtype), dtype)
    _close(ops.decode_attention(q, k, v, lens), ref.decode_attention(q, k, v, lens), dtype)


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


def _ssd_inputs(rng, B, S, H, P, N, dtype, dev, *, slow=False, state=True):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1)) fp32; A =
    -exp(0.3 N(0, 1)), or with ``slow`` -1e-3 times that, where the state
    keeps thousands of steps; state0 fp32 or None.  With ``slow`` x is
    scaled by 1/16 (exact in bf16), so y keeps the scale of the fast case
    (mean |y| ~9 rather than ~130) that the scan tolerance is set for: at
    unit x the two plain versions alone differ by up to 2.9e-3 at S=2000,
    fp32 summation order over 2000 steps, not a fault."""
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)
    x = f32(rng.standard_normal((B, S, H, P)) / (16.0 if slow else 1.0)).to(dtype)
    dt = torch.nn.functional.softplus(f32(rng.standard_normal((B, S, H))))
    A = -(1e-3 if slow else 1.0) * torch.exp(0.3 * f32(rng.standard_normal(H)))
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
