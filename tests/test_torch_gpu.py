"""Card-only tests of the port: every CUDA kernel against its plain version.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card, which
skips when ``torch.cuda.is_available()`` is false.  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 atol 2e-5 / rtol 1e-3; bf16 atol 2e-2, and each output
row's largest error within a tenth of that row's RMS -- the sums run in
another order than the plain version's einsum, p rounds to bf16 before
the PV product and outputs round at one ulp (2^-8 relative).  The row
check is there because an output element at length L is only about
sqrt(e / L) in size (0.026 at L=4096), below the flat bf16 atol.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel, ops, ref

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
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == {"decode_attention": 1, "decode_attention_splitk_partial": 1,
                               "decode_attention_splitk_combine": 1, "mixed_attention": 1}


def test_kernel_rejects_bad_layout(cuda):
    k = torch.zeros((1, 64, 2, 64), device=cuda)
    q = torch.zeros((1, 4, 64), device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernel.decode_attention_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2), k, lens)
    with pytest.raises(ValueError):
        kernel.decode_attention_cuda(q, k, k, lens.long())
