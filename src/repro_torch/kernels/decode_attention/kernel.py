"""Wrappers of the CUDA flash-decoding kernels (``csrc/decode_attention.cu``).

Each wrapper checks device, dtype, shape and strides, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its entry
of ``LAUNCHES``:

* ``decode_attention_cuda`` — replaces ``decode_attention_pallas``;
* ``splitk_partial_cuda`` / ``splitk_combine_cuda`` — the two stages of
  ``decode_attention_splitk``;
* ``mixed_attention_cuda`` — replaces ``mixed_attention_pallas``.

The library is built on the first call (``kernels._build``).  These take
CUDA tensors only; ``ops`` sends CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per kernel, counted where each wrapper launches and nowhere else
LAUNCHES = {
    "decode_attention": 0,
    "decode_attention_splitk_partial": 0,
    "decode_attention_splitk_combine": 0,
    "mixed_attention": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load(SOURCE)
    lib.flash_rows.argtypes = [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _F, _P,
    ]
    lib.flash_rows.restype = _I
    lib.splitk_combine.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.splitk_combine.restype = _I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        what = "unsupported dtype/head_dim" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"{name} launch failed: {what}")


def _check_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lens: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda and lens.is_cuda):
        raise ValueError("CUDA kernel wrappers take CUDA tensors only")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes must match and be one of {list(_DTYPES)}: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"k/v must both be (B, S, Hkv, D): {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hkv, D = k.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != D or t.stride(1) != Hkv * D:
            raise ValueError(f"{name} must be dense in (S, Hkv, D) (a batch stride is fine): "
                             f"strides {t.stride()}")
        # the kernel reads K/V rows as 16-byte vectors
        if t.data_ptr() % 16 or (t.stride(0) * t.element_size()) % 16:
            raise ValueError(f"{name} must be 16-byte aligned, with a 16-byte batch stride")
    if q.stride(-1) != 1 or q.stride(-2) != D:
        raise ValueError(f"q must be dense in (Hq, D): strides {q.stride()}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or not lens.is_contiguous():
        raise ValueError(f"lengths must be a contiguous (B,) int32 tensor: {lens.dtype} {tuple(lens.shape)}")
    if q.shape[-1] != D or q.shape[-2] % Hkv or q.shape[0] != B:
        raise ValueError(f"q {tuple(q.shape)} does not match kv {tuple(k.shape)}")


def _rows(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
          *, add: int, splits: int, out: Optional[torch.Tensor],
          partial: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
          name: str) -> None:
    B, Q, Hq, D = q4.shape
    _, S, Hkv, _ = k.shape
    m, l, acc = partial if partial is not None else (None, None, None)
    rc = _lib().flash_rows(
        _DTYPES[q4.dtype], D, q4.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr() if out is not None else None,
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None,
        acc.data_ptr() if acc is not None else None,
        B, Q, Hq, Hkv, S, splits, add,
        q4.stride(0), q4.stride(1), k.stride(0), v.stride(0), 1.0 / math.sqrt(D), _stream(q4),
    )
    _check_launch(rc, name)
    LAUNCHES[name] += 1


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Single-stage flash decoding: q (B, Hq, D) vs K/V (B, S, Hkv, D)."""
    _check_kv(q, k_cache, v_cache, lengths)
    B, Hq, D = q.shape
    q4 = q.unsqueeze(1)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    _rows(q4, k_cache, v_cache, lengths, add=0, splits=1, out=out, partial=None,
          name="decode_attention")
    return out[:, 0]


def splitk_partial_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        lengths: torch.Tensor, *, k_splits: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1 of split-K decoding: m, l (B, Hkv, K, G), acc (B, Hkv, K, G, D) fp32."""
    _check_kv(q, k_cache, v_cache, lengths)
    B, S, Hkv, D = k_cache.shape
    G = q.shape[1] // Hkv
    if k_splits < 1 or S % k_splits:
        raise ValueError(f"cache length {S} not divisible by k_splits={k_splits}")
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hkv, k_splits, G), **f32)
    l = torch.empty((B, Hkv, k_splits, G), **f32)
    acc = torch.empty((B, Hkv, k_splits, G, D), **f32)
    _rows(q.unsqueeze(1), k_cache, v_cache, lengths, add=0, splits=k_splits, out=None,
          partial=(m, l, acc), name="decode_attention_splitk_partial")
    return m, l, acc


def splitk_combine_cuda(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """Stage 2 of split-K decoding: LSE merge of the partials -> (B, Hq, D)."""
    B, Hkv, K, G, D = acc.shape
    for name, t, shape in (("m", m, (B, Hkv, K, G)), ("l", l, (B, Hkv, K, G)),
                           ("acc", acc, (B, Hkv, K, G, D))):
        if not t.is_cuda or t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 CUDA tensor of shape {shape}")
    if dtype not in _DTYPES:
        raise TypeError(f"output dtype {dtype} not in {list(_DTYPES)}")
    out = torch.empty((B, Hkv * G, D), dtype=dtype, device=acc.device)
    rc = _lib().splitk_combine(_DTYPES[dtype], m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                               out.data_ptr(), B, Hkv, G, K, D, _stream(acc))
    _check_launch(rc, "decode_attention_splitk_combine")
    LAUNCHES["decode_attention_splitk_combine"] += 1
    return out


def decode_attention_splitk_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                                 k_splits: int) -> torch.Tensor:
    """Two-stage split-K flash decoding (partial kernel, then combine)."""
    m, l, acc = splitk_partial_cuda(q, k_cache, v_cache, lengths, k_splits=k_splits)
    return splitk_combine_cuda(m, l, acc, q.dtype)


def mixed_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         cache_lens: torch.Tensor) -> torch.Tensor:
    """q-chunk attention: q (B, Q, Hq, D); row i sees keys <= cache_lens[b] + i."""
    _check_kv(q, k_cache, v_cache, cache_lens)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _rows(q, k_cache, v_cache, cache_lens, add=1, splits=1, out=out, partial=None,
          name="mixed_attention")
    return out
