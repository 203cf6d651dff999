"""Wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

``flash_attention_cuda`` replaces ``flash_attention_pallas``.  It checks
device, dtype, shapes and strides, allocates the output with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to
``LAUNCHES["flash_attention"]``.

q, k and v may be views with any batch and sequence strides (the prefill
passes slices of the fused qkv projection) as long as each head's D values
are contiguous, heads are D apart, and every row starts on 16 bytes.

The library is built on the first call (``kernels._build``).  This takes
CUDA tensors only; ``ops`` sends CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 80, 128)
MAX_GROUP = 64          # a CTA holds 64 (query, head) rows of one kv head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches, counted where the wrapper launches and nowhere else
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load(SOURCE)
    lib.flash_attention_fwd.argtypes = [
        _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _LL, _LL, _F, _P,
    ]
    lib.flash_attention_fwd.restype = _I
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("CUDA kernel wrappers take CUDA tensors only")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes must match and be one of {list(_DTYPES)}: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, Hq, D) and k/v both (B, Sk, Hkv, D): "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"q {tuple(q.shape)} does not match kv {tuple(k.shape)} "
                         f"(Hkv | Hq, at most {MAX_GROUP} q heads per kv head)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Sq < 1 or Sk < 1 or window < 0:
        raise ValueError(f"empty sequence or negative window: Sq={Sq} Sk={Sk} window={window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{name} must be dense in (H, D): strides {t.stride()}")
        # rows are read as 16-byte vectors
        if t.data_ptr() % 16 or any((t.stride(i) * t.element_size()) % 16 for i in (0, 1)):
            raise ValueError(f"{name} must be 16-byte aligned, with 16-byte batch and "
                             f"sequence strides: strides {t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA flash-attention forward: q (B, Sq, Hq, D) vs k/v (B, Sk, Hkv, D)
    -> (B, Sq, Hq, D) in q's dtype."""
    _check(q, k, v, window)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    rc = _lib().flash_attention_fwd(
        _DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, Hq, Hkv, int(bool(causal)), int(window),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        what = "unsupported dtype/head_dim/group" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"flash_attention launch failed: {what}")
    LAUNCHES["flash_attention"] += 1
    return out
