"""Wrapper of the CUDA WKV6 recurrence (``csrc/wkv6.cu``).

``wkv6_cuda`` replaces ``wkv6_pallas``.  It checks device, dtypes, shapes
and strides, allocates y and the final state with ``torch.empty``,
launches on PyTorch's current stream without synchronising, raises if the
launch was refused, and adds one to ``LAUNCHES["wkv6"]``.

r, k, v and logw may be views with any batch and sequence strides (the
kernel reads them in place) as long as each token's (H, N) block is dense.

The library is built on the first call (``kernels._build``).  This takes
CUDA tensors only; ``ops`` sends CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
HEAD_SIZES = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches, counted where the wrapper launches and nowhere else
LAUNCHES = {"wkv6": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load(SOURCE)
    lib.wkv6_fwd.argtypes = [_I, _I, *[_P] * 8, _I, _I, _I, *[_LL] * 8, _P]
    lib.wkv6_fwd.restype = _I
    return lib


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
           u: torch.Tensor, state0: Optional[torch.Tensor]) -> None:
    tensors = (r, k, v, logw, u) + (() if state0 is None else (state0,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("CUDA kernel wrappers take CUDA tensors only")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype or u.dtype != r.dtype:
        raise TypeError(f"r/k/v/u dtypes must match and be one of {list(_DTYPES)}: "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    if logw.dtype != torch.float32 or (state0 is not None and state0.dtype != torch.float32):
        raise TypeError(f"logw and state0 must be float32: {logw.dtype}, "
                        f"{None if state0 is None else state0.dtype}")
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"r/k/v/logw must all be (B, S, H, N): {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(logw.shape)}")
    B, S, H, N = r.shape
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not in {HEAD_SIZES}")
    if S < 1 or B < 1:
        raise ValueError(f"empty input: B={B} S={S}")
    if u.shape != (H, N) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous (H, N) = ({H}, {N}) tensor: "
                         f"{tuple(u.shape)} strides {u.stride()}")
    if state0 is not None and (state0.shape != (B, H, N, N) or not state0.is_contiguous()):
        raise ValueError(f"state0 must be a contiguous (B, H, N, N) = ({B}, {H}, {N}, {N}) "
                         f"tensor: {tuple(state0.shape)} strides {state0.stride()}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.stride(3) != 1 or t.stride(2) != N:
            raise ValueError(f"{name} must be dense in (H, N): strides {t.stride()}")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
              u: torch.Tensor, state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over a sequence: r/k/v (B, S, H, N) bf16 or fp32, logw (B, S, H, N)
    fp32, u (H, N) in r's dtype, state0 (B, H, N, N) fp32 or None (zeros).
    Returns y (B, S, H, N) fp32 and the final state (B, H, N, N) fp32."""
    _check(r, k, v, logw, u, state0)
    B, S, H, N = r.shape
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    rc = _lib().wkv6_fwd(
        _DTYPES[r.dtype], N, r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if state0 is None else state0.data_ptr(), y.data_ptr(),
        state.data_ptr(), B, S, H,
        r.stride(0), r.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        logw.stride(0), logw.stride(1), torch.cuda.current_stream(r.device).cuda_stream,
    )
    if rc != 0:
        what = "unsupported dtype/head size" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"wkv6 launch failed: {what}")
    LAUNCHES["wkv6"] += 1
    return y, state
