"""Wrapper of the CUDA WKV6 recurrence (``csrc/wkv6.cu``).

``wkv6_cuda`` replaces ``wkv6_pallas``.  It checks device, dtypes, shapes
and strides, allocates y and the final state with ``torch.empty``,
launches on PyTorch's current stream without synchronising, raises if the
launch was refused, and adds one to ``LAUNCHES["wkv6"]``.  bf16 inputs go
to the chunked tensor-core kernel (``wkv6_chunk_kernel``), fp32 inputs to
the serial token kernel (``wkv6_kernel``); one launch either way.

r, k, v and logw may be views with any batch and sequence strides (the
kernel reads them in place) as long as each token's (H, N) block is dense.
The bf16 kernel stages them with 16-byte copies, so there each must also
be 16-byte aligned, with batch and sequence strides of whole 16 bytes; a
view that is not raises.

The bf16 kernel runs one CTA per (batch, head, slice of the state's value
columns); ``chunk_cols`` picks the slice width from the shape.

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
    lib.wkv6_fwd.argtypes = [_I, _I, _I, *[_P] * 8, _I, _I, _I, *[_LL] * 8, _P]
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
        # the bf16 kernel's cp.async copies move 16 bytes of a row at a time
        if r.dtype == torch.bfloat16 and (
                t.data_ptr() % 16
                or any(t.shape[i] > 1 and (t.stride(i) * t.element_size()) % 16 for i in (0, 1))):
            raise ValueError(f"bf16 {name} must be 16-byte aligned, with 16-byte batch and "
                             f"sequence strides: strides {t.stride()}")
    if r.dtype == torch.bfloat16 and state0 is not None and state0.data_ptr() % 16:
        raise ValueError("with bf16 inputs state0 must be 16-byte aligned")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_cols(B: int, H: int, N: int, sms: int) -> int:
    """Value columns per CTA of the bf16 chunk kernel: the state's N columns
    split into the most slices (a power of two, none narrower than 16) that
    keep B * H * slices CTAs within one per SM, or one slice where B * H
    alone reaches that.  Each CTA walks the whole sequence, so CTAs beyond
    one per SM would wait for a whole CTA's time, and every slice repeats
    the chunk's score work.  B=1, H=64, N=64 on 132 SMs: 2 slices of 32,
    128 CTAs; B=8: one slice of 64, 512 CTAs."""
    slices = N // 16
    while slices > 1 and B * H * slices > sms:
        slices //= 2
    return N // slices


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
              u: torch.Tensor, state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over a sequence: r/k/v (B, S, H, N) bf16 or fp32, logw (B, S, H, N)
    fp32, u (H, N) in r's dtype, state0 (B, H, N, N) fp32 or None (zeros).
    Returns y (B, S, H, N) fp32 and the final state (B, H, N, N) fp32."""
    _check(r, k, v, logw, u, state0)
    B, _, H, N = r.shape
    return launch(r, k, v, logw, u, state0, chunk_cols(B, H, N, _sm_count(r.get_device())))


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
           u: torch.Tensor, state0: Optional[torch.Tensor], cols: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``wkv6_fwd`` on inputs that ``_check`` passed, with
    ``cols`` value columns per CTA of the bf16 kernel (16, 32 or 64, at most
    N; the fp32 kernel ignores it).  ``wkv6_cuda`` passes ``chunk_cols``'s
    width; ``chip_smoke.py`` phase 6 times every width through this."""
    B, S, H, N = r.shape
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    rc = _lib().wkv6_fwd(
        _DTYPES[r.dtype], N, cols, r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if state0 is None else state0.data_ptr(), y.data_ptr(),
        state.data_ptr(), B, S, H,
        r.stride(0), r.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        logw.stride(0), logw.stride(1), torch.cuda.current_stream(r.device).cuda_stream,
    )
    if rc != 0:
        what = "unsupported dtype/head size/width" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"wkv6 launch failed: {what}")
    LAUNCHES["wkv6"] += 1
    return y, state
