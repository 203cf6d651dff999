"""Wrapper of the CUDA row RMSNorm (``csrc/rmsnorm.cu``).

``rmsnorm_cuda`` replaces ``rmsnorm_pallas`` in both its forms: the plain
norm (the TPU ``_rmsnorm_kernel``) and the residual add fused with the norm
(``_rmsnorm_fused_kernel``).  It checks device, dtypes, shapes and
alignment, allocates its outputs with ``torch.empty``, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and adds one to ``LAUNCHES["rmsnorm"]`` or
``LAUNCHES["rmsnorm_fused"]``.

x (and the residual) are contiguous (..., d) tensors, taken as M rows of
d; d must split into 16-byte packs (a multiple of 8 in bf16, of 4 in fp32).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
MAX_PACKS = 8 * 512     # 16-byte packs per row: at most 8 per thread of a 512-thread CTA
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per form, counted where the wrapper launches and nowhere else
LAUNCHES = {"rmsnorm": 0, "rmsnorm_fused": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load(SOURCE)
    lib.rmsnorm_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _F, _P]
    lib.rmsnorm_fwd.restype = _I
    return lib


def _check(x: torch.Tensor, weight: torch.Tensor, residual: Optional[torch.Tensor]) -> None:
    tensors = (x, weight) + (() if residual is None else (residual,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("CUDA kernel wrappers take CUDA tensors only")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype or (
            residual is not None and residual.dtype != x.dtype):
        raise TypeError(f"x, weight and residual dtypes must match and be one of "
                        f"{list(_DTYPES)}: {x.dtype}, {weight.dtype}, "
                        f"{None if residual is None else residual.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    d = x.shape[-1]
    if weight.shape != (d,) or not weight.is_contiguous():
        raise ValueError(f"weight must be a contiguous ({d},) tensor: {tuple(weight.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} does not match x {tuple(x.shape)}")
    pack = 16 // x.element_size()
    if d % pack or d // pack > MAX_PACKS:
        raise ValueError(f"row width {d} must be a multiple of {pack} and at most "
                         f"{MAX_PACKS * pack} for {x.dtype}")
    for name, t in (("x", x), ("weight", weight), ("residual", residual)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned: "
                             f"strides {t.stride()}")


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor,
                 residual: Optional[torch.Tensor] = None, *,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm of the rows of x (..., d), in bf16 or fp32, with a (d,) weight
    in x's dtype.  Without ``residual`` returns (normed, x); with it,
    (normed(x + residual), x + residual): the sum in fp32, normalised before
    it is rounded, returned in x's dtype."""
    _check(x, weight, residual)
    d = x.shape[-1]
    M = x.numel() // d
    out = torch.empty_like(x)
    summed = x if residual is None else torch.empty_like(x)
    rc = _lib().rmsnorm_fwd(
        _DTYPES[x.dtype], x.data_ptr(), None if residual is None else residual.data_ptr(),
        weight.data_ptr(), out.data_ptr(), None if residual is None else summed.data_ptr(),
        M, d, eps, torch.cuda.current_stream(x.device).cuda_stream,
    )
    name = "rmsnorm" if residual is None else "rmsnorm_fused"
    if rc != 0:
        what = "unsupported dtype/width" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"{name} launch failed: {what}")
    LAUNCHES[name] += 1
    return out, summed
