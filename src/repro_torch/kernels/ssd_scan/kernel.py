"""Wrapper of the CUDA Mamba-2 SSD scan (``csrc/ssd.cu``).

``ssd_cuda`` replaces ``ssd_pallas``.  It checks device, dtypes, shapes,
strides and alignment, allocates y and the final state with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to
``LAUNCHES["ssd"]``.  bf16 inputs go to the chunked tensor-core kernel
(``ssd_chunk_kernel``), fp32 inputs to the serial token kernel
(``ssd_kernel``); one launch either way.

x, B and C may be views with any batch and sequence strides (the kernel
reads them in place: ``mamba2_layer`` slices them out of the conv output)
as long as each token's (H, P) block of x and N values of B and C are
dense and every row starts on 16 bytes (the kernels read them as 16-byte
vectors).  dt may have any batch and sequence strides with its heads
dense.

The bf16 kernel runs one CTA per (batch, head, slice of the head's
channels); ``chunk_rows`` picks the slice width from P.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
STATE_SIZES = (16, 32, 64)
P_SLICE = 16            # channels of one head per CTA: P must be a multiple
ROW_SLICES = (16, 32, 64)   # channels per CTA of the bf16 chunk kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches, counted where the wrapper launches and nowhere else
LAUNCHES = {"ssd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load(SOURCE)
    lib.ssd_fwd.argtypes = [_I, _I, _I, *[_P] * 8, _I, _I, _I, _I, *[_LL] * 8, _P]
    lib.ssd_fwd.restype = _I
    return lib


def _aligned(t: torch.Tensor, dims) -> bool:
    """16-byte start and 16-byte strides on ``dims``."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all((t.stride(i) * es) % 16 == 0 for i in dims)


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, state0: Optional[torch.Tensor]) -> None:
    tensors = (x, dt, A, Bm, Cm) + (() if state0 is None else (state0,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("CUDA kernel wrappers take CUDA tensors only")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x/B/C dtypes must match and be one of {list(_DTYPES)}: "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or (
            state0 is not None and state0.dtype != torch.float32):
        raise TypeError(f"dt, A and state0 must be float32: {dt.dtype}, {A.dtype}, "
                        f"{None if state0 is None else state0.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"x must be (B, S, H, P), dt (B, S, H), B and C both (B, S, N): "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, S, H) or Bm.shape[:2] != (B, S):
        raise ValueError(f"dt {tuple(dt.shape)} / B {tuple(Bm.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not in {STATE_SIZES}")
    if P % P_SLICE or P < 1:
        raise ValueError(f"head channels {P} not a multiple of {P_SLICE}")
    if S < 1 or B < 1 or H < 1:
        raise ValueError(f"empty input: B={B} S={S} H={H}")
    if A.shape != (H,) or not A.is_contiguous():
        raise ValueError(f"A must be a contiguous (H,) = ({H},) tensor: {tuple(A.shape)}")
    if state0 is not None and (state0.shape != (B, H, P, N) or not state0.is_contiguous()):
        raise ValueError(f"state0 must be a contiguous (B, H, P, N) = ({B}, {H}, {P}, {N}) "
                         f"tensor: {tuple(state0.shape)} strides {state0.stride()}")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError(f"x must be dense in (H, P): strides {x.stride()}")
    for name, t in (("B", Bm), ("C", Cm)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} must be dense in N: strides {t.stride()}")
    if dt.stride(2) != 1:
        raise ValueError(f"dt must be dense in H: strides {dt.stride()}")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if not _aligned(t, (0, 1)):
            raise ValueError(f"{name} must be 16-byte aligned, with 16-byte batch and "
                             f"sequence strides: strides {t.stride()}")
    if x.dtype == torch.bfloat16 and state0 is not None and state0.data_ptr() % 8:
        raise ValueError("with bf16 inputs state0 must be 8-byte aligned")


def chunk_rows(P: int) -> int:
    """Channels per CTA of the bf16 chunk kernel: the widest of 64, 32 and
    16 that divides P.  Each CTA walks the whole sequence and every slice
    repeats the chunk's C . B^T, so one slice per head is the cheapest; at
    zamba2-2.7b's shapes (P=64; B=1 and B=8, S 2000 and 512) it is also the
    fastest of the three widths on an H100 (PERF.md, PR 20)."""
    return next(r for r in sorted(ROW_SLICES, reverse=True) if P % r == 0)


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, state0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan over a sequence: x (B, S, H, P) and B/C (B, S, N) in bf16 or
    fp32, dt (B, S, H) fp32, A (H,) fp32, state0 (B, H, P, N) fp32 or None
    (zeros).  Returns y (B, S, H, P) fp32 and the final state (B, H, P, N)
    fp32."""
    _check(x, dt, A, Bm, Cm, state0)
    return launch(x, dt, A, Bm, Cm, state0, chunk_rows(x.shape[-1]))


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, state0: Optional[torch.Tensor], rows: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``ssd_fwd`` on inputs that ``_check`` passed, with
    ``rows`` channels per CTA of the bf16 kernel (16, 32 or 64, dividing P;
    the fp32 kernel ignores it).  ``ssd_cuda`` passes ``chunk_rows``'s
    width; ``chip_smoke.py`` phase 6 times every width through this."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    rc = _lib().ssd_fwd(
        _DTYPES[x.dtype], N, rows, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if state0 is None else state0.data_ptr(), y.data_ptr(),
        state.data_ptr(), B, S, H, P,
        x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), Bm.stride(0), Bm.stride(1),
        Cm.stride(0), Cm.stride(1), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        what = "unsupported dtype/state size/slice" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"ssd launch failed: {what}")
    LAUNCHES["ssd"] += 1
    return y, state
