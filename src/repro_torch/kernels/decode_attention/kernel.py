"""Wrappers of the CUDA flash-decoding kernels (``csrc/decode_attention.cu``).

Each wrapper checks device, dtype, shape and strides, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its entry
of ``LAUNCHES``:

* ``decode_attention_cuda`` — replaces ``decode_attention_pallas``;
* ``splitk_partial_cuda`` / ``splitk_combine_cuda`` — the two stages of
  ``decode_attention_splitk``;
* ``mixed_attention_cuda`` — replaces ``mixed_attention_pallas`` (bf16 on
  the tensor cores through ``mixed_mma_kernel``; fp32 and every other
  wrapper through ``flash_rows_kernel`` on the CUDA cores);
* ``decode_attention_paged_cuda`` — replaces ``decode_attention_paged``;
* ``paged_splitk_partial_cuda`` — stage 1 of ``decode_attention_paged_splitk``
  (its stage 2 is the shared ``splitk_combine_cuda``);
* ``mixed_attention_paged_cuda`` — replaces ``mixed_attention_paged`` (as
  ``mixed_attention_cuda``, through the block tables).

The paged wrappers take the (P, page_size, Hkv, D) pool, (B, n_blocks)
int32 block tables (a row stride is allowed, so a column slice
``tables[:, :w]`` is read in place) and (B,) int32 lengths.  The bf16
mixed step copies q's rows with 16-byte cp.async, so its q must be 16-byte
aligned with 16-byte batch and sequence strides.

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
HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per kernel, counted where each wrapper launches and nowhere else
LAUNCHES = {
    "decode_attention": 0,
    "decode_attention_splitk_partial": 0,
    "decode_attention_splitk_combine": 0,
    "mixed_attention": 0,
    "decode_attention_paged": 0,
    "decode_attention_paged_splitk_partial": 0,
    "mixed_attention_paged": 0,
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
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _F, _P,
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


def _check_paged(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 tables: torch.Tensor, lens: torch.Tensor) -> None:
    if not (q.is_cuda and k_pages.is_cuda and v_pages.is_cuda and tables.is_cuda
            and lens.is_cuda):
        raise ValueError("CUDA kernel wrappers take CUDA tensors only")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q/pool dtypes must match and be one of {list(_DTYPES)}: "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(f"k/v pools must both be (P, ps, Hkv, D): "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    _, _, Hkv, D = k_pages.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    for name, t in (("k", k_pages), ("v", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} pool must be contiguous: strides {t.stride()}")
        if t.data_ptr() % 16:               # rows are read as 16-byte vectors
            raise ValueError(f"{name} pool must be 16-byte aligned")
    # a one-row table's row stride is never used (the kernel reads row b = 0)
    if (tables.dtype != torch.int32 or tables.dim() != 2 or tables.shape[0] != q.shape[0]
            or tables.stride(1) != 1
            or (tables.shape[0] > 1 and tables.stride(0) < tables.shape[1])):
        raise ValueError(f"block tables must be (B, n_blocks) int32 with unit column stride: "
                         f"{tables.dtype} {tuple(tables.shape)} strides {tables.stride()}")
    if lens.dtype != torch.int32 or lens.shape != (q.shape[0],) or not lens.is_contiguous():
        raise ValueError(f"lengths must be a contiguous (B,) int32 tensor: {lens.dtype} {tuple(lens.shape)}")
    if q.stride(-1) != 1 or q.stride(-2) != D or q.shape[-1] != D or q.shape[-2] % Hkv:
        raise ValueError(f"q {tuple(q.shape)} strides {q.stride()} does not match the pool "
                         f"{tuple(k_pages.shape)}")


def _check_q_staging(q: torch.Tensor) -> None:
    """The bf16 mixed step stages q's rows with 16-byte cp.async copies."""
    if q.dtype == torch.bfloat16 and (
            q.data_ptr() % 16
            or any(q.shape[i] > 1 and (q.stride(i) * q.element_size()) % 16 for i in (0, 1))):
        raise ValueError(f"bf16 q must be 16-byte aligned, with 16-byte batch and sequence "
                         f"strides: strides {q.stride()}")


def _rows(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
          *, add: int, splits: int, out: Optional[torch.Tensor],
          partial: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
          name: str, tables: Optional[torch.Tensor] = None) -> None:
    """Launch ``flash_rows``: contiguous K/V (B, S, Hkv, D), or with
    ``tables`` the pool (P, ps, Hkv, D) read at S = n_blocks·ps."""
    B, Q, Hq, D = q4.shape
    if tables is None:
        _, S, Hkv, _ = k.shape
        ps, k_sb, v_sb, tbl_sb = 0, k.stride(0), v.stride(0), 0
    else:
        _, ps, Hkv, _ = k.shape
        S, k_sb, v_sb, tbl_sb = tables.shape[1] * ps, 0, 0, tables.stride(0)
    m, l, acc = partial if partial is not None else (None, None, None)
    rc = _lib().flash_rows(
        _DTYPES[q4.dtype], D, q4.data_ptr(), k.data_ptr(), v.data_ptr(),
        tables.data_ptr() if tables is not None else None, lens.data_ptr(),
        out.data_ptr() if out is not None else None,
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None,
        acc.data_ptr() if acc is not None else None,
        B, Q, Hq, Hkv, S, splits, add, ps,
        q4.stride(0), q4.stride(1), k_sb, v_sb, tbl_sb, 1.0 / math.sqrt(D), _stream(q4),
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
    _check_q_staging(q)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _rows(q, k_cache, v_cache, cache_lens, add=1, splits=1, out=out, partial=None,
          name="mixed_attention")
    return out


def decode_attention_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                                block_tables: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Single-stage paged flash decoding: q (B, Hq, D) vs the pool through
    (B, n_blocks) tables."""
    _check_paged(q, k_pages, v_pages, block_tables, lengths)
    B, Hq, D = q.shape
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    _rows(q.unsqueeze(1), k_pages, v_pages, lengths, add=0, splits=1, out=out, partial=None,
          name="decode_attention_paged", tables=block_tables)
    return out[:, 0]


def paged_splitk_partial_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                              block_tables: torch.Tensor, lengths: torch.Tensor, *,
                              k_splits: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1 of paged split-K decoding: chunk ``kc`` walks table columns
    [kc·nb/K, (kc+1)·nb/K).  Emits the contiguous partial layout m, l
    (B, Hkv, K, G), acc (B, Hkv, K, G, D) fp32, for ``splitk_combine_cuda``."""
    _check_paged(q, k_pages, v_pages, block_tables, lengths)
    B, nb = block_tables.shape
    Hkv, D = k_pages.shape[2], k_pages.shape[3]
    G = q.shape[1] // Hkv
    if k_splits < 1 or nb % k_splits:
        raise ValueError(f"{nb} blocks not divisible by k_splits={k_splits}")
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hkv, k_splits, G), **f32)
    l = torch.empty((B, Hkv, k_splits, G), **f32)
    acc = torch.empty((B, Hkv, k_splits, G, D), **f32)
    _rows(q.unsqueeze(1), k_pages, v_pages, lengths, add=0, splits=k_splits, out=None,
          partial=(m, l, acc), name="decode_attention_paged_splitk_partial", tables=block_tables)
    return m, l, acc


def decode_attention_paged_splitk_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                                       lengths: torch.Tensor, *, k_splits: int) -> torch.Tensor:
    """Two-stage paged split-K flash decoding (paged partial, shared combine)."""
    m, l, acc = paged_splitk_partial_cuda(q, k_pages, v_pages, block_tables, lengths,
                                          k_splits=k_splits)
    return splitk_combine_cuda(m, l, acc, q.dtype)


def mixed_attention_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                               block_tables: torch.Tensor, cache_lens: torch.Tensor) -> torch.Tensor:
    """Paged q-chunk attention: q (B, Q, Hq, D); row i sees keys <=
    cache_lens[b] + i among the first n_blocks·ps of its table."""
    _check_paged(q, k_pages, v_pages, block_tables, cache_lens)
    _check_q_staging(q)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _rows(q, k_pages, v_pages, cache_lens, add=1, splits=1, out=out, partial=None,
          name="mixed_attention_paged", tables=block_tables)
    return out
