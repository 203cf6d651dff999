"""Wrappers of the CUDA flash-decoding kernels (``csrc/decode_attention.cu``).

Each wrapper checks device, dtype, shape and strides, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its entry
of ``LAUNCHES``:

* ``decode_attention_cuda`` — replaces ``decode_attention_pallas``: one
  launch whose keys are split over a thread-block cluster of
  ``cluster_split`` CTAs per (sequence, kv head), merged in the cluster's
  shared memory (bf16 on the tensor cores through ``cluster_mma_kernel``,
  fp32 on the CUDA cores through ``cluster_f32_kernel``; groups of more
  than 16 heads per kv head through ``flash_rows_kernel``);
* ``decode_attention_splitk_cuda`` — replaces both stages of
  ``decode_attention_splitk`` (the partial and the combine) with one
  launch: every CTA stores its chunk's state to a workspace, and the last
  CTA of each (sequence, kv head) to finish merges the chunk states (bf16
  with up to 16 heads per kv head on the tensor cores through
  ``splitk_mma_kernel``; fp32 and wider groups through
  ``flash_rows_kernel``, a counter per row block);
* ``splitk_partial_cuda`` — the chunk states alone (the same kernels
  without the merge), so that they can be held against the plain partial;
* ``mixed_attention_cuda`` — replaces ``mixed_attention_pallas`` (bf16 on
  the tensor cores through ``mixed_mma_kernel``; fp32 on the CUDA cores
  through ``cluster_mixed_f32_kernel``: blocks of 16 (query, head) rows
  whose keys are split over a thread-block cluster of ``mixed_cluster``
  CTAs, merged in the cluster's shared memory; groups of more than 16
  heads per kv head through ``flash_rows_kernel``);
* ``decode_attention_paged_cuda`` — replaces ``decode_attention_paged`` (as
  ``decode_attention_cuda``, through the block tables);
* ``decode_attention_paged_splitk_cuda`` / ``paged_splitk_partial_cuda`` —
  replaces ``decode_attention_paged_splitk`` (as the two above, through the
  block tables);
* ``mixed_attention_paged_cuda`` — replaces ``mixed_attention_paged`` (as
  ``mixed_attention_cuda``, through the block tables).

The paged wrappers take the (P, page_size, Hkv, D) pool, (B, n_blocks)
int32 block tables (a row stride is allowed, so a column slice
``tables[:, :w]`` is read in place) and (B,) int32 lengths.  The bf16
mixed step copies q's rows with 16-byte cp.async, so its q must be 16-byte
aligned with 16-byte batch and sequence strides; the split-K partial loads
q with plain loads, so any view with dense (Hq, D) works there (the decode
step's ``q[:, 0]``), as it does for the single-stage decode and the fp32
mixed step.

The split-K decode counts its chunks in on an int32 buffer of the
wrapper's (``split_counters``), one per (device, stream): zeroed when it
is made, grown (a new zeroed buffer) when a launch needs more entries,
never touched by the host otherwise, since the kernel leaves every count
at 0.  A launch that fails drops it, so the next call starts from zeros.
A CUDA graph keeps the address of the buffer its capture launched with,
so the buffer must exist, large enough, before the capture: the engine
runs each step once on the capture stream first.  Made or grown under a
capture it would live in the graph's memory, so ``split_counters``
raises there; a buffer replaced by a larger one is kept alive for the
graphs that hold it.

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

# the single-stage decode's cluster split (csrc: kClusterKeys, cluster_chunk)
CLUSTER_KEYS = 128     # a CTA's chunk is whole tiles of this many keys
CLUSTER_MAX = 8        # the portable cluster size
CLUSTER_SMS = 132      # SMs of an H100 SXM
# CTAs of the single-stage decode kernel one SM holds at once, by dtype and
# head dim (their dynamic shared memory decides it; chip_smoke.py phase 2
# holds this table to cudaOccupancyMaxActiveClusters at C = 1 over 132 SMs)
CLUSTER_CTAS_PER_SM = {
    torch.bfloat16: {32: 4, 64: 2, 80: 2, 128: 1},
    torch.float32: {32: 2, 64: 2, 80: 3, 128: 2},
}


def cluster_split(S: int, bh: int, per_sm: int) -> int:
    """CTAs per (sequence, kv head) of the single-stage decode over a cache
    of S keys with ``bh`` = B·Hkv (sequence, kv head) pairs, when an SM
    holds ``per_sm`` of its CTAs (``CLUSTER_CTAS_PER_SM``): the largest
    power of two C <= 8 with C·bh <= 132·per_sm CTAs (one wave) and no
    more CTAs than the cache has 128-key tiles, at least 1.  From the
    shapes alone, never the lengths (they live on the card)."""
    tiles = -(-S // CLUSTER_KEYS)
    C = 1
    while 2 * C <= min(CLUSTER_MAX, tiles) and 2 * C * bh <= CLUSTER_SMS * per_sm:
        C *= 2
    return C


# CTAs of the fp32 mixed step's cluster kernel one SM holds at once, by
# head dim (its dynamic shared memory decides it; chip_smoke.py phase 2
# holds this table to cudaOccupancyMaxActiveClusters at C = 1 over 132 SMs)
MIXED_CTAS_PER_SM = {torch.float32: {32: 2, 64: 1, 80: 1, 128: 1}}
MIXED_ROWS = 16        # (query, head) rows per CTA of cluster_mixed_f32_kernel


def mixed_blocks(Q: int, G: int) -> int:
    """16-row blocks of the fp32 mixed step per (sequence, kv head)."""
    return -(-Q * G // MIXED_ROWS)


def mixed_rows(Q: int, G: int, n: int) -> list:
    """(chunk query, head within the kv head's group) of each row of block
    ``n``: row r is query (16n + r) // G, head (16n + r) % G (the TPU's
    ``_regroup_q_chunk`` order), up to the Q·G rows there are."""
    return [divmod(i, G) for i in range(n * MIXED_ROWS, min((n + 1) * MIXED_ROWS, Q * G))]


def mixed_cluster(S: int, B: int, Hkv: int, Q: int, G: int, D: int) -> int:
    """CTAs per (sequence, kv head, 16-row block) of the fp32 mixed step
    over a window of S keys: ``cluster_split`` over B·Hkv·``mixed_blocks``
    blocks with ``MIXED_CTAS_PER_SM`` of them an SM, from the shapes alone."""
    return cluster_split(S, B * Hkv * mixed_blocks(Q, G), MIXED_CTAS_PER_SM[torch.float32][D])


def cluster_chunks(S: int, C: int) -> list:
    """Keys [lo, end) of each CTA of a cluster of C, in rank order: the S
    keys' 128-key tiles dealt out in order, CTA c from tile floor(c·tiles/C)."""
    tiles = -(-S // CLUSTER_KEYS)
    return [(c * tiles // C * CLUSTER_KEYS, min((c + 1) * tiles // C * CLUSTER_KEYS, S))
            for c in range(C)]

# launches per kernel, counted where each wrapper launches and nowhere else
LAUNCHES = {
    "decode_attention": 0,
    "decode_attention_splitk": 0,
    "decode_attention_splitk_partial": 0,
    "mixed_attention": 0,
    "decode_attention_paged": 0,
    "decode_attention_paged_splitk": 0,
    "decode_attention_paged_splitk_partial": 0,
    "mixed_attention_paged": 0,
}

ROWS_PER_CTA = 8       # flash_rows_kernel's query rows per CTA (csrc: kRows)
# the split-K decode's arrival counters by (device index, stream), and the
# buffers a larger one replaced (a captured graph may still launch on them)
_COUNTERS: dict = {}
_RETIRED: list = []


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
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _F, _I, _P,
    ]
    lib.flash_rows.restype = _I
    lib.decode_cluster_occupancy.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.decode_cluster_occupancy.restype = _I
    lib.mixed_cluster_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.mixed_cluster_occupancy.restype = _I
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


def _counter_key(t: torch.Tensor) -> tuple:
    return t.device.index, _stream(t)


def split_counters(t: torch.Tensor, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters of the split-K decode for the
    current stream of ``t``'s device, all 0: made zeroed on first use and
    kept; replaced by a larger zeroed buffer when ``n`` outgrows it.  Under
    a CUDA graph capture it must already be there: raises otherwise."""
    key = _counter_key(t)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"split-K counters for {n} entries do not exist on the capturing stream: "
                "run the step once on that stream before capturing it")
        if buf is not None:
            _RETIRED.append(buf)
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=t.device)
    return buf


def _split_state(q: torch.Tensor, Hkv: int, k_splits: int, D: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """m, l (B, Hkv, K, G) and acc (B, Hkv, K, G, D) fp32, views of one
    ``torch.empty`` (acc first: the kernels store it as 16-byte vectors)."""
    B, G = q.shape[0], q.shape[1] // Hkv
    n = B * Hkv * k_splits * G
    buf = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    return (buf[n * D:n * (D + 1)].view(B, Hkv, k_splits, G),
            buf[n * (D + 1):].view(B, Hkv, k_splits, G),
            buf[:n * D].view(B, Hkv, k_splits, G, D))


def _rows(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
          *, add: int, splits: int, out: Optional[torch.Tensor],
          partial: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
          name: str, tables: Optional[torch.Tensor] = None, cluster: int = 1,
          counters: Optional[torch.Tensor] = None) -> None:
    """Launch ``flash_rows``: contiguous K/V (B, S, Hkv, D), or with
    ``tables`` the pool (P, ps, Hkv, D) read at S = n_blocks·ps; ``cluster``
    is the single-stage decode's CTAs per (sequence, kv head); with
    ``counters`` the split-K chunk states in ``partial`` are merged into
    ``out`` in the same launch."""
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
        counters.data_ptr() if counters is not None else None,
        B, Q, Hq, Hkv, S, splits, add, ps,
        q4.stride(0), q4.stride(1), k_sb, v_sb, tbl_sb, 1.0 / math.sqrt(D), cluster,
        _stream(q4),
    )
    if rc != 0 and counters is not None:
        # counts a failed launch may have left: the next call starts from zeros
        _COUNTERS.pop(_counter_key(q4), None)
    _check_launch(rc, name)
    LAUNCHES[name] += 1


def _cluster(cluster: Optional[int], chosen: int) -> int:
    """``cluster`` where the caller forces one (1, 2, 4 or 8), else the
    chooser's ``chosen``."""
    if cluster is None:
        return chosen
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"cluster must be 1, 2, 4 or 8: {cluster}")
    return cluster


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          lengths: torch.Tensor, *, cluster: Optional[int] = None
                          ) -> torch.Tensor:
    """Single-stage flash decoding: q (B, Hq, D) vs K/V (B, S, Hkv, D), in
    clusters of ``cluster`` CTAs per (sequence, kv head) (``cluster_split``'s
    by default)."""
    _check_kv(q, k_cache, v_cache, lengths)
    B, S, Hkv, _ = k_cache.shape
    Hq, D = q.shape[1:]
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    _rows(q.unsqueeze(1), k_cache, v_cache, lengths, add=0, splits=1, out=out, partial=None,
          name="decode_attention",
          cluster=_cluster(cluster, cluster_split(S, B * Hkv, CLUSTER_CTAS_PER_SM[q.dtype][D])))
    return out[:, 0]


def cluster_occupancy(dtype: torch.dtype, D: int, G: int, C: int) -> Tuple[int, int]:
    """The single-stage decode kernel of (dtype, head dim D, G heads per kv
    head) in clusters of C CTAs: how many clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``), and a CTA's dynamic shared memory
    in bytes."""
    out = (_I * 2)()
    _check_launch(_lib().decode_cluster_occupancy(_DTYPES[dtype], D, G, C, out),
                  "decode_cluster_occupancy")
    return out[0], out[1]


def mixed_occupancy(D: int, C: int) -> Tuple[int, int]:
    """As ``cluster_occupancy``, for the fp32 mixed step's cluster kernel at
    head dim D: clusters of C CTAs resident at once, and a CTA's dynamic
    shared memory in bytes."""
    out = (_I * 2)()
    _check_launch(_lib().mixed_cluster_occupancy(D, C, out), "mixed_cluster_occupancy")
    return out[0], out[1]


def _split_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                k_splits: int, name: str, *, merge: bool,
                tables: Optional[torch.Tensor] = None):
    """The split-K launch over K/V (or the pool through ``tables``): with
    ``merge`` the (B, Hq, D) output of the one fused launch, else the chunk
    states m, l (B, Hkv, K, G), acc (B, Hkv, K, G, D) fp32."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    state = _split_state(q, Hkv, k_splits, D)
    if not merge:
        _rows(q.unsqueeze(1), k, v, lens, add=0, splits=k_splits, out=None, partial=state,
              name=name, tables=tables)
        return state
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    counters = split_counters(q, B * Hkv * -(-(Hq // Hkv) // ROWS_PER_CTA))
    _rows(q.unsqueeze(1), k, v, lens, add=0, splits=k_splits, out=out, partial=state,
          name=name, tables=tables, counters=counters)
    return out[:, 0]


def _check_splits(n: int, k_splits: int, what: str) -> None:
    if k_splits < 1 or n % k_splits:
        raise ValueError(f"{what} {n} not divisible by k_splits={k_splits}")


def splitk_partial_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        lengths: torch.Tensor, *, k_splits: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split-K chunk states alone: m, l (B, Hkv, K, G), acc (B, Hkv, K,
    G, D) fp32 (what ``decode_attention_splitk_cuda`` merges in its launch)."""
    _check_kv(q, k_cache, v_cache, lengths)
    _check_splits(k_cache.shape[1], k_splits, "cache length")
    return _split_rows(q, k_cache, v_cache, lengths, k_splits,
                       "decode_attention_splitk_partial", merge=False)


def decode_attention_splitk_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                                 k_splits: int) -> torch.Tensor:
    """Split-K flash decoding in one launch: K chunks of S / K keys per
    (sequence, kv head), merged by the last CTA of each to finish."""
    _check_kv(q, k_cache, v_cache, lengths)
    _check_splits(k_cache.shape[1], k_splits, "cache length")
    return _split_rows(q, k_cache, v_cache, lengths, k_splits, "decode_attention_splitk",
                       merge=True)


def _mixed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache_lens: torch.Tensor,
           name: str, tables: Optional[torch.Tensor] = None,
           cluster: Optional[int] = None) -> torch.Tensor:
    """The mixed-step launch over K/V (or the pool through ``tables``); the
    fp32 kernel in clusters of ``cluster`` CTAs (``mixed_cluster``'s by
    default; bf16 takes none)."""
    _check_q_staging(q)
    B, Q, Hq, D = q.shape
    Hkv = k.shape[2]
    S = k.shape[1] if tables is None else tables.shape[1] * k.shape[1]
    C = 1
    if q.dtype == torch.float32:
        C = _cluster(cluster, mixed_cluster(S, B, Hkv, Q, Hq // Hkv, D))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _rows(q, k, v, cache_lens, add=1, splits=1, out=out, partial=None, name=name,
          tables=tables, cluster=C)
    return out


def mixed_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         cache_lens: torch.Tensor) -> torch.Tensor:
    """q-chunk attention: q (B, Q, Hq, D); row i sees keys <= cache_lens[b] + i."""
    _check_kv(q, k_cache, v_cache, cache_lens)
    return _mixed(q, k_cache, v_cache, cache_lens, "mixed_attention")


def decode_attention_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                                block_tables: torch.Tensor, lengths: torch.Tensor, *,
                                cluster: Optional[int] = None) -> torch.Tensor:
    """Single-stage paged flash decoding: q (B, Hq, D) vs the pool through
    (B, n_blocks) tables, as ``decode_attention_cuda`` at S = n_blocks·ps."""
    _check_paged(q, k_pages, v_pages, block_tables, lengths)
    B, Hq, D = q.shape
    S = block_tables.shape[1] * k_pages.shape[1]
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    _rows(q.unsqueeze(1), k_pages, v_pages, lengths, add=0, splits=1, out=out, partial=None,
          name="decode_attention_paged", tables=block_tables,
          cluster=_cluster(cluster, cluster_split(S, B * k_pages.shape[2],
                                                  CLUSTER_CTAS_PER_SM[q.dtype][D])))
    return out[:, 0]


def paged_splitk_partial_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                              block_tables: torch.Tensor, lengths: torch.Tensor, *,
                              k_splits: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paged split-K chunk states alone: chunk ``kc`` walks table
    columns [kc·nb/K, (kc+1)·nb/K); the contiguous layout m, l (B, Hkv, K,
    G), acc (B, Hkv, K, G, D) fp32."""
    _check_paged(q, k_pages, v_pages, block_tables, lengths)
    _check_splits(block_tables.shape[1], k_splits, "n_blocks")
    return _split_rows(q, k_pages, v_pages, lengths, k_splits,
                       "decode_attention_paged_splitk_partial", merge=False,
                       tables=block_tables)


def decode_attention_paged_splitk_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                                       lengths: torch.Tensor, *, k_splits: int) -> torch.Tensor:
    """Paged split-K flash decoding in one launch (as
    ``decode_attention_splitk_cuda``, through the block tables)."""
    _check_paged(q, k_pages, v_pages, block_tables, lengths)
    _check_splits(block_tables.shape[1], k_splits, "n_blocks")
    return _split_rows(q, k_pages, v_pages, lengths, k_splits,
                       "decode_attention_paged_splitk", merge=True, tables=block_tables)


def mixed_attention_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                               block_tables: torch.Tensor, cache_lens: torch.Tensor) -> torch.Tensor:
    """Paged q-chunk attention: q (B, Q, Hq, D); row i sees keys <=
    cache_lens[b] + i among the first n_blocks·ps of its table."""
    _check_paged(q, k_pages, v_pages, block_tables, cache_lens)
    return _mixed(q, k_pages, v_pages, cache_lens, "mixed_attention_paged", block_tables)
