"""Full attention block of the serving path: fused qkv, qk-norm, RoPE, GQA
over a whole prompt (prefill), against a contiguous KV cache or a shared
page pool.

Counterpart of the JAX package's ``models/attention.py``, full attention
and the sliding window.  The cache is a per-layer (B, S_max, Hkv, Dh)
pair, or with a block table the per-layer page pool (P, page_size, Hkv,
Dh), updated IN PLACE — where the JAX engine donated the buffer to its
jitted step, the port writes into it.  With a sliding window W the
contiguous cache is a ring of ``min(max_len, W)`` rows: position p lives
at row p % W, a decode step writes there and attends to the ``min(len +
1, W)`` rows the ring holds (the ring bounds the window, so the decode
kernels take no window argument); the prefill passes W to the flash
kernel.  The paged pool and the mixed step take no window, as in JAX.

Where the JAX package differs: its prefill keeps the last W keys at ring
rows 0..W-1 and its engine places them at offset 0, so for a prompt of S
>= W tokens with S % W != 0 its decode overwrites a key still inside the
window.  Here position p is at row p % W from the prefill on
(``ring_rows``): the same rows, rolled, and equal to the JAX placement
whenever S < W or S % W == 0.

On a CUDA tensor the attention itself always runs the hand-written
kernels (``kernels.flash_attention.ops`` for a prefill,
``kernels.decode_attention.ops`` for the rest); on a CPU tensor their
plain versions.  There is no ``use_pallas``-style switch: where the JAX
qwen3 config computes its prefill with ``layers.chunked_attention``, the
port runs the flash kernel, which computes the same function.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, Hkv, Dh), or a pool (P, ps, Hkv, Dh)
    v: torch.Tensor


class Attention(nn.Module):
    """One layer's attention weights, with q/k/v fused at load time:
    ``wqkv`` = [wq | wk | wv] (d, q_dim + 2·kv_dim); ``qk_norm`` is the
    (Hq + Hkv, Dh) per-head norm weight [q_norm × Hq ; k_norm × Hkv]."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        hd = cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype)
        self.wqkv = nn.Parameter(torch.empty(cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim, **kw),
                                 requires_grad=False)
        self.wo = nn.Parameter(torch.empty(cfg.q_dim, cfg.d_model, **kw), requires_grad=False)
        self.qk_norm = (nn.Parameter(torch.ones(cfg.n_heads + cfg.n_kv_heads, hd, **kw),
                                     requires_grad=False)
                        if cfg.qk_norm else None)


def fuse_qkv_weights(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """[wq | wk | wv] as one (d, q_dim + 2·kv_dim) matrix."""
    return torch.cat([wq, wk, wv], dim=-1)


def fuse_qk_norm(q_norm: torch.Tensor, k_norm: torch.Tensor, n_heads: int,
                 n_kv_heads: int) -> torch.Tensor:
    """The (Hq + Hkv, Dh) norm weight of the concatenated q/k head axis."""
    return torch.cat([q_norm.expand(n_heads, -1), k_norm.expand(n_kv_heads, -1)])


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused projection: ONE matmul, then one norm+rope pass over the
    concatenated (Hq + Hkv) head axis.  Returns q (B,S,Hq,Dh), k, v
    (B,S,Hkv,Dh); q and k are views of one buffer."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    qkv = x @ p.wqkv
    q, k, v = qkv.split([cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    qk = torch.cat([q.reshape(B, S, Hq, hd), k.reshape(B, S, Hkv, hd)], dim=2)
    if cfg.qk_norm:
        qk = layers.rms_norm(qk, p.qk_norm, cfg.norm_eps)
    qk = layers.apply_rope(qk, positions, cfg.rope_theta)
    return qk[:, :, :Hq], qk[:, :, Hq:], v.reshape(B, S, Hkv, hd)


def attention_block(p: Attention, x: torch.Tensor,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Prefill attention over a whole (B, S, d) prompt at positions
    ``arange(S)``: causal GQA at Hkv width (KV is never repeated to Hq).
    Returns the output (B, S, d) and the prompt's ``KVCache`` (B, S, Hkv,
    Dh) — views into the projection's buffers."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = flash_ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    return out.reshape(B, S, cfg.q_dim) @ p.wo, KVCache(k, v)


def ring_rows(kv: torch.Tensor, window: int) -> torch.Tensor:
    """A prompt's (B, S, Hkv, Dh) keys or values as a decode cache holds
    them: all S rows at full attention or when S <= W; else the last W
    positions, position p at row p % W (a roll of JAX's last-W slice by S
    % W rows)."""
    S = kv.shape[1]
    if window <= 0 or S <= window:
        return kv
    return torch.roll(kv[:, S - window:], shifts=S % window, dims=1)


def attention_decode(
    p: Attention,
    x: torch.Tensor,            # (B, 1, d) — one new token per slot
    cache: KVCache,             # (B, S, Hkv, Dh) or a pool, written in place
    cache_len: torch.Tensor,    # (B,) int32 per-slot lengths, on x's device
    cfg: ModelConfig,
    *,
    page_table: Optional[torch.Tensor] = None,   # (B, nb) int32 => paged pool
    write_plan: Optional[tuple] = None,          # paged_decode_plan, with page_table
) -> torch.Tensor:
    """One decode step: write the new token's KV at ``cache_len[b]``
    (clamped to the last row, as ``dynamic_update_slice`` clamps), then
    attend to the first ``cache_len[b] + 1`` positions.  With a sliding
    window the cache is the ring: the write goes to row ``cache_len[b] %
    S`` and attention reads the ``min(cache_len[b] + 1, S)`` rows held.
    A paged step (``page_table``) needs ``write_plan``, made once a step."""
    if cache_len.dim() != 1:
        raise ValueError("decode requires (B,) per-slot cache lengths")
    if page_table is not None:
        if write_plan is None:
            raise ValueError("a paged decode step needs paged_decode_plan's write_plan")
        return _attention_decode_paged(p, x, cache, cache_len, cfg, page_table, write_plan)
    B = x.shape[0]
    S = cache.k.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, cache_len[:, None])
    rows = torch.arange(B, device=x.device)
    if cfg.sliding_window > 0:
        write_at, eff_len = (cache_len % S).long(), torch.clamp(cache_len + 1, max=S)
    else:
        write_at, eff_len = cache_len.clamp(max=S - 1).long(), cache_len + 1
    cache.k[rows, write_at] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, write_at] = v_new[:, 0].to(cache.v.dtype)
    out = ops.decode_attention(q[:, 0], cache.k, cache.v, eff_len)
    return (out.reshape(B, cfg.q_dim) @ p.wo)[:, None, :]


def _attention_decode_paged(
    p: Attention,
    x: torch.Tensor,            # (B, 1, d)
    pool: KVCache,              # (P, ps, Hkv, Dh), written in place
    cache_len: torch.Tensor,    # (B,) int32
    cfg: ModelConfig,
    page_table: torch.Tensor,   # (B, nb) int32, on x's device
    write_plan: tuple,          # paged_decode_plan's (page, row, src)
) -> torch.Tensor:
    """Paged decode step: the new token's KV goes to row ``len % ps`` of
    page ``table[b, len // ps]`` (``write_plan``, made once a step), then
    attention reads through the table.  A sliding window raises
    ``ValueError``, as in JAX."""
    if cfg.sliding_window > 0:
        raise ValueError("paged KV does not support sliding-window attention")
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg, cache_len[:, None])
    page, row, src = write_plan
    k_new, v_new = k_new[:, 0], v_new[:, 0]
    if src is not None:
        k_new, v_new = k_new.index_select(0, src), v_new.index_select(0, src)
    # Idle slots' tables are all TRASH_PAGE, so their writes all land on
    # page 0 at once.  index_put_ with repeated indices is nondeterministic;
    # that is harmless to a dense model, whose idle slots' outputs are
    # dropped.  An MoE model's idle slots compete for expert capacity, so
    # its plan (``dedupe``) gives colliding rows one value.
    pool.k[page, row] = k_new.to(pool.k.dtype)
    pool.v[page, row] = v_new.to(pool.v.dtype)
    out = ops.decode_attention(q[:, 0], pool.k, pool.v, cache_len + 1, page_table=page_table)
    return (out.reshape(B, cfg.q_dim) @ p.wo)[:, None, :]


# the reserved page every padding row of a paged mixed step writes to
# (``serving.paged_kv.TRASH_PAGE``); nothing reads it
TRASH_PAGE = 0


def mixed_write_plan(cache_lens: torch.Tensor, new_lens: torch.Tensor, Q: int,
                     S: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where a mixed step's chunk rows land in a contiguous (B, S) cache,
    computed on the device from the (B,) lengths, at a fixed shape.  Slot
    ``b`` rewrites the Q-row window [w_b, w_b + Q), w_b = min(cache_lens[b],
    S - Q): position p takes chunk row p - cache_lens[b] where that is in
    [0, new_lens[b]) (the JAX positional select), else its old row, bit for
    bit.  Every row a slot writes lies in its window, and the windows'
    rows are distinct, so one ``index_copy_`` stays deterministic.  Returns
    (dst, src, take) over the B·Q window rows: flat cache row, flat chunk
    row, and whether the chunk row is taken."""
    if Q > S:
        raise ValueError(f"a mixed step of {Q} rows needs a cache of at least {Q} rows, not {S}")
    dev = cache_lens.device
    B = cache_lens.shape[0]
    cl, nl = cache_lens.long()[:, None], new_lens.long()[:, None]
    b = torch.arange(B, device=dev)[:, None]
    pos = cl.clamp(max=S - Q) + torch.arange(Q, device=dev)[None, :]
    off = pos - cl
    take = (off >= 0) & (off < nl)
    return ((b * S + pos).reshape(-1), (b * Q + off.clamp(0, Q - 1)).reshape(-1),
            take.reshape(-1))


def last_writer(trash: torch.Tensor, row: torch.Tensor, ps: int) -> torch.Tensor:
    """For N rows written in order, where those flagged ``trash`` land on
    row ``row`` of the trash page (and collide) and the others each on a
    row of their own: the index of the row whose value each row should
    write -- itself, or for a trash row the last row writing the same trash
    row -- so that colliding writes carry one value, which is what a
    sequential write leaves, in any order.  Static shapes; ``amax`` is
    order-free, so the result is deterministic on the card too."""
    n = row.shape[0]
    idx = torch.arange(n, device=row.device)
    key = torch.where(trash, row, ps)
    last = torch.full((ps + 1,), -1, dtype=torch.long, device=row.device).scatter_reduce_(
        0, key, idx, "amax")
    return torch.where(trash, last[row], idx)


def paged_decode_plan(cache_len: torch.Tensor, page_table: torch.Tensor, ps: int, *,
                      dedupe: bool = False) -> Tuple[torch.Tensor, torch.Tensor,
                                                      Optional[torch.Tensor]]:
    """Where a paged decode step writes, made once for every layer: slot b's
    new row goes to row ``len % ps`` of page ``table[b, len // ps]``.
    Returns (page, row, src); with ``dedupe`` ``src`` is ``last_writer``'s
    map (idle slots collide on the trash page), else None."""
    page = page_table.gather(1, (cache_len // ps)[:, None].long())[:, 0].long()
    row = (cache_len % ps).long()
    src = last_writer(page == TRASH_PAGE, row, ps) if dedupe else None
    return page, row, src


def paged_write_plan(cache_lens: torch.Tensor, new_lens: torch.Tensor, Q: int,
                     tables: torch.Tensor, ps: int, *, dedupe: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor], None]:
    """``mixed_write_plan`` through (B, nb) block tables, on the device:
    chunk row ``i`` of slot ``b`` writes position t = cache_lens[b] + i at
    flat pool row tables[b, t // ps]·ps + t % ps when i < new_lens[b] and
    t < nb·ps; every other row goes to its row of the trash page, as in
    JAX.  Only the trash page takes repeated writes (after copy-on-write
    every page a slot writes is its own); a dense model's padding rows read
    it and are dropped.  An MoE model's padding rows compete for expert
    capacity, so with ``dedupe`` the colliding rows write one value, the
    last one's (``last_writer``), and the trash page is the same on every
    device.  Returns (dst, src, None): every chunk row is written, in
    order, row ``src[j]``'s value at ``dst[j]`` (src None: its own)."""
    dev = cache_lens.device
    nb = tables.shape[1]
    pos = cache_lens.long()[:, None] + torch.arange(Q, device=dev)[None, :]
    valid = ((torch.arange(Q, device=dev)[None, :] < new_lens.long()[:, None])
             & (pos < nb * ps))
    page = tables.long().gather(1, (pos // ps).clamp(max=nb - 1))
    page = torch.where(valid, page, TRASH_PAGE).reshape(-1)
    row = (pos % ps).reshape(-1)
    src = last_writer(page == TRASH_PAGE, row, ps) if dedupe else None
    return page * ps + row, src, None


def mixed_write_index(cache_lens: np.ndarray, new_lens: np.ndarray, Q: int,
                      S: int) -> Tuple[np.ndarray, np.ndarray]:
    """The host form of ``mixed_write_plan``, the plain version the tests
    hold it to: chunk row ``i`` of slot ``b`` lands at position
    ``cache_lens[b] + i`` iff ``i < new_lens[b]`` and the position exists.
    Returns (src, dst): flat indices into the (B·Q) chunk rows and the
    (B·S) cache rows of the rows that land."""
    cache_lens = np.asarray(cache_lens, np.int64)
    new_lens = np.asarray(new_lens, np.int64)
    i = np.arange(Q)[None, :]
    pos = cache_lens[:, None] + i
    keep = (i < new_lens[:, None]) & (pos < S)
    b, col = np.nonzero(keep)
    return b * Q + col, b * S + pos[b, col]


def paged_write_index(cache_lens: np.ndarray, new_lens: np.ndarray, Q: int,
                      tables: np.ndarray, ps: int) -> Tuple[np.ndarray, np.ndarray]:
    """The host form of ``paged_write_plan`` without its trash-page rows:
    chunk row ``i`` of slot ``b`` lands at flat pool row ``tables[b, t //
    ps]·ps + t % ps`` of the (P·ps) rows, t = ``cache_lens[b] + i``, iff
    ``i < new_lens[b]`` and t < nb·ps."""
    cache_lens = np.asarray(cache_lens, np.int64)
    new_lens = np.asarray(new_lens, np.int64)
    tables = np.asarray(tables, np.int64)
    i = np.arange(Q)[None, :]
    pos = cache_lens[:, None] + i
    keep = (i < new_lens[:, None]) & (pos < tables.shape[1] * ps)
    b, col = np.nonzero(keep)
    t = pos[b, col]
    return b * Q + col, tables[b, t // ps] * ps + t % ps


def write_rows(buf: torch.Tensor, new: torch.Tensor, plan) -> None:
    """Write a mixed step's (B, Q, Hkv, Dh) ``new`` rows into one layer's
    cache or pool ``buf`` in place, by a ``mixed_write_plan`` or
    ``paged_write_plan``: one ``index_copy_`` of B·Q rows."""
    dst, src, take = plan
    flat = buf.view(-1, *buf.shape[2:])
    rows = new.reshape(-1, *new.shape[2:]).to(buf.dtype)
    if src is not None:
        rows = rows.index_select(0, src)
    if take is not None:
        rows = torch.where(take[:, None, None], rows, flat.index_select(0, dst))
    flat.index_copy_(0, dst, rows)


def attention_mixed(
    p: Attention,
    x: torch.Tensor,               # (B, Q, d) — Q new tokens per slot
    cache: KVCache,                # (B, S, Hkv, Dh) or a pool, written in place
    cache_lens: torch.Tensor,      # (B,) int32 tokens already cached, on x's device
    cfg: ModelConfig,
    write_plan,                    # mixed_write_plan / paged_write_plan, on x's device
    *,
    attn_window: Optional[int] = None,
    page_table: Optional[torch.Tensor] = None,        # (B, nb) int32 => paged pool
) -> torch.Tensor:
    """One mixed-batch step: every slot advances by its own ragged suffix.
    The chunk's KV goes in by ``write_plan`` (only rows ``i < new_lens[b]``
    land where a slot's content lives); query ``i`` attends to every
    position ``<= cache_lens[b] + i``.  ``attn_window`` bounds the span
    read: the kernel takes the ``[:, :W]`` view of a contiguous cache, or
    the ``[:, :ceil(W / ps)]`` column slice of the tables, in place (no
    copy).  A sliding window raises ``ValueError``, as in JAX."""
    if cfg.sliding_window > 0:
        raise ValueError("the mixed-batch step does not support sliding-window attention")
    B, Q, _ = x.shape
    positions = cache_lens[:, None] + torch.arange(Q, device=x.device, dtype=cache_lens.dtype)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    write_rows(cache.k, k_new, write_plan)
    write_rows(cache.v, v_new, write_plan)
    if page_table is not None:
        ps = cache.k.shape[1]
        read_table = page_table if attn_window is None else page_table[:, :-(-attn_window // ps)]
        out = ops.mixed_attention(q, cache.k, cache.v, cache_lens, page_table=read_table)
    else:
        k_r, v_r = cache.k, cache.v
        if attn_window is not None:
            k_r, v_r = k_r[:, :attn_window], v_r[:, :attn_window]
        out = ops.mixed_attention(q, k_r, v_r, cache_lens)
    return out.reshape(B, Q, cfg.q_dim) @ p.wo


def empty_page_pool(cfg: ModelConfig, n_layers: int, num_pages: int, page_size: int, *,
                    device, dtype) -> KVCache:
    """The shared paged-KV pool of ``n_layers`` layers, zeroed:
    k and v (L, P, page_size, Hkv, Dh)."""
    shape = (n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, device=device, dtype=dtype),
                   v=torch.zeros(shape, device=device, dtype=dtype))

