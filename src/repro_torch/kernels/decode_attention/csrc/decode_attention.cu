// Flash-decoding attention kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of repro/kernels/decode_attention/kernel.py:
//   * decode_attention_pallas  (_decode_kernel)          -> flash_rows, Q=1, add=0, splits=1:
//                                                           one cluster launch (G <= 16):
//                                                           cluster_mma_kernel in bf16,
//                                                           cluster_f32_kernel in fp32;
//                                                           flash_rows_kernel otherwise
//   * decode_attention_splitk  (_splitk_partial_kernel   -> flash_rows, Q=1, add=0, splits=K,
//                               + _splitk_combine_kernel)   counters: one launch, the chunk states
//                                                           merged by the last CTA to finish
//                                                           (count_in_and_merge):
//                                                           splitk_mma_kernel in bf16 (G <= 16),
//                                                           flash_rows_kernel otherwise; without
//                                                           counters the partial states alone
//   * mixed_attention_pallas   (_mixed_kernel)           -> flash_rows, add=1, splits=1:
//                                                           mixed_mma_kernel in bf16,
//                                                           cluster_mixed_f32_kernel in fp32
//                                                           (G <= 16; flash_rows_kernel else)
//   * decode_attention_paged   (_paged_decode_kernel)    -> flash_rows, tbl, Q=1, add=0, splits=1:
//                                                           the same cluster kernels
//   * decode_attention_paged_splitk
//                              (_paged_splitk_partial_kernel -> flash_rows, tbl, Q=1, add=0,
//                               + the same combine)         splits=K, counters: as the contiguous
//                                                           split-K, through the block tables
//   * mixed_attention_paged    (_mixed_paged_kernel)     -> flash_rows, tbl, add=1, splits=1:
//                                                           the same kernels
//
// What bounds it: memory.  Every KV byte below a sequence's length is read
// once per (row block) and does 2 multiply-adds per element of math, far
// below the ~295 FLOP/byte where the H100 stops being bandwidth-bound.  At
// the main-path shape of qwen3-0.6b (B=8, Hkv=8, D=128, bf16) one decode
// step of one layer at length L reads 2*8*L*8*128*2 = 32768*L bytes of K
// and V: 134 MB at L=4096, so its least time is 40 us at 3.35 TB/s.
//
// Design.  The TPU grid walked KV tiles sequentially inside one core and
// carried the online-softmax state in VMEM scratch between grid steps.
// Here one CTA per (row block, kv head, batch x split) holds up to kRows
// query rows (the G heads of a GQA group, times the Q chunk queries of the
// mixed kernel) and loops over kTile-key tiles itself, keeping m and l in
// shared memory and the fp32 accumulator in registers.  The loop stops at
// the widest row's causal limit (length-skipped tiles cost nothing) and
// the ragged edge is masked per element, so no S % tile constraint exists.
// KV tiles arrive as 16-byte loads into registers, issued one tile ahead
// so they are in flight while the current tile is computed, then convert
// to fp32 in shared memory.  Small row blocks (8 rows) give the mixed step
// two CTAs per (b, kv head) at Q=8; the second reads KV mostly from L2.
// The KV operands are addressed through a batch stride, so an attention
// window view k[:, :W] of a larger cache is read in place.  This is
// fp32 CUDA-core math, far over a bytes bound; it serves the fp32 split-K
// partial, and groups of more than 16 heads per kv head.  The bf16 mixed
// step and the bf16 split-K partial run on the tensor cores
// (mixed_mma_kernel and splitk_mma_kernel, below), the single-stage decode
// in both dtypes and the fp32 mixed step on a thread-block cluster
// (cluster_mma_kernel, cluster_f32_kernel, cluster_mixed_f32_kernel, below).
//
// The split-K merge, in the partial's own launch.  The TPU runs split-K
// decoding as two pallas_calls: the chunk states, then a combine over them.
// Here the combine was its own launch too (splitk_combine_kernel, 0.0033
// ms a launch against a bytes bound of 0.00017 at phase 6's shape), with
// a second wrapper call on the host and the states' round trip through
// device memory.  Now each CTA of the split-K launch, once its chunk's
// state is stored, counts the chunk in (count_in_and_merge): the CTA that
// completes a (sequence, kv head)'s count (a row block's, in
// flash_rows_kernel) reads the chunk states back through L2, merges them
// in chunk order and writes the output.  A chunk wholly past the length
// would add exact zeros, so its CTA exits at once and the count waits for
// the live chunks only (live_chunks): a first version that counted every
// chunk, and had the merge wait on L2 once per chunk, took 0.0265 ms at
// phase 6's D = 128 shape against the pair's 0.0258.  A cluster of K CTAs
// (as the single-stage decode merges) does not suit this launch: at K = 8
// the split CTA's 145,664 bytes of shared memory leave 15 clusters
// resident on 132 SMs, and a chunk wholly past the length would hold its
// SM at cluster.sync() until its siblings finish.  The counters are an
// int32 buffer of the wrapper's, zeroed once per device and stream; each
// count wraps to 0 at the merge (atom.inc), so no launch needs a memset.
//
// Head dims 32, 64, 80 and 128.  At D = 80 (zamba2's shared attention) a
// bf16 tile is 320 16-byte packs for 128 threads, so each thread makes 3
// loads and the third is predicated off for half of them; the other dims
// split evenly and compile to the same code as without the predicate.
//
// Paged KV.  With a block table (tbl != nullptr) the KV operands are a
// shared pool (P, ps, Hkv, D) and key ``pos`` of sequence b lives at row
// pos % ps of page tbl[b * tbl_sb + pos / ps]; the logical length is
// S = nb * ps and there is no batch stride.  The TPU kernels DMA one page
// per grid step through scalar-prefetched tables; here only the address
// of a key row changes.  The page is resolved per key row, never per
// tile, so any page size works with the 32-key tile (a tile may span
// several pages, or a page several tiles).  The row stride tbl_sb lets a
// column slice tables[:, :w] (the mixed step's attention window) be read
// in place.  Keys are only fetched below hi <= S, so tbl is never indexed
// at or past nb; a split-K chunk is nb / splits whole pages.
//
// The bf16 mixed step: mixed_mma_kernel.  The q-chunk rows of one (b, kv
// head) are R = Q * G (the same row packing); at the main path (Q = 8,
// G = 2) R = 16, one m16 tensor-core tile, and a CTA of flash_rows_kernel
// walked ~1000 keys with one scalar dot product of D shared loads per
// (row, key) and four barriers per 32-key tile: bound by latency and issue
// rate at 30x a bytes bound.  mixed_mma_kernel runs the warp tile of
// include/attention_mma.cuh: 8 warps over a 64-row block, QK^T and PV on
// the tensor cores (mma.sync m16n8k16, fp32 accumulate), 128-key K/V tiles
// in a 2-stage ring of 16-byte cp.async.cg copies (the next tile loads
// while this one is computed), keys at or past the CTA's limit zero-filled so a
// NaN in a stale tail or in the trash page never reaches a product.  A key
// row's address is resolved per row, through the batch stride or the block
// table (a paged tile is not one box, hence cp.async and not TMA): one
// thread per key row writes the tile's row offsets into a shared ring a
// stage ahead of the copies, reading its table entry a further tile ahead,
// and 16 threads copy each 256-byte row (at D = 128), so a warp's copy
// covers whole rows while the table, the page arithmetic and the 64-bit
// offset are done once per key row, not once per 16-byte copy.
// At the main path the block has one m16 tile, so a warp's work per tile
// is short chains of dependent mma, shuffle and exp steps and the kernel is
// bound by latency more than by bytes: the warps of a block with fewer m16
// tiles than warps split each staged tile's keys (8 ways for one m-tile,
// the main path's 16 rows; 4 for two; 2 for three or four, as in
// prefill_paged's suffix) and keep their own (m, l, acc), merged in the
// epilogue through shared memory with the log-sum-exp rescale, inside the
// same launch.  The loop stops at the widest live row's limit.  Shared
// memory (Q, ring, row offsets): 158,720 bytes at D = 128, 103,424 at
// D = 80, 84,992 at D = 64, 48,128 at D = 32.  ptxas (sm_90a, CUDA 12.9):
// 229 registers per thread at D = 128, 149 at D = 80, 134 at D = 64, 128 at
// D = 32, no spills: one 8-warp CTA per SM (two at D = 32).
//
// The bf16 split-K partial: splitk_mma_kernel.  flash_rows_kernel gave a
// decode CTA kRows = 8 rows of which G (2 for qwen3, 1 for zamba2) are
// live, converted each 32-key tile to fp32 in shared memory and passed four
// barriers per tile: 0.0849 ms at phase 6's D = 128 shape against a bound
// of 0.0116, slower than SDPA's 0.0610 for the whole pair.  One CTA per
// (kv head, sequence, chunk) now runs the warp tile: the G rows are padded
// with zeros to one m16 tile, all 8 warps hold those 16 rows and take 16
// keys each of every 128-key tile (the tensor cores are far from the limit
// on this bytes-bound call), and their (m, l, acc) merge in finish_partial,
// which writes the chunk's unnormalised state (and, in the split-K
// decode, counts it in for the merge, count_in_and_merge).  The
// chunk's keys [c * ck, min((c + 1) * ck, lens[b])) are the tile's row
// interval; K/V come through the mixed kernel's cp.async ring with its row
// offsets (zero-fill past the length; shifts or division for the page).  A
// chunk wholly past the length writes the identity state before any copy
// (the partial alone) or exits at once (the split-K decode): at phase 6's
// lengths, 42 of each head's 64 chunks.  Q arrives
// with plain loads while the first tile is in flight, so q may be any view
// with dense heads (the decode step's q[:, 0] of the projection).  Ring:
// 2 stages (shared memory 145,664 bytes at D = 128, 94,976 at D = 80,
// 78,080 at D = 64, 44,288 at D = 32).  A third stage took the same time
// at D = 128 (one CTA per SM either way) and 12% longer at D = 80, where
// it leaves one CTA per SM instead of two.  ptxas (sm_90a), with the
// merge: 173 registers per thread at D = 128, 122 at D = 80, 114 at D = 64,
// 80 at D = 32, no spills (flash_rows_kernel, which the merge also joins,
// spills 8 bytes at bf16 D = 64 and 4 at fp32 D = 80).  NVIDIA H100 80GB
// HBM3, 700.00 W, phase 6's shapes, queued and warm (attention_timing.py):
// the partial alone 0.0207 ms at D = 128 (1.8x its bound), 0.0453 at D = 80,
// 0.0214 paged; the one-launch split-K decode 0.0235 at D = 128 (the
// partial + combine pair before it 0.0254; SDPA 0.0616), 0.0476 at D = 80
// (0.0496), 0.0235 paged (0.0255).
//
// The single-stage decode: cluster_mma_kernel (bf16) and cluster_f32_kernel
// (fp32).  Below the split-K threshold (2048 keys, ops.py) every decode
// step of every layer runs it: in the port, a served max_len under 2048
// (chip_smoke.py's bf16 phases 4j and 4k at 1536) and the fp32
// card-vs-CPU runs (5, 5b, 5e).  The port has no fleet; the JAX fleet's
// tiers (max_len 64 by default, the recovery drill's 544) serve reduced
// fp32 models (2 kv heads of 32) below it as well.  Bound: bytes.
// At qwen3-0.6b's B=8, Hkv=8, D=128 a step reads 2*L*8*128*es bytes of K
// and V per sequence at length L; the ~1 flop a byte is far under either
// unit's rate.  flash_rows_kernel gave each (sequence, kv head) one CTA of
// 8 rows of which G (2 for qwen3, 1 for zamba2) were live: 64 CTAs on 132
// SMs at B=8 (6 at the recovery tier's B=3 of 2 kv heads), each walking its sequence's
// keys alone, a 32-key tile at a time with four barriers a tile: 0.0956
// ms fp32 at phase 6's shape against a bound of 0.0084.  Now one launch of
// grid (C, Hkv, B) in clusters of (C, 1, 1) splits each (sequence, kv
// head)'s keys over C CTAs, C from kernel.py's cluster_split (the largest
// power of two <= 8 with C * B * Hkv within one wave, 132 SMs times the
// CTAs an SM holds (CLUSTER_CTAS_PER_SM), and no more CTAs than 128-key
// tiles: at qwen3's B=8, 2 in bf16 and 4 in fp32; 4 at the tier; 1 at
// zamba2's B=8 of 32 kv heads in bf16 and at max_len 64), chosen on the
// host from shapes alone, never from the
// lengths (no host sync).  CTA c walks whole 128-key tiles
// [floor(c*tiles/C), floor((c+1)*tiles/C)) cut at the length; a chunk
// wholly past it keeps the identity state and copies nothing.  Each CTA
// merges its warps into one (m, l, acc) in its own shared memory; after
// cluster.sync() the CTAs read each other's states through distributed
// shared memory (map_shared_rank), merge them in rank order 0..C-1 with
// the log-sum-exp rescale, and each normalises and stores every C-th
// 8-dim unit of the output; a second cluster.sync() keeps every CTA alive
// until the others have read it.  No workspace, no atomic, no second
// launch, and the result does not depend on scheduling; static shapes, so
// it captures into a CUDA graph as it is.
// bf16: the split partial's tensor-core walk (MmaChunk, shared with
// splitk_mma_kernel), the CTA's warps merged by merge_warps into its state
// instead of into global partials.  fp32: CUDA-core math (no TF32: the
// fp32 streams are held token-exact with the CPU), K/V by 16-byte cp.async
// straight into a 3-stage fp32 ring of 32-key tiles (64 at D = 64, 128 at
// D = 32: ~32 KB a stage), one barrier a tile; a key row is read by a
// group of D/4 lanes (32 at D = 80, 20 live), 4 dims a lane, so a warp
// takes 32/(D/4) keys at once; each lane group keeps its own online
// softmax for R rows (1 at G = 1, else 2; a wider group, which no model
// here has, walks the chunk once per pair of rows), the score reduced
// over the group by xor-shuffles, the P V update lane-local; the groups
// merge by shuffles, the warps through merge_warps.
// Shared memory (dynamic; ring, row offsets, the CTA's state): bf16
// 153,984 bytes at D = 128, 100,224 at D = 80, 82,304 at D = 64, 46,464 at
// D = 32 (CTAs an SM holds: 1, 2, 2, 4); fp32 107,392, 67,456, 104,064,
// 103,552 (2, 3, 2, 2), kernel.py's CLUSTER_CTAS_PER_SM.  ptxas (sm_90a),
// no spills: bf16 165 registers at D = 128, 121 at 80, 100 at 64, 64 at
// 32; fp32 64 (R = 1) and 80 (R = 2), 78 at D = 80.  The fp32 kernel's R
// is 1 or 2 only: R = 4, 8 and 16 (80-255 registers) served no model and
// took 8.7 of this file's 24.6 s build alone (15.9 s now, 10.2 without the
// cluster kernels; python -m repro_torch.kernels._build).  Clusters
// resident at once (cudaOccupancyMaxActiveClusters, D = 128, C =
// 1/2/4/8): bf16 132, 66, 30, 15; fp32 264, 132, 62, 30.  NVIDIA H100
// 80GB HBM3, 700.00 W, phase 6's shape, queued (attention_timing.py):
// bf16 0.0123 ms at C = 2 (the parent's flash_rows_kernel 0.0774, SDPA
// 0.0210), paged 0.0125; fp32 0.0193 at C = 4 (0.0949), paged 0.0193
// (0.1199).
//
// Numerics match the TPU kernels: fp32 scores and softmax state, masking
// with -1e30 (not -inf: a fully masked row stays finite), p rounded to V's
// dtype before the PV product, output divided by max(l, 1e-30).  A split
// chunk wholly past the length emits the identity state (m=-1e30, l=0,
// acc=0), which the merge's rescale zeroes; a sequence of length 0 gives 0.
//
// Every entry point returns cudaGetLastError() after its launch (or -1 for
// an unsupported dtype/head_dim), so a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cooperative_groups.h>

#include "attention_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 8;       // query rows per CTA
constexpr int kTile = 32;      // keys per tile (= warp width, see softmax)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// 16 bytes of T as fp32: 4 floats or 8 bfloat16s
template <typename T> struct Pack { static constexpr int N = 16 / sizeof(T); };
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

struct RowsParams {
  const void* q;      // (B, Q, Hq, D) with strides q_sb, q_sq; heads contiguous
  const void* k;      // (B, S, Hkv, D) with batch stride k_sb; (S, Hkv, D) dense,
  const void* v;      //   or with tbl the pool (P, ps, Hkv, D) dense, k_sb = 0
  const int* tbl;     // (B, nb) block tables with row stride tbl_sb, or nullptr
  const int* lens;    // (B,) decode: valid length; mixed: cached length
  void* out;          // (B, Q, Hq, D) contiguous, when m_out == nullptr
  float* m_out;       // (B, Hkv, splits, R) partial state, else nullptr
  float* l_out;
  float* acc_out;     // (B, Hkv, splits, R, D)
  int* counters;      // split-K: (B, Hkv, row blocks) arrival counts, all 0
                      // between launches; the merged rows go to out.  nullptr:
                      // the partial state alone
  int B, Q, Hq, Hkv, S, splits, add;
  long long q_sb, q_sq, k_sb, v_sb, tbl_sb;
  int ps;             // page size (paged only)
  float scale;
};

// The split-K merge in the partial's launch.  A chunk wholly past the
// length adds exact zeros to the merge (its weight exp(-1e30 - m*) is 0),
// so it takes no part: its CTA exits before storing anything, and the
// count waits for the live chunks only, live_chunks of them (chunk 0 is
// live at length 0 too, and its identity state merges to 0).
__device__ __forceinline__ int live_chunks(const RowsParams& p, int b) {
  const int ck = p.S / p.splits;
  const int len = min(p.S, p.lens[b]);
  return max(1, min(p.splits, (len + ck - 1) / ck));
}

constexpr int kMergeBatch = 8;   // chunk states a thread loads at once (auto_k_splits <= 8)

// Every thread of a CTA that has stored its chunk's (m, l, acc) for rows
// [r0, r0 + nr) of (b, h) calls it.  The CTA synchronises, so thread 0 has
// observed every thread's stores; thread 0 then counts the chunk in on
// counter `ctr` with one atom.acq_rel.gpu.inc wrapping at live - 1: its
// release makes those stores visible at device scope before the count
// (cumulativity, the pattern of cooperative groups' grid sync and
// CUTLASS's split-K semaphore, without a separate fence in every thread;
// 1.5% faster at phase 6's shape), and the CTA that completes the count
// reads live - 1, acquires every other CTA's stores with it, and leaves
// the counter at 0 for the next launch.  After a second barrier that CTA
// reads the live chunk states through L2 (__ldcg: other SMs wrote them,
// and L1 is not coherent with their stores; the first kMergeBatch of them
// all in flight at once, so the merge waits on L2 about once), merges
// them in chunk order with the TPU combine's arithmetic (m* first, then
// the alpha-weighted sums, then a divide by max(l, 1e-30)) and stores the
// rows in T.  Which CTA merges depends on scheduling; what it computes
// does not.
template <typename T, int D, int kNThreads>
__device__ __forceinline__ void count_in_and_merge(const RowsParams& p, int b, int h, int ctr,
                                                   int r0, int nr, int live) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(reinterpret_cast<unsigned*>(p.counters) + ctr), "r"(live - 1)
                 : "memory");
    last = old == static_cast<unsigned>(live - 1);
  }
  __syncthreads();
  if (!last) return;
  const int G = p.Hq / p.Hkv;
  const long long cell0 = (long long)(b * p.Hkv + h) * p.splits * G;   // chunk 0, row 0
  const float* m = p.m_out + cell0;
  const float* l = p.l_out + cell0;
  const float* acc = p.acc_out + cell0 * D;
  T* out = static_cast<T*>(p.out) + ((long long)b * p.Hq + h * G) * D;
  for (int e = threadIdx.x; e < nr * D; e += kNThreads) {
    const int r = r0 + e / D, d = e % D;
    float mc[kMergeBatch], lc[kMergeBatch], ac[kMergeBatch];
#pragma unroll
    for (int c = 0; c < kMergeBatch; ++c) {
      if (c < live) {
        mc[c] = __ldcg(m + c * G + r);
        lc[c] = __ldcg(l + c * G + r);
        ac[c] = __ldcg(acc + (long long)(c * G + r) * D + d);
      }
    }
    float m_star = kNegInf;
#pragma unroll
    for (int c = 0; c < kMergeBatch; ++c)
      if (c < live) m_star = fmaxf(m_star, mc[c]);
    for (int c = kMergeBatch; c < live; ++c) m_star = fmaxf(m_star, __ldcg(m + c * G + r));
    float l_star = 0.f, o = 0.f;
#pragma unroll
    for (int c = 0; c < kMergeBatch; ++c) {
      if (c < live) {
        const float alpha = expf(mc[c] - m_star);
        l_star += lc[c] * alpha;
        o += ac[c] * alpha;
      }
    }
    for (int c = kMergeBatch; c < live; ++c) {
      const int cell = c * G + r;
      const float alpha = expf(__ldcg(m + cell) - m_star);
      l_star += __ldcg(l + cell) * alpha;
      o += __ldcg(acc + (long long)cell * D + d) * alpha;
    }
    out[r * D + d] = from_f<T>(o / fmaxf(l_star, 1e-30f));
  }
}

// Row r of a CTA's (b, h) group is chunk query r / G, head h*G + r % G; it
// sees keys at positions < lens[b] + r / G + add (add=0: decode length,
// add=1: the mixed kernel's causal limit cache_len + i + 1).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_rows_kernel(RowsParams p) {
  const int G = p.Hq / p.Hkv;
  const int R = p.Q * G;
  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z / p.splits;
  const int c = blockIdx.z % p.splits;
  const int ck = p.S / p.splits;
  const int c_lo = c * ck;
  const int nr = min(kRows, R - r0);          // live rows in this CTA
  const int base = p.lens[b];
  // split-K: a chunk wholly past the length takes no part in the merge
  if (p.counters != nullptr && c >= live_chunks(p, b)) return;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k) + b * p.k_sb;
  const T* __restrict__ v = static_cast<const T*>(p.v) + b * p.v_sb;

  __shared__ float qs[kRows][D];
  __shared__ float ks[kTile][D + 1];   // +1: conflict-free column reads
  __shared__ float vs[kTile][D];
  __shared__ float ps[kRows][kTile];
  __shared__ float m_s[kRows], l_s[kRows], corr_s[kRows];
  __shared__ int lim_s[kRows];

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int rr = e / D, d = e % D, r = r0 + rr;
    float x = 0.f;
    if (rr < nr) {
      const int qi = r / G, g = r % G;
      x = to_f(q[b * p.q_sb + qi * p.q_sq + (long long)(h * G + g) * D + d]);
    }
    qs[rr][d] = x;
  }
  if (tid < kRows) {
    lim_s[tid] = tid < nr ? base + (r0 + tid) / G + p.add : 0;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // keys this CTA needs: its chunk, cut at the widest live row's limit
  const int hi = min(c_lo + ck, base + (r0 + nr - 1) / G + p.add);

  constexpr int kPer = kRows * D / kThreads;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  // the next tile's K and V, 16 bytes per load, kVec loads of each per
  // thread; where the tile's packs do not split evenly over the threads
  // (D = 80 in bf16: 320 packs, 2.5 a thread) the last load is predicated
  constexpr int kPackN = Pack<T>::N;
  constexpr int kPacksPerKey = D / kPackN;
  constexpr int kUnits = kTile * kPacksPerKey;
  constexpr int kEven = kUnits % kThreads == 0;
  constexpr int kVec = (kUnits + kThreads - 1) / kThreads;
  static_assert(kPacksPerKey * kPackN == D, "a key row splits into 16-byte packs");
  uint4 kreg[kVec], vreg[kVec];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int u = tid + i * kThreads, j = u / kPacksPerKey, d0 = (u % kPacksPerKey) * kPackN;
      const int pos = t0 + j;
      kreg[i] = make_uint4(0, 0, 0, 0);
      vreg[i] = make_uint4(0, 0, 0, 0);
      if ((kEven || u < kUnits) && pos < hi) {
        long long row = pos;   // contiguous: the key's own row
        if (p.tbl != nullptr) row = (long long)p.tbl[b * p.tbl_sb + pos / p.ps] * p.ps + pos % p.ps;
        const long long off = row * p.Hkv * D + (long long)h * D + d0;
        kreg[i] = *reinterpret_cast<const uint4*>(k + off);
        vreg[i] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
  };
  if (c_lo < hi) fetch(c_lo);

  for (int t0 = c_lo; t0 < hi; t0 += kTile) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int u = tid + i * kThreads, j = u / kPacksPerKey, d0 = (u % kPacksPerKey) * kPackN;
      if (!kEven && u >= kUnits) continue;
      float kf[kPackN], vf[kPackN];
      unpack(kreg[i], kf, T());
      unpack(vreg[i], vf, T());
#pragma unroll
      for (int e = 0; e < kPackN; ++e) {
        ks[j][d0 + e] = kf[e];
        vs[j][d0 + e] = vf[e];
      }
    }
    __syncthreads();
    if (t0 + kTile < hi) fetch(t0 + kTile);   // in flight during this tile's math

    for (int e = tid; e < nr * kTile; e += kThreads) {
      const int rr = e / kTile, j = e % kTile, pos = t0 + j;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[rr][d], ks[j][d], s);
      s *= p.scale;
      ps[rr][j] = (pos < lim_s[rr] && pos < hi) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per key of the tile
    for (int rr = warp; rr < nr; rr += kThreads / 32) {
      const float s = ps[rr][lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, mx);
      const float pr = expf(s - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[rr][lane] = to_f(from_f<T>(pr));   // p in V's dtype for the PV product
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[rr] = corr;
        l_s[rr] = l_s[rr] * corr + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, rr = e / D, d = e % D;
      if (rr < nr) {
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) pv = fmaf(ps[rr][j], vs[j][d], pv);
        acc[i] = acc[i] * corr_s[rr] + pv;
      }
    }
    __syncthreads();
  }

  if (p.m_out != nullptr) {
    const long long cell = ((long long)(b * p.Hkv + h) * p.splits + c) * R;
    if (tid < nr) {
      p.m_out[cell + r0 + tid] = m_s[tid];
      p.l_out[cell + r0 + tid] = l_s[tid];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, rr = e / D, d = e % D;
      if (rr < nr) p.acc_out[(cell + r0 + rr) * D + d] = acc[i];
    }
    if (p.counters != nullptr)     // split-K: one counter per (b, h, row block)
      count_in_and_merge<T, D, kThreads>(p, b, h, (b * p.Hkv + h) * gridDim.x + blockIdx.x,
                                         r0, nr, live_chunks(p, b));
  } else {
    T* __restrict__ out = static_cast<T*>(p.out);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, rr = e / D, d = e % D;
      if (rr < nr) {
        const int r = r0 + rr, qi = r / G, g = r % G;
        const long long o = (((long long)b * p.Q + qi) * p.Hq + h * G + g) * D + d;
        out[o] = from_f<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
      }
    }
  }
}

template <typename T, int D>
void launch_rows(const RowsParams& p, cudaStream_t stream) {
  const int R = p.Q * (p.Hq / p.Hkv);
  dim3 grid((R + kRows - 1) / kRows, p.Hkv, p.B * p.splits);
  flash_rows_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
int dispatch_rows(int D, const RowsParams& p, cudaStream_t stream) {
  switch (D) {
    case 32: launch_rows<T, 32>(p, stream); break;
    case 64: launch_rows<T, 64>(p, stream); break;
    case 80: launch_rows<T, 80>(p, stream); break;
    case 128: launch_rows<T, 128>(p, stream); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 mixed step on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;        // 8 warps
constexpr int kMmaRows = 64;            // 4 m16 tiles per CTA
constexpr int kMmaKeys = 128;           // keys per staged K/V tile
constexpr int kStages = 2;              // K/V ring depth

template <int D> struct MixedSmem {
  using Tile = attn_mma::Tile<D>;
  static constexpr int kQ = kMmaRows * Tile::kStride;              // bf16 elements
  static constexpr int kRing = kStages * 2 * kMmaKeys * Tile::kStride;
  static constexpr int kOffs = (kQ + kRing) * 2;                    // byte offset of the row ring
  static constexpr int kBytes = kOffs + kStages * kMmaKeys * 8;
  static_assert(kMmaThreads / 32 * attn_mma::Reduce<D>::kFloats * 4 <= kRing * 2,
                "the epilogue's floats fit in the ring");
};

// Row r of a CTA's (b, h) group is chunk query r / G, head h*G + r % G; it
// sees keys below min(S, lens[b] + r / G + 1).
template <int D>
__global__ void __launch_bounds__(kMmaThreads) mixed_mma_kernel(RowsParams p) {
  using namespace attn_mma;
  constexpr int SR = Tile<D>::kStride;
  constexpr int TS = kMmaKeys * SR;              // one K or V tile, in bf16
  constexpr int C = Tile<D>::kChunks;
  constexpr int U = kMmaKeys * C / kMmaThreads;  // 16-byte K (and V) copies per thread
  static_assert(U * kMmaThreads == kMmaKeys * C, "a tile splits evenly over the threads");
  extern __shared__ uint4 smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [kMmaRows][stride]
  bf16* ring = qs + MixedSmem<D>::kQ;            // [kStages][K, V][kMmaKeys][stride]

  const int G = p.Hq / p.Hkv;
  const int R = p.Q * G;
  const int r0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nr = min(kMmaRows, R - r0);          // live rows in this CTA
  const int base = p.lens[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // warps per live m16 tile: each staged tile's keys are split among them
  const int mtiles = (nr + kWarpRows - 1) / kWarpRows;
  const int split = mtiles == 1 ? 8 : mtiles == 2 ? 4 : 2;
  const int mt = warp / split;                   // this warp's m-tile
  const int koff = warp % split * (kMmaKeys / split);
  const bool idle = mt >= mtiles;                // warps 6, 7 over three m-tiles

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)h * D;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)h * D;
  const int* tbl = p.tbl != nullptr ? p.tbl + (long long)b * p.tbl_sb : nullptr;
  const long long kv_row = (long long)p.Hkv * D;  // elements between key rows

  stage_rows<D, kMmaThreads, kMmaRows>(qs, q, [&](int r) -> const bf16* {
    const int rg = r0 + r;
    return r < nr ? q + (long long)(rg / G) * p.q_sq + (long long)(h * G + rg % G) * D : nullptr;
  });

  // keys the CTA needs: cut at the widest live row's limit
  const int hi = min(p.S, base + (r0 + nr - 1) / G + 1);
  // row r sees [0, hi_r); padding rows take the last live row's limit
  auto hi_of = [&](int r) { return min(p.S, base + (r0 + min(r, nr - 1)) / G + 1); };
  const int rw = mt * kWarpRows + lane / 4;
  WarpTile<D> t;
  t.init(0, hi_of(rw), 0, hi_of(rw + 8));
  const int ntiles = (hi + kMmaKeys - 1) / kMmaKeys;

  // A thread copies the same U (key, chunk) units of every tile (16
  // threads cover one 256-byte row at D = 128), so it needs the global
  // offset of U key rows per tile.  Thread j < kMmaKeys resolves key row j
  // of a tile once, into a ring of row offsets in shared memory, a stage
  // ahead of the copies that read it: through a block table, key pos of
  // sequence b is row pos % ps of page tbl[pos / ps], and that page is
  // read a further tile ahead, so the table load's latency hides behind a
  // tile's math.  A power-of-two page size (the engine's default of 16)
  // resolves with shifts, any other (EngineConfig accepts any) by division.
  // -1 marks a key at or past the CTA's limit: zero-filled.
  long long* offs = reinterpret_cast<long long*>(
      reinterpret_cast<char*>(smem_mma) + MixedSmem<D>::kOffs);   // [kStages][kMmaKeys]
  const bool pow2 = (p.ps & (p.ps - 1)) == 0;
  const int shift = __ffs(p.ps) - 1;
  int page = 0;
  auto fetch_page = [&](int tile) {
    const int pos = tile * kMmaKeys + threadIdx.x;
    if (tbl != nullptr && threadIdx.x < kMmaKeys && pos < hi)
      page = tbl[pow2 ? pos >> shift : pos / p.ps];
  };
  auto resolve = [&](int tile) {                 // row offsets of `tile`, from `page`
    const int pos = tile * kMmaKeys + threadIdx.x;
    if (threadIdx.x >= kMmaKeys) return;
    long long row = pos;                         // contiguous: the key's own row
    if (tbl != nullptr)
      row = pow2 ? ((long long)page << shift) + (pos & (p.ps - 1))
                 : (long long)page * p.ps + pos % p.ps;
    offs[tile % kStages * kMmaKeys + threadIdx.x] = pos < hi ? row * kv_row : -1;
  };
  auto stage_kv = [&](int tile) {
    bf16* ks = ring + (tile % kStages) * 2 * TS;
    const long long* ro = offs + tile % kStages * kMmaKeys;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = threadIdx.x + i * kMmaThreads, j = u / C, c = (u % C) * 8;
      const long long off = ro[j];
      const bool ok = off >= 0;
      cp_async16(ks + j * SR + c, k + (ok ? off + c : 0), ok);
      cp_async16(ks + TS + j * SR + c, v + (ok ? off + c : 0), ok);
    }
  };
  // prologue: row offsets of tiles 0 .. kStages - 1, copies of tiles
  // 0 .. kStages - 2 (group g holds tile g, group 0 also Q)
  for (int g = 0; g < kStages; ++g) {
    fetch_page(g);
    resolve(g);
  }
  fetch_page(kStages);
  __syncthreads();
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < ntiles) stage_kv(g);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();                // tile it has landed
    __syncthreads();                             // ... for all; tile it - 1 is consumed
    if (it == 0) t.load_q(qs + mt * kWarpRows * SR);
    if (it + kStages - 1 < ntiles) {
      stage_kv(it + kStages - 1);                // offsets resolved an iteration ago
      resolve(it + kStages);                     // into the slot tile it's copies read
      fetch_page(it + kStages + 1);
    }
    cp_async_commit();
    if (idle) continue;
    const bf16* ks = ring + (it % kStages) * 2 * TS + koff * SR;
    const int k0 = it * kMmaKeys + koff;
    if (split == 8) t.template step<kMmaKeys / 8>(ks, ks + TS, k0, p.scale);
    else if (split == 4) t.template step<kMmaKeys / 4>(ks, ks + TS, k0, p.scale);
    else t.template step<kMmaKeys / 2>(ks, ks + TS, k0, p.scale);
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free for the epilogue

  bf16* out = static_cast<bf16*>(p.out);
  finish_rows<D, kMmaThreads>(t, reinterpret_cast<float*>(ring), split, mt * kWarpRows, nr,
                              [&](int r) {
    const int rg = r0 + r;
    return out + (((long long)b * p.Q + rg / G) * p.Hq + h * G + rg % G) * D;
  });
}

template <int D>
int launch_mixed_mma(const RowsParams& p, cudaStream_t stream) {
  constexpr int bytes = MixedSmem<D>::kBytes;    // above 48 KB: opt in once
  static const cudaError_t attr = cudaFuncSetAttribute(
      mixed_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int R = p.Q * (p.Hq / p.Hkv);
  dim3 grid((R + kMmaRows - 1) / kMmaRows, p.Hkv, p.B);
  mixed_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mixed_mma(int D, const RowsParams& p, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_mixed_mma<32>(p, stream);
    case 64: return launch_mixed_mma<64>(p, stream);
    case 80: return launch_mixed_mma<80>(p, stream);
    case 128: return launch_mixed_mma<128>(p, stream);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// bf16 split-K decode partial on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kSplitStages = 2;         // K/V ring depth (a third stage was no faster)

template <int D> struct SplitSmem {
  using Tile = attn_mma::Tile<D>;
  static constexpr int kQ = attn_mma::kWarpRows * Tile::kStride;   // bf16 elements
  static constexpr int kRing = kSplitStages * 2 * kMmaKeys * Tile::kStride;
  static constexpr int kOffs = (kQ + kRing) * 2;                    // byte offset of the row ring
  static constexpr int kBytes = kOffs + kSplitStages * kMmaKeys * 8;
  static_assert(kMmaThreads / 32 * attn_mma::Reduce<D>::kFloats * 4 <= kRing * 2,
                "the epilogue's floats fit in the ring");
};

// Where the key rows of one chunk [lo, end) of a sequence's keys live.
// Thread j < kKeys writes the offset of key lo + tile * kKeys + j into a
// shared ring of row offsets a stage ahead of the copies that read it,
// from a table entry read a further tile ahead: through a block table, key
// pos is row pos % ps of page tbl[pos / ps] (shifts for a power-of-two page
// size, division otherwise); -1 marks a key at or past hi, zero-filled.
// Entries are read only below the chunk's end (<= S, so never past the
// table's row), and the first tiles' before the length is known, so that
// load and the length's overlap.
template <int kKeys, int kStages>
struct KeyRows {
  const int* tbl;
  int ps, shift, lo, end;
  bool pow2;
  long long kv_row;                              // elements between key rows

  __device__ __forceinline__ KeyRows(const RowsParams& p, int b, int D, int lo_, int end_) {
    tbl = p.tbl != nullptr ? p.tbl + (long long)b * p.tbl_sb : nullptr;
    ps = p.ps;
    shift = __ffs(p.ps) - 1;
    lo = lo_;
    end = end_;
    pow2 = (p.ps & (p.ps - 1)) == 0;
    kv_row = (long long)p.Hkv * D;
  }

  __device__ __forceinline__ int page_of(int tile) const {
    const int pos = lo + tile * kKeys + threadIdx.x;
    return tbl != nullptr && threadIdx.x < kKeys && pos < end
        ? tbl[pow2 ? pos >> shift : pos / ps] : 0;
  }
  __device__ __forceinline__ void resolve(long long* offs, int tile, int page, int hi) const {
    const int pos = lo + tile * kKeys + threadIdx.x;
    if (threadIdx.x >= kKeys) return;
    long long row = pos;                         // contiguous: the key's own row
    if (tbl != nullptr)
      row = pow2 ? ((long long)page << shift) + (pos & (ps - 1))
                 : (long long)page * ps + pos % ps;
    offs[tile % kStages * kKeys + threadIdx.x] = pos < hi ? row * kv_row : -1;
  }
};

// The tensor-core walk of one chunk of keys, shared by the split-K partial
// and the single-stage cluster kernel: the G query rows of head group h
// (padded with zero rows to one m16 tile) over keys [lo, hi), the 8 warps
// taking 16 keys each of every staged 128-key tile.  The constructor reads
// the first tiles' table entries (before the caller reads the length);
// run() stages K/V through the cp.async ring with the row offsets of
// KeyRows and leaves the warps' states in t, cp.async drained and the CTA
// synchronised, so the ring is free for the epilogue.
template <int D>
struct MmaChunk {
  KeyRows<kMmaKeys, kSplitStages> rows;
  int pages[kSplitStages + 1];

  __device__ __forceinline__ MmaChunk(const RowsParams& p, int b, int lo, int end)
      : rows(p, b, D, lo, end) {
#pragma unroll
    for (int g = 0; g <= kSplitStages; ++g) pages[g] = rows.page_of(g);
  }

  __device__ __forceinline__ void run(const RowsParams& p, int b, int h, int hi, uint4* smem,
                                      attn_mma::WarpTile<D>& t) {
    using namespace attn_mma;
    using Smem = SplitSmem<D>;
    constexpr int SR = Tile<D>::kStride;
    constexpr int TS = kMmaKeys * SR;              // one K or V tile, in bf16
    constexpr int C = Tile<D>::kChunks;
    constexpr int U = kMmaKeys * C / kMmaThreads;  // 16-byte K (and V) copies per thread
    static_assert(U * kMmaThreads == kMmaKeys * C, "a tile splits evenly over the threads");
    bf16* qs = reinterpret_cast<bf16*>(smem);      // [kWarpRows][stride]
    bf16* ring = qs + Smem::kQ;                    // [kSplitStages][K, V][kMmaKeys][stride]
    long long* offs = reinterpret_cast<long long*>(
        reinterpret_cast<char*>(smem) + Smem::kOffs);   // [kSplitStages][kMmaKeys]

    const int G = p.Hq / p.Hkv;
    const int lo = rows.lo;
    const int koff = threadIdx.x / 32 * (kMmaKeys / 8);
    const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)h * D;
    const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)h * D;
    const int ntiles = (hi - lo + kMmaKeys - 1) / kMmaKeys;

    auto stage_kv = [&](int tile) {
      bf16* ks = ring + (tile % kSplitStages) * 2 * TS;
      const long long* ro = offs + tile % kSplitStages * kMmaKeys;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = threadIdx.x + i * kMmaThreads, j = u / C, cc = (u % C) * 8;
        const long long off = ro[j];
        const bool ok = off >= 0;
        cp_async16(ks + j * SR + cc, k + (ok ? off + cc : 0), ok);
        cp_async16(ks + TS + j * SR + cc, v + (ok ? off + cc : 0), ok);
      }
    };
    // prologue: row offsets of tiles 0 .. kSplitStages - 1, copies of tiles
    // 0 .. kSplitStages - 2 (group g holds tile g)
#pragma unroll
    for (int g = 0; g < kSplitStages; ++g) rows.resolve(offs, g, pages[g], hi);
    int page = pages[kSplitStages];
    __syncthreads();
    for (int g = 0; g < kSplitStages - 1; ++g) {
      if (g < ntiles) stage_kv(g);
      cp_async_commit();
    }

    // Q with plain loads while the first tiles are in flight: q may be any
    // view with dense (Hq, D) (the decode step passes q[:, 0] of the
    // projection), so no alignment is assumed; rows G.. are zero
    const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + (long long)h * G * D;
#pragma unroll
    for (int i = 0; i < kWarpRows * D / kMmaThreads; ++i) {
      const int e = threadIdx.x + i * kMmaThreads, r = e / D, d = e % D;
      qs[r * SR + d] = r < G ? q[r * D + d] : __float2bfloat16(0.f);
    }

    t.init(lo, hi, lo, hi);
    for (int it = 0; it < ntiles; ++it) {
      cp_async_wait<kSplitStages - 2>();           // tile it has landed
      __syncthreads();                             // ... for all; tile it - 1 is consumed
      if (it == 0) t.load_q(qs);
      if (it + kSplitStages - 1 < ntiles) {
        stage_kv(it + kSplitStages - 1);           // offsets resolved an iteration ago
        rows.resolve(offs, it + kSplitStages, page, hi);  // into the slot tile it's copies read
        page = rows.page_of(it + kSplitStages + 1);
      }
      cp_async_commit();
      const bf16* ks = ring + (it % kSplitStages) * 2 * TS + koff * SR;
      t.template step<kMmaKeys / 8>(ks, ks + TS, lo + it * kMmaKeys + koff, p.scale);
    }
    cp_async_wait<0>();
    __syncthreads();                               // the ring is free for the epilogue
  }
};

// One CTA per (kv head h, sequence b, chunk c): the G query rows of head
// group h over keys [c * ck, min((c + 1) * ck, lens[b])), ck = S / splits
// (MmaChunk).  Writes the chunk's unnormalised (m, l, acc) to the (B, Hkv,
// splits, G[, D]) partials; with counters, the last of (b, h)'s chunks
// merges them into out (count_in_and_merge).
template <int D>
__global__ void __launch_bounds__(kMmaThreads) splitk_mma_kernel(RowsParams p) {
  extern __shared__ uint4 smem_split[];
  const int G = p.Hq / p.Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y / p.splits, c = blockIdx.y % p.splits;
  const int ck = p.S / p.splits;
  const int lo = c * ck;
  MmaChunk<D> walk(p, b, lo, lo + ck);

  const int hi = min(lo + ck, min(p.S, p.lens[b]));
  const int live = live_chunks(p, b);
  if (p.counters != nullptr && c >= live) return;   // split-K: no part in the merge
  const long long cell = ((long long)(b * p.Hkv + h) * p.splits + c) * G;
  if (hi <= lo) {                                // wholly past the length: the identity
    for (int e = threadIdx.x; e < G * D; e += kMmaThreads) p.acc_out[cell * D + e] = 0.f;
    if (threadIdx.x < G) {
      p.m_out[cell + threadIdx.x] = attn_mma::kNegInf;
      p.l_out[cell + threadIdx.x] = 0.f;
    }
  } else {
    attn_mma::WarpTile<D> t;
    walk.run(p, b, h, hi, smem_split, t);
    float* red = reinterpret_cast<float*>(reinterpret_cast<attn_mma::bf16*>(smem_split)
                                          + SplitSmem<D>::kQ);
    attn_mma::finish_partial<D, kMmaThreads>(t, red, G, p.m_out + cell, p.l_out + cell,
                                             p.acc_out + cell * D);
  }
  if (p.counters != nullptr)                     // split-K: one counter per (b, h)
    count_in_and_merge<attn_mma::bf16, D, kMmaThreads>(p, b, h, b * p.Hkv + h, 0, G, live);
}

template <int D>
int launch_splitk_mma(const RowsParams& p, cudaStream_t stream) {
  constexpr int bytes = SplitSmem<D>::kBytes;    // above 48 KB: opt in once
  static const cudaError_t attr = cudaFuncSetAttribute(
      splitk_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(p.Hkv, p.B * p.splits);
  splitk_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_splitk_mma(int D, const RowsParams& p, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_splitk_mma<32>(p, stream);
    case 64: return launch_splitk_mma<64>(p, stream);
    case 80: return launch_splitk_mma<80>(p, stream);
    case 128: return launch_splitk_mma<128>(p, stream);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// single-stage decode: one launch, keys split over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kClusterKeys = 128;       // a CTA's chunk is whole tiles of this many keys
constexpr int kClusterThreads = 256;    // 8 warps, both dtypes

// Keys [lo, end) of CTA `rank` of a cluster of C: the S keys' 128-key
// tiles dealt out in order, floor(c * tiles / C) onwards, so no CTA of a
// cluster with C <= tiles is empty at the full length (kernel.py's
// cluster_chunks is the same arithmetic).
__device__ __forceinline__ void cluster_chunk(int S, int rank, int C, int& lo, int& end) {
  const int tiles = (S + kClusterKeys - 1) / kClusterKeys;
  lo = rank * tiles / C * kClusterKeys;
  end = min((rank + 1) * tiles / C * kClusterKeys, S);
}

// A CTA's merged state, left in its own shared memory for the cluster:
// acc [kWarpRows][D], then m [kWarpRows], then l [kWarpRows], fp32.
template <int D> struct ClusterState {
  static constexpr int kFloats = attn_mma::kWarpRows * (D + 2);
  __device__ static float* m(float* s) { return s + attn_mma::kWarpRows * D; }
  __device__ static float* l(float* s) { return s + attn_mma::kWarpRows * (D + 1); }
  // a chunk wholly past the length: m = -1e30, l = 0, acc = 0
  __device__ static void identity(float* s, int G) {
    for (int e = threadIdx.x; e < G * D; e += kClusterThreads) s[e] = 0.f;
    if (threadIdx.x < G) {
      m(s)[threadIdx.x] = attn_mma::kNegInf;
      l(s)[threadIdx.x] = 0.f;
    }
  }
};

__device__ __forceinline__ void store8(float* dst, const float (&o)[8], float den) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0] / den, o[1] / den, o[2] / den, o[3] / den);
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(o[4] / den, o[5] / den, o[6] / den, o[7] / den);
}
__device__ __forceinline__ void store8(attn_mma::bf16* dst, const float (&o)[8], float den) {
  using attn_mma::pack_bf16;
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(o[0] / den, o[1] / den),
                                              pack_bf16(o[2] / den, o[3] / den),
                                              pack_bf16(o[4] / den, o[5] / den),
                                              pack_bf16(o[6] / den, o[7] / den));
}

// The cluster's merge.  Every CTA has left its chunk's merged (m, l, acc)
// of rows [0, G) in its `state` and passed cluster.sync().  Unit u (a row
// and 8 of its dims) belongs to CTA u % C, which reads that unit of all C
// states through distributed shared memory, merges them in rank order
// 0..C-1 with the log-sum-exp rescale, divides by max(l, 1e-30) and stores
// it to out_row(row), the row's first output element (16-byte aligned).
// The result does not depend on which CTA ran when.
template <typename T, int D, class OutRow>
__device__ __forceinline__ void merge_cluster(cg::cluster_group& cluster, float* state, int G,
                                              OutRow out_row) {
  using S = ClusterState<D>;
  constexpr int U = D / 8;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int u = threadIdx.x * C + rank; u < G * U; u += kClusterThreads * C) {
    const int row = u / U, d0 = (u % U) * 8;
    float m_star = attn_mma::kNegInf;
    for (int r = 0; r < C; ++r) m_star = fmaxf(m_star, S::m(cluster.map_shared_rank(state, r))[row]);
    float l_star = 0.f, o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < C; ++r) {
      float* s = cluster.map_shared_rank(state, r);
      const float a = expf(S::m(s)[row] - m_star);
      l_star += S::l(s)[row] * a;
      const float4 x = *reinterpret_cast<const float4*>(s + row * D + d0);
      const float4 y = *reinterpret_cast<const float4*>(s + row * D + d0 + 4);
      o[0] += x.x * a; o[1] += x.y * a; o[2] += x.z * a; o[3] += x.w * a;
      o[4] += y.x * a; o[5] += y.y * a; o[6] += y.z * a; o[7] += y.w * a;
    }
    store8(out_row(row) + d0, o, fmaxf(l_star, 1e-30f));
  }
}

// bf16: the split partial's tensor-core walk (MmaChunk) over the CTA's
// chunk, its warps merged into the CTA's state (merge_warps), then the
// cluster's merge.  Grid (C, Hkv, B), clusters of (C, 1, 1).
template <int D> struct ClusterMmaSmem {
  static constexpr int kState = SplitSmem<D>::kBytes;   // byte offset of the CTA's state
  static constexpr int kBytes = kState + ClusterState<D>::kFloats * 4;
  static_assert(kState % 16 == 0, "the state is read as float4");
};

template <int D>
__global__ void __launch_bounds__(kClusterThreads) cluster_mma_kernel(RowsParams p) {
  static_assert(kClusterThreads == kMmaThreads, "the walk is the split partial's");
  extern __shared__ uint4 smem_cmma[];
  cg::cluster_group cluster = cg::this_cluster();
  float* state = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_cmma)
                                          + ClusterMmaSmem<D>::kState);
  const int G = p.Hq / p.Hkv;
  const int h = blockIdx.y, b = blockIdx.z;
  int lo, end;
  cluster_chunk(p.S, static_cast<int>(cluster.block_rank()),
                static_cast<int>(cluster.num_blocks()), lo, end);
  MmaChunk<D> walk(p, b, lo, end);

  const int hi = min(end, p.lens[b]);
  if (hi > lo) {
    attn_mma::WarpTile<D> t;
    walk.run(p, b, h, hi, smem_cmma, t);
    float* red = reinterpret_cast<float*>(reinterpret_cast<attn_mma::bf16*>(smem_cmma)
                                          + SplitSmem<D>::kQ);
    attn_mma::finish_partial<D, kClusterThreads>(t, red, G, ClusterState<D>::m(state),
                                                 ClusterState<D>::l(state), state);
  } else {
    ClusterState<D>::identity(state, G);
  }
  cluster.sync();                                // every CTA's state is complete
  attn_mma::bf16* out = static_cast<attn_mma::bf16*>(p.out) + ((long long)b * p.Hq + h * G) * D;
  merge_cluster<attn_mma::bf16, D>(cluster, state, G, [&](int r) { return out + r * D; });
  cluster.sync();                                // ... and read: now a CTA may exit
}

// fp32: CUDA-core math.  K/V tiles come by 16-byte cp.async straight into
// a 3-stage fp32 ring (no conversion), with the row offsets of KeyRows.  A
// key row is read by a group of kLanes lanes, 4 dims each (D = 80: 20 of
// 32 lanes live), so a warp takes kGroups keys at once; each lane group
// keeps its own online-softmax state for R rows (1 at G = 1, else 2: a
// wider group is walked two rows a pass), every lane holding those rows'
// state for its dims: the score reduces over the group by xor-shuffles and
// the P V update is lane-local.  Keys past hi are skipped (uniform per
// group).  One barrier per tile.
template <int D> struct F32Tile {
  static constexpr int kKeys = D > 64 ? 32 : 4096 / D;   // ~32 KB of K and V per stage
  static constexpr int kLanes = D > 64 ? 32 : D / 4;
  static constexpr int kGroups = 32 / kLanes;
  static constexpr int kStages = 3;
  static constexpr int kWarpKeys = kKeys / (kClusterThreads / 32);   // keys per warp per tile
  static constexpr int kRing = kStages * 2 * kKeys * D;              // floats
  static constexpr int kOffs = kRing * 4;                            // byte offset of the row ring
  static constexpr int kState = kOffs + kStages * kKeys * 8;         // ... and of the state
  static constexpr int kBytes = kState + ClusterState<D>::kFloats * 4;
  static_assert(kClusterKeys % kKeys == 0 && kWarpKeys % kGroups == 0, "whole tiles and steps");
  static_assert(kClusterThreads / 32 * attn_mma::Reduce<D>::kFloats <= kRing,
                "the epilogue's floats fit in the ring");
};

template <int D, int R>
__global__ void __launch_bounds__(kClusterThreads) cluster_f32_kernel(RowsParams p) {
  using F = F32Tile<D>;
  using attn_mma::kWarpRows;
  constexpr int CH = D / 4;                       // 16-byte chunks per row
  constexpr int UNITS = F::kKeys * CH;            // per K (and V) tile
  constexpr int RS = attn_mma::Reduce<D>::kStride;
  extern __shared__ uint4 smem_cf32[];
  float* ring = reinterpret_cast<float*>(smem_cf32);            // [kStages][K, V][kKeys][D]
  long long* offs = reinterpret_cast<long long*>(
      reinterpret_cast<char*>(smem_cf32) + F::kOffs);           // [kStages][kKeys]
  float* state = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_cf32) + F::kState);
  cg::cluster_group cluster = cg::this_cluster();

  const int G = p.Hq / p.Hkv;
  const int h = blockIdx.y, b = blockIdx.z;
  int lo, end;
  cluster_chunk(p.S, static_cast<int>(cluster.block_rank()),
                static_cast<int>(cluster.num_blocks()), lo, end);
  KeyRows<F::kKeys, F::kStages> rows(p, b, D, lo, end);
  int pages[F::kStages + 1];
#pragma unroll
  for (int g = 0; g <= F::kStages; ++g) pages[g] = rows.page_of(g);

  const int hi = min(end, p.lens[b]);
  if (hi > lo) {
    const float* k = static_cast<const float*>(p.k) + b * p.k_sb + (long long)h * D;
    const float* v = static_cast<const float*>(p.v) + b * p.v_sb + (long long)h * D;
    const int ntiles = (hi - lo + F::kKeys - 1) / F::kKeys;
    auto stage_kv = [&](int tile) {
      float* ks = ring + (tile % F::kStages) * 2 * F::kKeys * D;
      const long long* ro = offs + tile % F::kStages * F::kKeys;
#pragma unroll
      for (int i = 0; i < (UNITS + kClusterThreads - 1) / kClusterThreads; ++i) {
        const int u = threadIdx.x + i * kClusterThreads, j = u / CH, c = (u % CH) * 4;
        if (UNITS % kClusterThreads != 0 && u >= UNITS) break;
        const long long off = ro[j];
        const bool ok = off >= 0;
        attn_mma::cp_async16(ks + j * D + c, k + (ok ? off + c : 0), ok);
        attn_mma::cp_async16(ks + F::kKeys * D + j * D + c, v + (ok ? off + c : 0), ok);
      }
    };
    // the G rows R at a time: one pass over the chunk at G <= 2, G / 2
    // passes (the chunk re-read from L2 each) for the wider groups no
    // model here has
    for (int r0 = 0; r0 < G; r0 += R) {
      if (r0 > 0) {
#pragma unroll
        for (int g = 0; g <= F::kStages; ++g) pages[g] = rows.page_of(g);
      }
#pragma unroll
      for (int g = 0; g < F::kStages; ++g) rows.resolve(offs, g, pages[g], hi);
      int page = pages[F::kStages];
      __syncthreads();
#pragma unroll
      for (int g = 0; g < F::kStages - 1; ++g) {
        if (g < ntiles) stage_kv(g);
        attn_mma::cp_async_commit();
      }

      // q rows [r0, r0 + R) of head group h with plain loads (any view with
      // dense (Hq, D)), 4 dims a lane; rows G.. and dims past D are zero
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      const int gi = lane / F::kLanes, li = lane % F::kLanes;
      const bool live = li < CH;
      const float* q =
          static_cast<const float*>(p.q) + b * p.q_sb + (long long)(h * G + r0) * D + 4 * li;
      float4 qr[R], acc[R];
      float m[R], l[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool ok = live && r < G - r0;
        qr[r] = make_float4(ok ? q[r * D] : 0.f, ok ? q[r * D + 1] : 0.f, ok ? q[r * D + 2] : 0.f,
                            ok ? q[r * D + 3] : 0.f);
        acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        m[r] = kNegInf;
        l[r] = 0.f;
      }

      for (int it = 0; it < ntiles; ++it) {
        attn_mma::cp_async_wait<F::kStages - 2>();  // tile it has landed
        __syncthreads();                            // ... for all; tile it - 1 is consumed
        if (it + F::kStages - 1 < ntiles) {
          stage_kv(it + F::kStages - 1);            // offsets resolved an iteration ago
          rows.resolve(offs, it + F::kStages, page, hi);
          page = rows.page_of(it + F::kStages + 1);
        }
        attn_mma::cp_async_commit();
        const float* ks = ring + (it % F::kStages) * 2 * F::kKeys * D;
        const float* vs = ks + F::kKeys * D;
#pragma unroll
        for (int st = 0; st < F::kWarpKeys / F::kGroups; ++st) {
          const int j = warp * F::kWarpKeys + st * F::kGroups + gi;
          float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
          if (live) {
            kk = *reinterpret_cast<const float4*>(ks + j * D + 4 * li);
            vv = *reinterpret_cast<const float4*>(vs + j * D + 4 * li);
          }
          float s[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float x = qr[r].x * kk.x;
            x = fmaf(qr[r].y, kk.y, x);
            x = fmaf(qr[r].z, kk.z, x);
            s[r] = fmaf(qr[r].w, kk.w, x);
          }
#pragma unroll
          for (int o = F::kLanes / 2; o > 0; o >>= 1)
#pragma unroll
            for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
          if (lo + it * F::kKeys + j < hi) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float x = s[r] * p.scale;
              const float m_new = fmaxf(m[r], x);
              const float corr = expf(m[r] - m_new), pr = expf(x - m_new);
              m[r] = m_new;
              l[r] = fmaf(l[r], corr, pr);
              acc[r] = make_float4(
                  fmaf(acc[r].x, corr, pr * vv.x), fmaf(acc[r].y, corr, pr * vv.y),
                  fmaf(acc[r].z, corr, pr * vv.z), fmaf(acc[r].w, corr, pr * vv.w));
            }
          }
        }
      }
      attn_mma::cp_async_wait<0>();
      __syncthreads();                              // the ring is free for the epilogue

      // the warp's lane groups merged by xor-shuffles, then the warps' states
      // (Reduce layout, aliasing the ring) merged into rows [r0, r0 + R) of
      // the CTA's state
#pragma unroll
      for (int o = F::kLanes; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
          const float lz = __shfl_xor_sync(0xffffffffu, l[r], o);
          const float4 ao = make_float4(__shfl_xor_sync(0xffffffffu, acc[r].x, o),
                                        __shfl_xor_sync(0xffffffffu, acc[r].y, o),
                                        __shfl_xor_sync(0xffffffffu, acc[r].z, o),
                                        __shfl_xor_sync(0xffffffffu, acc[r].w, o));
          const float m_new = fmaxf(m[r], mo);
          const float wa = expf(m[r] - m_new), wo = expf(mo - m_new);
          m[r] = m_new;
          l[r] = l[r] * wa + lz * wo;
          acc[r] = make_float4(acc[r].x * wa + ao.x * wo, acc[r].y * wa + ao.y * wo,
                               acc[r].z * wa + ao.z * wo, acc[r].w * wa + ao.w * wo);
        }
      float* mine = ring + warp * attn_mma::Reduce<D>::kFloats;
      if (gi == 0 && live) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          *reinterpret_cast<float4*>(mine + r * RS + 4 * li) = acc[r];
          if (li == 0) {
            mine[kWarpRows * RS + r] = m[r];
            mine[kWarpRows * RS + kWarpRows + r] = l[r];
          }
        }
      }
      __syncthreads();
      attn_mma::merge_warps<D, kClusterThreads>(ring, min(R, G - r0),
                                                ClusterState<D>::m(state) + r0,
                                                ClusterState<D>::l(state) + r0, state + r0 * D);
    }
  } else {
    ClusterState<D>::identity(state, G);
  }
  cluster.sync();                                 // every CTA's state is complete
  float* out = static_cast<float*>(p.out) + ((long long)b * p.Hq + h * G) * D;
  merge_cluster<float, D>(cluster, state, G, [&](int r) { return out + r * D; });
  cluster.sync();                                 // ... and read: now a CTA may exit
}

// The fp32 mixed step: cluster_mixed_f32_kernel.  A CTA holds one block
// of 16 (query, head) rows of a (sequence, kv head) -- row r of block n is
// chunk query (16n + r) / G, head h*G + (16n + r) % G, the TPU's
// _regroup_q_chunk order -- and walks its cluster rank's chunk of the
// window's keys (cluster_chunk) once for all 16 rows, cut at the block's
// widest row limit.  Exact fp32 FMAs on the CUDA cores (no TF32: the fp32
// streams are held token-exact with the CPU).  What bounds it: each key
// costs a CTA 16 rows x D x 2 FMAs, and a 16-byte shared load costs its
// 32 lanes' 512 bytes of shared bandwidth even where lanes share an
// address, so the layout keeps four FMAs per float read from shared
// memory (a first layout at one FMA a float was bound by those bytes).
// Per staged tile of 64 keys, three passes, a barrier after each:
//   scores: warp w takes keys 8w .. 8w + 7; lane (g, s) holds q rows 4g ..
//     4g + 3 over the D/8 dims {KW s + 8 KW t + e} in registers for the
//     whole walk and reads each of its keys' dims of K once (4 rows x D/8
//     FMAs per key); the 32 partial sums are reduced over the 8 lanes s by
//     a butterfly reduce-scatter (3 steps, 28 shuffles), which leaves each
//     lane 4 finished scores, stored as one 16-byte word;
//   softmax: a half-warp per row, a lane per 4 keys: a key at or past the
//     row's limit is skipped (its p is 0, never exp(-1e30 - m)), the tile
//     max and sum by 4 xor-shuffles each; p goes back in place of the
//     scores, the rescale factor into corr;
//   P V: warp w again takes keys 8w .. 8w + 7; lane (rh, dg) holds rows
//     8 rh .. 8 rh + 7 x the D/16 dims {VW dg + 16 VW t + e} of its warp's
//     partial output, rescaled by corr, 8 x D/16 FMAs per key for 8 p and
//     D/16 V floats; the 8 warps' partials (one softmax state: a plain
//     sum) are added once, after the walk, in warp order.
// The scores are double-buffered by tile parity, so the next tile's scores
// never wait for this tile's P V.  K/V come as in cluster_f32_kernel: a
// 3-stage 16-byte cp.async ring with KeyRows' offsets, keys past the
// block's limit zero-filled.  The walk's (m, l, acc) go to the CTA's
// ClusterState (in the drained ring), then merge_cluster merges the
// cluster's states in rank order and stores each row through the row map.
// A row with no key in a CTA's chunk keeps the identity state (m = -1e30,
// l = 0, acc = 0), and a CTA whose chunk is empty for the whole block
// writes it and still reaches both cluster.sync()s.  No atomics and no
// workspace: repeats are bit-equal, and the static shapes capture into a
// CUDA graph as they are.  Shared memory (dynamic; ring, scores, corr, row
// offsets): 206,912 bytes at D = 128, 133,184 at 80, 108,608 at 64, 59,456
// at 32; an SM holds 1, 1, 1 and 2 CTAs (kernel.py's MIXED_CTAS_PER_SM),
// registers deciding at D = 64 (the score pass keeps q and the P V pass its
// outputs in registers: 255 a thread at D = 128, no spills; chip_smoke.py
// phase 2 prints each instantiation's).  It replaced
// flash_rows_kernel<float> (8 rows a CTA, each CTA walking its sequence's
// keys alone, 32-key tiles with four barriers, one scalar D-long dot
// product per (row, key)), which serves fp32 groups wider than 16 heads.
template <int D> struct MixF32 {
  static constexpr int kKeys = 64;                   // keys per staged tile
  static constexpr int kStages = 3;
  static constexpr int PR = kKeys + 4;               // score row stride, floats
  static constexpr int KW = D / 8 % 4 == 0 ? 4 : 2;  // dims a score lane reads at once
  static constexpr int KT = D / 8 / KW;              // ... that many times per key
  static constexpr int DV = D / 16;                  // output dims a P V lane holds
  static constexpr int VW = DV % 4 == 0 ? 4 : DV % 2 == 0 ? 2 : 1;
  static constexpr int kRing = kStages * 2 * kKeys * D;   // floats
  static constexpr int kRed = 8 * attn_mma::kWarpRows * D;   // the warps' P V partials
  static constexpr int kS = kRing;                   // float offsets of the parts
  static constexpr int kCorr = kS + 2 * attn_mma::kWarpRows * PR;
  static constexpr int kOffs = (kCorr + attn_mma::kWarpRows) * 4;   // bytes
  static constexpr int kBytes = kOffs + kStages * kKeys * 8;
  static_assert(kClusterKeys % kKeys == 0 && kKeys == 8 * (kClusterThreads / 32),
                "whole tiles, 8 keys a warp");
  static_assert(D % 16 == 0 && KT * KW * 8 == D, "head dim splits over 8 and 16 lanes");
  static_assert(kKeys * (D / 4) % kClusterThreads == 0, "a tile's copies split evenly");
  static_assert(kRed + ClusterState<D>::kFloats <= kRing && kOffs % 16 == 0,
                "partials and state in the ring");
};

// N floats from shared memory in one load (N = 4, 2 or 1; p aligned to it)
template <int N> __device__ __forceinline__ void lds(float* x, const float* p) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

// N floats to shared memory in one store (N = 4, 2 or 1; p aligned to it)
template <int N> __device__ __forceinline__ void sts(float* p, const float* x) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// One step of the score pass's reduce-scatter over lane bit N / 4 (N = 16,
// 8, 4): each lane keeps the half of x[0, 2N) its bit selects and adds its
// partner's sum of that half; the other half goes to the partner.
template <int N> __device__ __forceinline__ void reduce_scatter_step(float (&x)[32], int lane) {
  constexpr int o = N / 4;
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? x[i] : x[i + N];
    const float keep = up ? x[i + N] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1) cluster_mixed_f32_kernel(RowsParams p) {
  using M = MixF32<D>;
  using attn_mma::kWarpRows;
  constexpr int KK = M::kKeys, PR = M::PR, KW = M::KW, KT = M::KT, DV = M::DV, VW = M::VW;
  constexpr int CH = D / 4;                          // 16-byte chunks per row
  extern __shared__ uint4 smem_mix[];
  float* ring = reinterpret_cast<float*>(smem_mix);  // [kStages][K, V][kKeys][D]
  float* sc = ring + M::kS;                          // [2][16][PR]
  float* corr_s = ring + M::kCorr;                   // [16]
  long long* offs = reinterpret_cast<long long*>(
      reinterpret_cast<char*>(smem_mix) + M::kOffs);   // [kStages][kKeys]
  float* state = ring + M::kRed;                     // once the ring is drained
  cg::cluster_group cluster = cg::this_cluster();

  const int G = p.Hq / p.Hkv;
  const int R = p.Q * G;
  const int nblk = (R + kWarpRows - 1) / kWarpRows;
  const int h = blockIdx.y / nblk, r0 = blockIdx.y % nblk * kWarpRows;
  const int b = blockIdx.z;
  const int nr = min(kWarpRows, R - r0);             // live rows of the block
  int lo, end;
  cluster_chunk(p.S, static_cast<int>(cluster.block_rank()),
                static_cast<int>(cluster.num_blocks()), lo, end);
  KeyRows<KK, M::kStages> rows(p, b, D, lo, end);
  int pages[M::kStages + 1];
#pragma unroll
  for (int g = 0; g <= M::kStages; ++g) pages[g] = rows.page_of(g);

  // row r sees keys below base + (r0 + r) / G + 1 (and S); the CTA only its
  // chunk's, up to the widest live row's limit
  const int base = p.lens[b];
  const int hi = min(end, base + (r0 + nr - 1) / G + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (hi > lo) {
    const float* k = static_cast<const float*>(p.k) + b * p.k_sb + (long long)h * D;
    const float* v = static_cast<const float*>(p.v) + b * p.v_sb + (long long)h * D;
    const int ntiles = (hi - lo + KK - 1) / KK;
    auto stage_kv = [&](int tile) {
      float* ks = ring + (tile % M::kStages) * 2 * KK * D;
      const long long* ro = offs + tile % M::kStages * KK;
#pragma unroll
      for (int i = 0; i < KK * CH / kClusterThreads; ++i) {
        const int u = threadIdx.x + i * kClusterThreads, j = u / CH, c = (u % CH) * 4;
        const long long off = ro[j];
        const bool ok = off >= 0;
        attn_mma::cp_async16(ks + j * D + c, k + (ok ? off + c : 0), ok);
        attn_mma::cp_async16(ks + KK * D + j * D + c, v + (ok ? off + c : 0), ok);
      }
    };
#pragma unroll
    for (int g = 0; g < M::kStages; ++g) rows.resolve(offs, g, pages[g], hi);
    int page = pages[M::kStages];
    __syncthreads();
#pragma unroll
    for (int g = 0; g < M::kStages - 1; ++g) {
      if (g < ntiles) stage_kv(g);
      attn_mma::cp_async_commit();
    }

    // scores: lane (sg, ss) holds q rows 4 sg .. 4 sg + 3 over the dims
    // KW ss + 8 KW t + e, with plain loads while the first tiles are in
    // flight (any view with dense (Hq, D)); rows past nr are zero
    const int sg = lane / 8, ss = lane % 8;
    float qr[4][KT * KW];
    {
      const float* q = static_cast<const float*>(p.q) + b * p.q_sb;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rl = 4 * sg + r, rg = r0 + rl;
        const float* row = q + (long long)(rg / G) * p.q_sq + (long long)(h * G + rg % G) * D;
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < KW; ++e)
            qr[r][t * KW + e] = rl < nr ? row[KW * ss + 8 * KW * t + e] : 0.f;
      }
    }
    // softmax: half-warp lane / 16 takes row 2 warp + lane / 16, 4 keys a
    // lane; the row's limit (0 for a padding row)
    const int srw = 2 * warp + lane / 16, sk = 4 * (lane % 16);
    float m = kNegInf, l = 0.f;
    const int lim = srw < nr ? min(hi, base + (r0 + srw) / G + 1) : 0;
    // P V: lane (rh, dg) holds rows 8 rh .. 8 rh + 7 x dims VW dg + 16 VW t + e
    const int rh = lane / 16, dg = lane % 16;
    float acc[8][DV];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[r][j] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      attn_mma::cp_async_wait<M::kStages - 2>();     // tile it has landed
      __syncthreads();                               // ... for all; tile it - 1 is consumed
      if (it + M::kStages - 1 < ntiles) {
        stage_kv(it + M::kStages - 1);               // offsets resolved an iteration ago
        rows.resolve(offs, it + M::kStages, page, hi);
        page = rows.page_of(it + M::kStages + 1);
      }
      attn_mma::cp_async_commit();
      const float* ks = ring + (it % M::kStages) * 2 * KK * D + 8 * warp * D;
      const float* vs = ks + KK * D;
      float* st = sc + (it & 1) * kWarpRows * PR;
      const int t0 = lo + it * KK;

      {
        // x[r * 8 + j]: row 4 sg + r, key 8 warp + j, summed over this
        // lane's dims
        float x[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) x[r * 8 + j] = 0.f;
#pragma unroll
          for (int t = 0; t < KT; ++t) {
            float kv[KW];
            lds<KW>(kv, ks + j * D + KW * ss + 8 * KW * t);
#pragma unroll
            for (int e = 0; e < KW; ++e)
#pragma unroll
              for (int r = 0; r < 4; ++r) x[r * 8 + j] = fmaf(qr[r][t * KW + e], kv[e], x[r * 8 + j]);
          }
        }
        // reduce-scatter over the 8 lanes ss (bits 4, 2, 1): x[i] ends as
        // flat index 4 ss + i, row 4 sg + ss / 2, key 8 warp + 4 (ss % 2) + i
        reduce_scatter_step<16>(x, lane);
        reduce_scatter_step<8>(x, lane);
        reduce_scatter_step<4>(x, lane);
        *reinterpret_cast<float4*>(st + (4 * sg + ss / 2) * PR + 8 * warp + 4 * (ss % 2)) =
            make_float4(x[0] * p.scale, x[1] * p.scale, x[2] * p.scale, x[3] * p.scale);
      }
      __syncthreads();                               // the tile's scores are in

      {
        float* sp = st + srw * PR + sk;
        float x[4], pr[4];
        lds<4>(x, sp);
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t0 + sk + e < lim) mx = fmaxf(mx, x[e]);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m, mx);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pr[e] = t0 + sk + e < lim ? expf(x[e] - m_new) : 0.f;
          sum += pr[e];
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m - m_new);
        l = l * corr + sum;
        m = m_new;
        *reinterpret_cast<float4*>(sp) = make_float4(pr[0], pr[1], pr[2], pr[3]);
        if (sk == 0) corr_s[srw] = corr;
      }
      __syncthreads();                               // p and the rescale factors are in

      {
        float c[8];
        lds<4>(c, corr_s + 8 * rh);
        lds<4>(c + 4, corr_s + 8 * rh + 4);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < DV; ++j) acc[r][j] *= c[r];
        const float* pr = st + 8 * rh * PR + 8 * warp;
#pragma unroll
        for (int kc = 0; kc < 8; kc += 4) {
          float pp[8][4];
#pragma unroll
          for (int r = 0; r < 8; ++r) lds<4>(pp[r], pr + r * PR + kc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float vv[DV];
#pragma unroll
            for (int t = 0; t < DV / VW; ++t)
              lds<VW>(vv + t * VW, vs + (kc + kk) * D + VW * dg + 16 * VW * t);
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int j = 0; j < DV; ++j) acc[r][j] = fmaf(pp[r][kk], vv[j], acc[r][j]);
          }
        }
      }
    }
    attn_mma::cp_async_wait<0>();
    __syncthreads();                                 // the ring is free

    // the warps' partials (one softmax state, so a plain sum) in warp order
    float* red = ring + warp * kWarpRows * D + 8 * rh * D + VW * dg;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int t = 0; t < DV / VW; ++t) sts<VW>(red + r * D + 16 * VW * t, acc[r] + t * VW);
    using CS = ClusterState<D>;
    if (sk == 0) {
      CS::m(state)[srw] = m;
      CS::l(state)[srw] = l;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kWarpRows * D; e += kClusterThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kClusterThreads / 32; ++w) s += ring[w * kWarpRows * D + e];
      state[e] = s;
    }
  } else {
    ClusterState<D>::identity(state, nr);
  }
  cluster.sync();                                    // every CTA's state is complete
  float* out = static_cast<float*>(p.out);
  merge_cluster<float, D>(cluster, state, nr, [&](int r) {
    const int rg = r0 + r;
    return out + (((long long)b * p.Q + rg / G) * p.Hq + h * G + rg % G) * D;
  });
  cluster.sync();                                    // ... and read: now a CTA may exit
}

// Launch (or, with max_clusters, ask the occupancy and the dynamic shared
// memory of) a cluster kernel: grid (C, ny, B) in clusters of (C, 1, 1),
// C <= 8 (the portable limit), through cudaLaunchKernelEx; ny is Hkv for
// the single-stage decode, Hkv times the 16-row blocks for the mixed step.
// A cluster's CTAs run at once on the SMs of one GPC, so their shared
// memory must fit there together.
template <auto kKernel, int kBytes>
int launch_cluster(const RowsParams& p, int C, int ny, cudaStream_t stream, int* max_clusters) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);   // above 48 KB: opt in once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = C;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, ny, p.B);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) {
    max_clusters[1] = kBytes;
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kKernel, &cfg));
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kKernel, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int D>
int dispatch_cluster_f32(int G, const RowsParams& p, int C, cudaStream_t s, int* occ) {
  constexpr int bytes = F32Tile<D>::kBytes;
  if (G <= 1) return launch_cluster<cluster_f32_kernel<D, 1>, bytes>(p, C, p.Hkv, s, occ);
  return launch_cluster<cluster_f32_kernel<D, 2>, bytes>(p, C, p.Hkv, s, occ);
}

// dtype 0 = float32, 1 = bfloat16; G <= 16, 1 <= C <= 8.
int dispatch_cluster(int dtype, int D, const RowsParams& p, int C, cudaStream_t s, int* occ) {
  const int G = p.Hq / p.Hkv;
  if (C < 1 || C > 8 || G > attn_mma::kWarpRows) return -1;
  if (dtype == 1) {
    const int H = p.Hkv;
    switch (D) {
      case 32: return launch_cluster<cluster_mma_kernel<32>, ClusterMmaSmem<32>::kBytes>(p, C, H, s, occ);
      case 64: return launch_cluster<cluster_mma_kernel<64>, ClusterMmaSmem<64>::kBytes>(p, C, H, s, occ);
      case 80: return launch_cluster<cluster_mma_kernel<80>, ClusterMmaSmem<80>::kBytes>(p, C, H, s, occ);
      case 128:
        return launch_cluster<cluster_mma_kernel<128>, ClusterMmaSmem<128>::kBytes>(p, C, H, s, occ);
      default: return -1;
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return dispatch_cluster_f32<32>(G, p, C, s, occ);
      case 64: return dispatch_cluster_f32<64>(G, p, C, s, occ);
      case 80: return dispatch_cluster_f32<80>(G, p, C, s, occ);
      case 128: return dispatch_cluster_f32<128>(G, p, C, s, occ);
      default: return -1;
    }
  }
  return -1;
}

// The fp32 mixed step: grid (C, Hkv * ceil(Q * G / 16), B) in clusters of
// (C, 1, 1); G <= 16, 1 <= C <= 8.
int dispatch_mixed_f32(int D, const RowsParams& p, int C, cudaStream_t s, int* occ) {
  if (C < 1 || C > 8 || p.Hq / p.Hkv > attn_mma::kWarpRows) return -1;
  const int ny = p.Hkv * ((p.Q * (p.Hq / p.Hkv) + attn_mma::kWarpRows - 1) / attn_mma::kWarpRows);
  switch (D) {
    case 32: return launch_cluster<cluster_mixed_f32_kernel<32>, MixF32<32>::kBytes>(p, C, ny, s, occ);
    case 64: return launch_cluster<cluster_mixed_f32_kernel<64>, MixF32<64>::kBytes>(p, C, ny, s, occ);
    case 80: return launch_cluster<cluster_mixed_f32_kernel<80>, MixF32<80>::kBytes>(p, C, ny, s, occ);
    case 128:
      return launch_cluster<cluster_mixed_f32_kernel<128>, MixF32<128>::kBytes>(p, C, ny, s, occ);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  tbl: nullptr for a contiguous cache,
// else the (B, nb) int32 block tables with row stride tbl_sb and S = nb*ps.
// m_out, l_out, acc_out: the split-K partial states; with counters (at
// least B * Hkv * ceil(G / 8) int32, all 0) the split-K decode's merged
// output goes to out in the same launch, the states being its workspace.
// cluster: the single-stage decode's CTAs per (sequence, kv head), and the
// fp32 mixed step's per (sequence, kv head, 16-row block), 1-8 (kernel.py's
// cluster_split); the other calls ignore it.  Returns 0 on a
// launch cudaGetLastError accepted, the CUDA error code otherwise, -1 for
// an unsupported dtype/D/cluster.
extern "C" int flash_rows(int dtype, int D, const void* q, const void* k, const void* v,
                          const void* tbl, const void* lens, void* out, void* m_out,
                          void* l_out, void* acc_out, void* counters,
                          int B, int Q, int Hq, int Hkv, int S, int splits, int add, int ps,
                          long long q_sb, long long q_sq, long long k_sb, long long v_sb,
                          long long tbl_sb, float scale, int cluster, void* stream) {
  RowsParams p{q, k, v, static_cast<const int*>(tbl), static_cast<const int*>(lens), out,
               static_cast<float*>(m_out), static_cast<float*>(l_out),
               static_cast<float*>(acc_out), static_cast<int*>(counters),
               B, Q, Hq, Hkv, S, splits, add, q_sb, q_sq, k_sb, v_sb, tbl_sb, ps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the bf16 mixed step (contiguous or paged) runs on the tensor cores
  if (dtype == 1 && add == 1 && splits == 1 && m_out == nullptr)
    return dispatch_mixed_mma(D, p, s);
  // the fp32 mixed step (contiguous or paged): 16-row blocks, keys split over a cluster
  if (dtype == 0 && add == 1 && splits == 1 && m_out == nullptr && Hq / Hkv <= attn_mma::kWarpRows)
    return dispatch_mixed_f32(D, p, cluster, s, nullptr);
  // the bf16 split-K partial (contiguous or paged) too, for up to one m16 tile of rows
  if (dtype == 1 && add == 0 && Q == 1 && m_out != nullptr && Hq / Hkv <= attn_mma::kWarpRows)
    return dispatch_splitk_mma(D, p, s);
  // the single-stage decode (contiguous or paged, both dtypes): one cluster launch
  if (add == 0 && Q == 1 && splits == 1 && m_out == nullptr && Hq / Hkv <= attn_mma::kWarpRows)
    return dispatch_cluster(dtype, D, p, cluster, s, nullptr);
  if (dtype == 0) return dispatch_rows<float>(D, p, s);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(D, p, s);
  return -1;
}

// out[0]: how many clusters of C CTAs of the single-stage decode kernel
// for (dtype, D, G) can be resident on the card at once
// (cudaOccupancyMaxActiveClusters); out[1]: a CTA's dynamic shared memory
// in bytes.  Returns 0 on success, as flash_rows.
extern "C" int decode_cluster_occupancy(int dtype, int D, int G, int C, int* out) {
  RowsParams p{};
  p.B = 1;
  p.Q = 1;
  p.Hkv = 1;
  p.Hq = G;
  out[0] = out[1] = 0;
  return dispatch_cluster(dtype, D, p, C, nullptr, out);
}

// As decode_cluster_occupancy, for the fp32 mixed step's cluster kernel at
// head dim D (one 16-row block).
extern "C" int mixed_cluster_occupancy(int D, int C, int* out) {
  RowsParams p{};
  p.B = 1;
  p.Q = 1;
  p.Hkv = 1;
  p.Hq = 1;
  p.add = 1;
  out[0] = out[1] = 0;
  return dispatch_mixed_f32(D, p, C, nullptr, out);
}
