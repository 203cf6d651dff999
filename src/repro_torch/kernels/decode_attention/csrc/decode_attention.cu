// Flash-decoding attention kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of repro/kernels/decode_attention/kernel.py:
//   * decode_attention_pallas  (_decode_kernel)          -> flash_rows, Q=1, add=0, splits=1
//   * decode_attention_splitk  (_splitk_partial_kernel)  -> flash_rows, Q=1, add=0, splits=K,
//                                                           partial state out:
//                                                           splitk_mma_kernel in bf16 (G <= 16),
//                                                           flash_rows_kernel otherwise
//                              (_splitk_combine_kernel)  -> splitk_combine
//   * mixed_attention_pallas   (_mixed_kernel)           -> flash_rows, add=1, splits=1:
//                                                           mixed_mma_kernel in bf16,
//                                                           flash_rows_kernel in fp32
//   * decode_attention_paged   (_paged_decode_kernel)    -> flash_rows, tbl, Q=1, add=0, splits=1
//   * decode_attention_paged_splitk
//                              (_paged_splitk_partial_kernel) -> flash_rows, tbl, Q=1, add=0,
//                                                           splits=K, partial state out:
//                                                           splitk_mma_kernel in bf16 (G <= 16),
//                                                           flash_rows_kernel otherwise
//                              (combine: the same splitk_combine)
//   * mixed_attention_paged    (_mixed_paged_kernel)     -> flash_rows, tbl, add=1, splits=1:
//                                                           mixed_mma_kernel in bf16,
//                                                           flash_rows_kernel in fp32
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
// fp32 CUDA-core math, far over a bytes bound; it serves fp32, the
// single-stage decode and split-K groups of more than 16 heads.  The bf16
// mixed step and the bf16 split-K partial run on the tensor cores
// (mixed_mma_kernel and splitk_mma_kernel, below).
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
// which writes the chunk's unnormalised state for splitk_combine.  The
// chunk's keys [c * ck, min((c + 1) * ck, lens[b])) are the tile's row
// interval; K/V come through the mixed kernel's cp.async ring with its row
// offsets (zero-fill past the length; shifts or division for the page).  A
// chunk wholly past the length writes the identity state and exits before
// any copy: at phase 6's lengths, 42 of each head's 64 chunks.  Q arrives
// with plain loads while the first tile is in flight, so q may be any view
// with dense heads (the decode step's q[:, 0] of the projection).  Ring:
// 2 stages (shared memory 145,664 bytes at D = 128, 94,976 at D = 80,
// 78,080 at D = 64, 44,288 at D = 32).  A third stage took the same time
// at D = 128 (one CTA per SM either way) and 12% longer at D = 80, where
// it leaves one CTA per SM instead of two.  ptxas (sm_90a): 173
// registers per thread at D = 128, 120 at D = 80, 114 at D = 64, 57 at
// D = 32, no spills.  NVIDIA H100 80GB HBM3, 700.00 W, phase 6's shapes,
// queued and warm (attention_timing.py): 0.0208 ms at D = 128 (1.8x its
// bound; the pair 0.0251 against SDPA's 0.0610), 0.0443 at D = 80 (1.5x),
// 0.0205 paged.
//
// Numerics match the TPU kernels: fp32 scores and softmax state, masking
// with -1e30 (not -inf: a fully masked row stays finite), p rounded to V's
// dtype before the PV product, output divided by max(l, 1e-30).  A split
// chunk wholly past the length emits the identity state (m=-1e30, l=0,
// acc=0), which the combine's rescale zeroes.
//
// Every entry point returns cudaGetLastError() after its launch (or -1 for
// an unsupported dtype/head_dim), so a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_mma.cuh"

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
  int B, Q, Hq, Hkv, S, splits, add;
  long long q_sb, q_sq, k_sb, v_sb, tbl_sb;
  int ps;             // page size (paged only)
  float scale;
};

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

// Merge K partial (m, l, acc) states of one (b, kv head) with the
// log-sum-exp rescale.  Grid (B * Hkv); reads K*G*(D+2) fp32 per CTA.
template <typename T>
__global__ void splitk_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                                      const float* __restrict__ acc, T* __restrict__ out,
                                      int G, int K, int D) {
  const long long bh = blockIdx.x;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float m_star = kNegInf;
    for (int kc = 0; kc < K; ++kc) m_star = fmaxf(m_star, m[(bh * K + kc) * G + g]);
    float l_star = 0.f, o = 0.f;
    for (int kc = 0; kc < K; ++kc) {
      const long long cell = (bh * K + kc) * G + g;
      const float alpha = expf(m[cell] - m_star);
      l_star += l[cell] * alpha;
      o += acc[cell * D + d] * alpha;
    }
    out[(bh * G + g) * D + d] = from_f<T>(o / fmaxf(l_star, 1e-30f));
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

// One CTA per (kv head h, sequence b, chunk c): the G query rows of head
// group h (padded with zero rows to one m16 tile) over keys [c * ck,
// min((c + 1) * ck, lens[b])), ck = S / splits; the 8 warps take 16 keys
// each of every staged 128-key tile.  Writes the chunk's unnormalised
// (m, l, acc) to the (B, Hkv, splits, G[, D]) partials.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) splitk_mma_kernel(RowsParams p) {
  using namespace attn_mma;
  using Smem = SplitSmem<D>;
  constexpr int SR = Tile<D>::kStride;
  constexpr int TS = kMmaKeys * SR;              // one K or V tile, in bf16
  constexpr int C = Tile<D>::kChunks;
  constexpr int U = kMmaKeys * C / kMmaThreads;  // 16-byte K (and V) copies per thread
  static_assert(U * kMmaThreads == kMmaKeys * C, "a tile splits evenly over the threads");
  extern __shared__ uint4 smem_split[];
  bf16* qs = reinterpret_cast<bf16*>(smem_split);  // [kWarpRows][stride]
  bf16* ring = qs + Smem::kQ;                      // [kSplitStages][K, V][kMmaKeys][stride]

  const int G = p.Hq / p.Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y / p.splits, c = blockIdx.y % p.splits;
  const int ck = p.S / p.splits;
  const int lo = c * ck;
  const int* tbl = p.tbl != nullptr ? p.tbl + (long long)b * p.tbl_sb : nullptr;

  // Key rows resolve as in mixed_mma_kernel: thread j < kMmaKeys writes the
  // offset of key lo + tile * kMmaKeys + j into a shared ring a stage ahead
  // of the copies, from a table entry read a further tile ahead (shifts for
  // a power-of-two page size, division otherwise); -1 marks a key at or
  // past hi, zero-filled.  A chunk is whole pages, so any entry below its
  // end may be read; the first tiles' entries are read before the length
  // is known, so that load and the length's overlap.
  const bool pow2 = (p.ps & (p.ps - 1)) == 0;
  const int shift = __ffs(p.ps) - 1;
  auto page_of = [&](int tile) {
    const int pos = lo + tile * kMmaKeys + threadIdx.x;
    return tbl != nullptr && threadIdx.x < kMmaKeys && pos < lo + ck
        ? tbl[pow2 ? pos >> shift : pos / p.ps] : 0;
  };
  int pages[kSplitStages + 1];
#pragma unroll
  for (int g = 0; g <= kSplitStages; ++g) pages[g] = page_of(g);

  const int hi = min(lo + ck, min(p.S, p.lens[b]));
  const long long cell = ((long long)(b * p.Hkv + h) * p.splits + c) * G;
  if (hi <= lo) {                                // wholly past the length: the identity
    for (int e = threadIdx.x; e < G * D; e += kMmaThreads) p.acc_out[cell * D + e] = 0.f;
    if (threadIdx.x < G) {
      p.m_out[cell + threadIdx.x] = attn_mma::kNegInf;
      p.l_out[cell + threadIdx.x] = 0.f;
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int koff = warp * (kMmaKeys / 8);
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)h * D;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)h * D;
  const long long kv_row = (long long)p.Hkv * D;  // elements between key rows
  const int ntiles = (hi - lo + kMmaKeys - 1) / kMmaKeys;

  long long* offs = reinterpret_cast<long long*>(
      reinterpret_cast<char*>(smem_split) + Smem::kOffs);   // [kSplitStages][kMmaKeys]
  auto resolve = [&](int tile, int page) {
    const int pos = lo + tile * kMmaKeys + threadIdx.x;
    if (threadIdx.x >= kMmaKeys) return;
    long long row = pos;                         // contiguous: the key's own row
    if (tbl != nullptr)
      row = pow2 ? ((long long)page << shift) + (pos & (p.ps - 1))
                 : (long long)page * p.ps + pos % p.ps;
    offs[tile % kSplitStages * kMmaKeys + threadIdx.x] = pos < hi ? row * kv_row : -1;
  };
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
  for (int g = 0; g < kSplitStages; ++g) resolve(g, pages[g]);
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

  WarpTile<D> t;
  t.init(lo, hi, lo, hi);
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kSplitStages - 2>();           // tile it has landed
    __syncthreads();                             // ... for all; tile it - 1 is consumed
    if (it == 0) t.load_q(qs);
    if (it + kSplitStages - 1 < ntiles) {
      stage_kv(it + kSplitStages - 1);           // offsets resolved an iteration ago
      resolve(it + kSplitStages, page);          // into the slot tile it's copies read
      page = page_of(it + kSplitStages + 1);
    }
    cp_async_commit();
    const bf16* ks = ring + (it % kSplitStages) * 2 * TS + koff * SR;
    t.template step<kMmaKeys / 8>(ks, ks + TS, lo + it * kMmaKeys + koff, p.scale);
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free for the epilogue

  finish_partial<D, kMmaThreads>(t, reinterpret_cast<float*>(ring), G, p.m_out + cell,
                                 p.l_out + cell, p.acc_out + cell * D);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  tbl: nullptr for a contiguous cache,
// else the (B, nb) int32 block tables with row stride tbl_sb and S = nb*ps.
// Returns 0 on a launch cudaGetLastError accepted, the CUDA error code
// otherwise, -1 for an unsupported dtype/D.
extern "C" int flash_rows(int dtype, int D, const void* q, const void* k, const void* v,
                          const void* tbl, const void* lens, void* out, void* m_out,
                          void* l_out, void* acc_out,
                          int B, int Q, int Hq, int Hkv, int S, int splits, int add, int ps,
                          long long q_sb, long long q_sq, long long k_sb, long long v_sb,
                          long long tbl_sb, float scale, void* stream) {
  RowsParams p{q, k, v, static_cast<const int*>(tbl), static_cast<const int*>(lens), out,
               static_cast<float*>(m_out), static_cast<float*>(l_out),
               static_cast<float*>(acc_out),
               B, Q, Hq, Hkv, S, splits, add, q_sb, q_sq, k_sb, v_sb, tbl_sb, ps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the bf16 mixed step (contiguous or paged) runs on the tensor cores
  if (dtype == 1 && add == 1 && splits == 1 && m_out == nullptr)
    return dispatch_mixed_mma(D, p, s);
  // the bf16 split-K partial (contiguous or paged) too, for up to one m16 tile of rows
  if (dtype == 1 && add == 0 && Q == 1 && m_out != nullptr && Hq / Hkv <= attn_mma::kWarpRows)
    return dispatch_splitk_mma(D, p, s);
  if (dtype == 0) return dispatch_rows<float>(D, p, s);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(D, p, s);
  return -1;
}

extern "C" int splitk_combine(int dtype, const void* m, const void* l, const void* acc, void* out,
                              int B, int Hkv, int G, int K, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* af = static_cast<const float*>(acc);
  const int threads = 256;
  if (dtype == 0) {
    splitk_combine_kernel<float><<<B * Hkv, threads, 0, s>>>(
        mf, lf, af, static_cast<float*>(out), G, K, D);
  } else if (dtype == 1) {
    splitk_combine_kernel<__nv_bfloat16><<<B * Hkv, threads, 0, s>>>(
        mf, lf, af, static_cast<__nv_bfloat16*>(out), G, K, D);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
