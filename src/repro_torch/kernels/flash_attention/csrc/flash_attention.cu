// GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (_flash_kernel): the prefill attention of
// Model.prefill.  q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with Hkv | Hq;
// query head h reads kv head h / G; query i sits at position i + Sk - Sq
// (right-aligned) and sees key j when j <= q_pos (causal) and
// j > q_pos - window (window > 0).  Two kernels: flash_fwd_mma_kernel for
// bf16 (tensor cores), flash_fwd_kernel for fp32 (CUDA cores).
//
// What bounds it: operations.  A causal prefill of S tokens does
// 4 * D * Hq * S * (S + 1) / 2 flops over 2 * S * (Hq + Hkv) * D elements
// of q, k, v and out: at the main-path shape of qwen3-0.6b (S = 2000,
// Hq = 16, Hkv = 8, D = 128, bf16) 16.4 GFLOP against 24.6 MB, about 670
// flops per byte, far above the ~295 where the H100 stops being
// bandwidth-bound.  Its least time is 0.0166 ms at the 989 TFLOP/s of the
// bf16 tensor cores; CUDA-core fp32 FMAs top out at 67 TFLOP/s.
//
// The TPU grid walked (B*Hkv, Sq/bq, Sk/bk) in order and carried the
// online-softmax state (m, l, acc) in VMEM scratch across the KV grid axis.
// Here one CTA owns a (query tile, kv head, batch) cell: kRows = 64 rows,
// each a (query, head) pair of the GQA group -- bq = 64 / G query positions
// times the G heads that share kv head h, the JAX (G*bq, D) group -- and
// loops over key tiles itself, so each KV tile it loads serves all 64
// rows.  Tiles wholly above the diagonal or wholly below the window are
// never visited; the ragged tail (key >= Sk, query >= Sq) is masked per
// element, so no S % tile constraint exists.
//
// bf16: flash_fwd_mma_kernel.  The QK^T and PV products run on the tensor
// cores (mma.sync m16n8k16, fp32 accumulate) through the warp tile of
// include/attention_mma.cuh: 4 warps of 16 rows each, Q held in registers
// as A-fragments, 64-key K/V tiles in a 2-stage cp.async ring shared by the
// 4 warps (the next tile loads while this one is computed), keys at or past
// the CTA's limit zero-filled.  A warp skips a tile its 16 rows all mask.
// The 1-D grid puts the query tile slowest and walks it backwards, so the
// longest causal rows start first and the triangle leaves no tail of long
// CTAs.  Shared memory (Q + ring): 87,040 bytes at D = 128, 56,320 at D =
// 80, 46,080 at D = 64.  ptxas (sm_90a, CUDA 12.9): 237 registers per
// thread at D = 128, 193 at D = 80, 167 at D = 64, no spills, so 2 CTAs
// (8 warps) per SM at D = 128 and 80, held there by registers, 3 at D = 64.
//
// fp32: flash_fwd_kernel keeps the CUDA-core design (TF32 would break the
// fp32 parity contract): 32-key fp32 tiles in shared memory,
// 256 threads as 16 row groups of 4 rows x 16 lanes; in the score product a
// thread owns 4 rows x 2 keys, in the PV product the same 4 rows x D/16
// columns, so m, l and the accumulator stay in its registers.  Row maxima
// and sums reduce over the 16 lanes of a group with warp shuffles; p goes
// through shared memory transposed (key-major), read as one 16-byte
// broadcast per key; shared rows are padded by 4 floats.  At D = 80 the PV
// product's second 64-column chunk has 16 columns, lanes 0-3's.
//
// Numerics match the TPU kernel in both: fp32 scores and softmax state,
// masking with -1e30 (not -inf: with a window, a row's first tile can be
// wholly masked; then p = exp(0) = 1 on masked keys until a later tile's
// correction exp(m_prev - m_new) = 0 zeroes it, where -inf would give NaN),
// l summed from the unrounded p, p rounded to V's dtype before the PV
// product, the output divided by max(l, 1e-30) in q's dtype.
//
// Head dims 64, 80 and 128.  The entry point returns cudaGetLastError()
// after its launch (or -1 for an unsupported dtype, head_dim or group
// size), so a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;            // 8 warps = 16 row groups x 16 lanes
constexpr int kRows = 64;                // (query, head) rows per CTA
constexpr int kTile = 32;                // keys per tile
constexpr int kLanes = 16;               // threads sharing one row group
constexpr int kRowsPer = 4;              // rows per thread
constexpr int kKeysPer = kTile / kLanes; // score columns per thread
constexpr int kPad = 4;                  // floats of padding per shared row
static_assert(kThreads / kLanes * kRowsPer == kRows, "row groups must cover the rows");

// One 16-byte pack of q, k or v (or zeros) into shared memory at dst.
__device__ __forceinline__ void stage_pack(const float* src, bool ok, float* dst) {
  *reinterpret_cast<float4*>(dst) =
      ok ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

struct FlashParams {
  const void* q;      // (B, Sq, Hq, D): batch/seq strides q_sb, q_ss; heads dense
  const void* k;      // (B, Sk, Hkv, D): strides k_sb, k_ss; heads dense
  const void* v;      // (B, Sk, Hkv, D): strides v_sb, v_ss; heads dense
  void* out;          // (B, Sq, Hq, D) contiguous
  int B, Sq, Sk, Hq, Hkv, G, bq, causal, window;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
  float scale;
};

template <int D> struct Smem {
  static constexpr int kS = D + kPad;          // row stride of q, k, v tiles
  static constexpr int kPS = kRows + kPad;     // row stride of the p tile
  static constexpr int kFloats = kRows * kS + 2 * kTile * kS + kTile * kPS;
  static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(FlashParams p) {
  constexpr int kS = Smem<D>::kS, kPS = Smem<D>::kPS;
  constexpr int kC = (D + 63) / 64;            // 4-column chunks per thread in PV
  // D = 80: the second chunk holds 16 columns, those of lanes 0-3 (the
  // predicate folds away where 64 divides D)
  auto col_ok = [](int c, int ln) { return D % 64 == 0 || c * 64 + ln * 4 < D; };
  constexpr int kPacks = D / 4;                // 16-byte packs per row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4); // [kRows][kS]
  float* ks = qs + kRows * kS;                 // [kTile][kS]
  float* vs = ks + kTile * kS;                 // [kTile][kS]
  float* pt = vs + kTile * kS;                 // [kTile][kPS]: p, key-major

  const int G = p.G;
  const int q0 = blockIdx.x * p.bq;            // first query of this CTA
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = min(p.bq, p.Sq - q0);         // live queries
  const int live = nq * G;                     // rows r < live are real
  const int off = p.Sk - p.Sq;                 // right alignment of queries
  const int tid = threadIdx.x;
  const int rg = tid / kLanes, lane = tid % kLanes;
  const int r0 = rg * kRowsPer;                // this thread's first row

  const float* __restrict__ q = static_cast<const float*>(p.q) + b * p.q_sb;
  const float* __restrict__ k = static_cast<const float*>(p.k) + b * p.k_sb + (long long)h * D;
  const float* __restrict__ v = static_cast<const float*>(p.v) + b * p.v_sb + (long long)h * D;

  // row r is query q0 + r / G of head h * G + r % G
  for (int u = tid; u < kRows * kPacks; u += kThreads) {
    const int r = u / kPacks, d0 = (u % kPacks) * 4;
    const float* src = q + (long long)(q0 + r / G) * p.q_ss + (long long)(h * G + r % G) * D + d0;
    stage_pack(src, r < live, qs + r * kS + d0);
  }

  int qpos[kRowsPer];
  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kC * 4];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    qpos[i] = q0 + (r0 + i) / G + off;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC * 4; ++c) acc[i][c] = 0.f;
  }

  // keys any live row can see: tiles past the last query's diagonal, or
  // wholly below the first query's window, are skipped
  int lo = 0, hi = p.Sk;
  if (p.causal) hi = min(hi, q0 + nq - 1 + off + 1);
  if (p.window > 0) lo = max(0, q0 + off - p.window + 1);
  lo -= lo % kTile;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();                           // the previous tile is consumed
    for (int u = tid; u < kTile * kPacks; u += kThreads) {
      const int j = u / kPacks, d0 = (u % kPacks) * 4, pos = t0 + j;
      const bool ok = pos < p.Sk;
      stage_pack(k + pos * p.k_ss + d0, ok, ks + j * kS + d0);
      stage_pack(v + pos * p.v_ss + d0, ok, vs + j * kS + d0);
    }
    __syncthreads();

    // scores: rows r0..r0+3 against keys lane + 16 * j
    float s[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRowsPer], kv[kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * kS + d);
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (lane + kLanes * j) * kS + d);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          s[i][j] = fmaf(qv[i].w, kv[j].w, x);
        }
    }

    // online softmax per row, reduced over the 16 lanes of the row group
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const int pos = t0 + lane + kLanes * j;
        const bool vis = pos < p.Sk && (!p.causal || pos <= qpos[i]) &&
                         (p.window <= 0 || pos > qpos[i] - p.window);
        s[i][j] = vis ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const float pr = expf(s[i][j] - m_new);
        sum += pr;
        s[i][j] = pr;                          // V's dtype is fp32: no rounding
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC * 4; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKeysPer; ++j)
      *reinterpret_cast<float4*>(pt + (lane + kLanes * j) * kPS + r0) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[r0..r0+3][c * 64 + lane * 4 ..] += p . V
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + j * kPS + r0);
      const float pr[kRowsPer] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (!col_ok(c, lane)) continue;
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * kS + c * 64 + lane * 4);
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          acc[i][c * 4 + 0] = fmaf(pr[i], vv.x, acc[i][c * 4 + 0]);
          acc[i][c * 4 + 1] = fmaf(pr[i], vv.y, acc[i][c * 4 + 1]);
          acc[i][c * 4 + 2] = fmaf(pr[i], vv.z, acc[i][c * 4 + 2]);
          acc[i][c * 4 + 3] = fmaf(pr[i], vv.w, acc[i][c * 4 + 3]);
        }
      }
    }
  }

  float* __restrict__ out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = r0 + i;
    if (r >= live) continue;
    const int qi = r / G, g = r % G;
    float* o = out + (((long long)b * p.Sq + q0 + qi) * p.Hq + h * G + g) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (!col_ok(c, lane)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c * 64 + lane * 4 + e] = acc[i][c * 4 + e] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;         // 4 warps x 16 rows = kRows
constexpr int kKeys = 64;                // keys per staged K/V tile
constexpr int kStages = 2;               // K/V ring depth
static_assert(kMmaThreads / 32 * attn_mma::kWarpRows == kRows, "warps must cover the rows");

template <int D> struct MmaSmem {
  using Tile = attn_mma::Tile<D>;
  static constexpr int kQ = kRows * Tile::kStride;                    // bf16 elements
  static constexpr int kRing = kStages * 2 * kKeys * Tile::kStride;
  static constexpr int kBytes = (kQ + kRing) * 2;
  static_assert(kMmaThreads / 32 * attn_mma::Reduce<D>::kFloats * 4 <= kRing * 2,
                "the epilogue's floats fit in the ring");
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_fwd_mma_kernel(FlashParams p) {
  using namespace attn_mma;
  constexpr int TS = kKeys * Tile<D>::kStride;   // one K or V tile, in bf16
  extern __shared__ uint4 smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [kRows][stride]
  bf16* ring = qs + MmaSmem<D>::kQ;              // [kStages][K, V][kKeys][stride]

  // the query tile is the slowest index of the 1-D grid, walked backwards:
  // the heaviest causal tiles launch first
  const int cells = p.Hkv * p.B;
  const int qt = gridDim.x / cells - 1 - blockIdx.x / cells;
  const int h = blockIdx.x % cells % p.Hkv, b = blockIdx.x % cells / p.Hkv;
  const int G = p.G;
  const int q0 = qt * p.bq;
  const int nq = min(p.bq, p.Sq - q0);
  const int live = nq * G;                       // rows r < live are real
  const int off = p.Sk - p.Sq;                   // right alignment of queries
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)h * D;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)h * D;

  // row r is query q0 + r / G of head h * G + r % G
  stage_rows<D, kMmaThreads, kRows>(qs, q, [&](int r) -> const bf16* {
    return r < live ? q + (long long)(q0 + r / G) * p.q_ss + (long long)(h * G + r % G) * D
                    : nullptr;
  });

  // keys row r may see: [lo_r, hi_r); padding rows take the last live row's
  auto lo_of = [&](int r) {
    return p.window > 0 ? q0 + min(r, live - 1) / G + off - p.window + 1 : 0;
  };
  auto hi_of = [&](int r) {
    return p.causal ? min(p.Sk, q0 + min(r, live - 1) / G + off + 1) : p.Sk;
  };
  const int r0 = warp * kWarpRows + lane / 4;
  WarpTile<D> t;
  t.init(lo_of(r0), hi_of(r0), lo_of(r0 + 8), hi_of(r0 + 8));

  // keys any live row can see: tiles past the last query's diagonal, or
  // wholly below the first query's window, are skipped
  int lo = 0, hi = p.Sk;
  if (p.causal) hi = min(hi, q0 + nq - 1 + off + 1);
  if (p.window > 0) lo = max(0, q0 + off - p.window + 1);
  lo -= lo % kKeys;
  const int ntiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;

  auto stage_kv = [&](int tile) {
    const int t0 = lo + tile * kKeys;
    bf16* ks = ring + (tile % kStages) * 2 * TS;
    stage_rows<D, kMmaThreads, kKeys>(ks, k, [&](int j) -> const bf16* {
      return t0 + j < hi ? k + (long long)(t0 + j) * p.k_ss : nullptr;
    });
    stage_rows<D, kMmaThreads, kKeys>(ks + TS, v, [&](int j) -> const bf16* {
      return t0 + j < hi ? v + (long long)(t0 + j) * p.v_ss : nullptr;
    });
  };
  // group g holds tile g (group 0 also Q); empty groups keep the count uniform
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < ntiles) stage_kv(g);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();                // tile it has landed
    __syncthreads();                             // ... for all; tile it - 1 is consumed
    if (it == 0) t.load_q(qs + warp * kWarpRows * Tile<D>::kStride);
    if (it + kStages - 1 < ntiles) stage_kv(it + kStages - 1);
    cp_async_commit();
    const bf16* ks = ring + (it % kStages) * 2 * TS;
    t.template step<kKeys>(ks, ks + TS, lo + it * kKeys, p.scale);
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free for the epilogue

  bf16* out = static_cast<bf16*>(p.out);
  finish_rows<D, kMmaThreads>(t, reinterpret_cast<float*>(ring), 1, warp * kWarpRows, live,
                              [&](int r) {
    return out + (((long long)b * p.Sq + q0 + r / G) * p.Hq + h * G + r % G) * D;
  });
}

template <int D>
int launch_mma(const FlashParams& p, cudaStream_t stream) {
  constexpr int bytes = MmaSmem<D>::kBytes;      // above 48 KB: opt in once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nqt = (p.Sq + p.bq - 1) / p.bq;
  flash_fwd_mma_kernel<D><<<nqt * p.Hkv * p.B, kMmaThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------

template <int D>
int launch(int dtype, const FlashParams& p, cudaStream_t stream) {
  if (dtype == 1) return launch_mma<D>(p, stream);
  constexpr int bytes = Smem<D>::kBytes;         // above 48 KB at D = 128: opt in once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.Sq + p.bq - 1) / p.bq, p.Hkv, p.B);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  causal: 0 or 1; window: 0 = none.
// Returns 0 on a launch cudaGetLastError accepted, the CUDA error code
// otherwise, -1 for an unsupported dtype, D or a group wider than 64 rows.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq, int Sk, int Hq,
                                   int Hkv, int causal, int window, long long q_sb,
                                   long long q_ss, long long k_sb, long long k_ss,
                                   long long v_sb, long long v_ss, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRows) return -1;
  const int G = Hq / Hkv;
  FlashParams p{q, k, v, out, B, Sq, Sk, Hq, Hkv, G, kRows / G, causal, window,
                q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale};
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(dtype, p, s);
    case 80: return launch<80>(dtype, p, s);
    case 128: return launch<128>(dtype, p, s);
    default: return -1;
  }
}
