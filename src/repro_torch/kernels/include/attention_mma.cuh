// A warp-level bf16 attention tile for Hopper's tensor cores (sm_90a),
// shared by the flash-attention forward (flash_attention.cu) and the
// mixed-step q-chunk kernel (decode_attention.cu).
//
// One warp owns 16 (query, head) rows.  Its Q rows are held as the
// A-fragments of mma.sync.m16n8k16 (bf16 in, fp32 accumulate), loaded once
// with ldmatrix.  The kernels stage K and V as bf16 tiles (never converted
// to fp32) in a ring of shared-memory stages with 16-byte cp.async.cg
// copies (cp_async16, stage_rows), each key row from wherever the kernel
// finds it (a sequence stride, or a page through a block table); a row at
// or past the block's key limit is zero-filled through cp.async's src-size
// operand, never skipped: a masked p is 0, but 0 * NaN is NaN, and a
// pool's trash page or a stale cache tail may hold anything.
//
// Per K/V slice the warp computes S = Q K^T with mma.sync (K's B-fragments
// by ldmatrix on the row-major tile), scales it, masks with -1e30 (never
// -inf) only where the slice crosses a row's [lo, hi) key interval, and
// runs the online softmax in the accumulator layout: a thread holds 2 rows
// x 2 keys of each n8 tile, and the row max reduces over the 4-lane quad
// with 2 shuffles.  l is summed from the unrounded p (per thread; the quad
// sum is taken once at the end).  p is rounded to bf16 and packed straight
// into the A-fragments of the P V mma.sync -- two adjacent m16n8 C tiles
// are one m16n8k16 A tile -- which is the TPU kernel's "p in V's dtype
// before the PV product".  V's B-fragments come from ldmatrix.trans.  The
// accumulator stays in registers: D/8 n-tiles x 4 fp32.
//
// Shared rows are D + 8 bf16 long: an odd number of 16-byte chunks (D/8 +
// 1 for every D here, 80 included), so the 8 row addresses of each
// ldmatrix phase fall in 8 distinct bank groups.
//
// The epilogue (finish_rows) goes through shared memory: each warp writes
// its unnormalised fp32 (acc, m, l); the warps that shared the rows (a key
// split) are merged with the log-sum-exp rescale; the result is divided by
// max(l, 1e-30), rounded to bf16 and stored 16 bytes at a time; padding
// rows are never stored.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kWarpRows = 16;            // (query, head) rows per warp

// Row stride, in bf16, of every shared tile of head dim D.
template <int D> struct Tile {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16 (the mma k depth)");
  static constexpr int kStride = D + 8;
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false, 16 zero bytes (src-size 0:
// nothing is read, src only has to be some global address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stage kRowsN rows of D bf16 into dst (row stride Tile<D>::kStride) with
// 16-byte cp.async copies spread over kThreads threads, a fixed number per
// thread; src(j) is row j's first element in global memory, or nullptr to
// zero-fill the row (base, any global address, stands in for it).
template <int D, int kThreads, int kRowsN, class Src>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base, Src src) {
  constexpr int C = Tile<D>::kChunks;
  constexpr int kUnits = kRowsN * C;
#pragma unroll
  for (int i = 0; i < (kUnits + kThreads - 1) / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads, j = u / C, c = u % C;
    if (kUnits % kThreads != 0 && u >= kUnits) break;
    const bf16* s = src(j);
    cp_async16(dst + j * Tile<D>::kStride + c * 8, s != nullptr ? s + c * 8 : base, s != nullptr);
  }
}

// The online-softmax state of one warp's 16 rows.  A thread holds rows
// lane/4 (half 0) and lane/4 + 8 (half 1) of the warp's tile; key
// interval [lo[h], hi[h]) is what each may see.
template <int D>
struct WarpTile {
  uint32_t q[D / 16][4];   // A-fragments of Q, one per 16-dim k step
  float acc[D / 8][4];     // fp32 P V accumulator, one m16n8 tile per 8 dims
  float m[2], l[2];        // running max; this thread's partial sum of p
  int lo[2], hi[2];
  int lo_min, lo_max, hi_min, hi_max;  // over the warp's 16 rows

  __device__ __forceinline__ void init(int lo0, int hi0, int lo1, int hi1) {
    lo[0] = lo0; hi[0] = hi0; lo[1] = lo1; hi[1] = hi1;
    int a = min(lo0, lo1), b = max(lo0, lo1), c = min(hi0, hi1), d = max(hi0, hi1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = min(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = max(b, __shfl_xor_sync(0xffffffffu, b, o));
      c = min(c, __shfl_xor_sync(0xffffffffu, c, o));
      d = max(d, __shfl_xor_sync(0xffffffffu, d, o));
    }
    lo_min = a; lo_max = b; hi_min = c; hi_max = d;
#pragma unroll
    for (int h = 0; h < 2; ++h) { m[h] = kNegInf; l[h] = 0.f; }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  // Q's 16 rows from shared memory (row stride Tile<D>::kStride).
  __device__ __forceinline__ void load_q(const bf16* qs) {
    const int lane = threadIdx.x % 32, mi = lane / 8;
    const bf16* row = qs + ((mi & 1) * 8 + lane % 8) * Tile<D>::kStride + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(q[kk], row + kk * 16);
  }

  // Keys [k0, k0 + NK) from ks/vs (their first row; stride Tile<D>::kStride).
  template <int NK>
  __device__ __forceinline__ void step(const bf16* ks, const bf16* vs, int k0, float scale) {
    static_assert(NK % 16 == 0, "a slice is whole 16-key mma steps");
    // every row masks the whole slice: skipping it is exact (a masked p is
    // 0 once a row has seen a key; before that it is undone by the rescale)
    if (k0 >= hi_max || k0 + NK <= lo_min) return;
    const bool full = k0 >= lo_max && k0 + NK <= hi_min;
    const int lane = threadIdx.x % 32, mi = lane / 8;

    float s[NK / 8][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* krow = ks + ((mi >> 1) * 8 + lane % 8) * Tile<D>::kStride + (mi & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < NK / 16; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, krow + jp * 16 * Tile<D>::kStride + kk * 16);
        mma_bf16(s[2 * jp], q[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], q[kk], b[2], b[3]);
      }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
        float x = s[j][e] * scale;
        if (!full && (key < lo[h] || key >= hi[h])) x = kNegInf;
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = __expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }

    const bf16* vrow = vs + ((mi & 1) * 8 + lane % 8) * Tile<D>::kStride + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + kk * 16 * Tile<D>::kStride + dp * 16);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
};

// Shared floats the epilogue needs for `warps` warps.
template <int D> struct Reduce {
  static constexpr int kStride = D + 4;
  static constexpr int kFloats = kWarpRows * kStride + 2 * kWarpRows;  // per warp
};

// The epilogue.  Every warp of the CTA calls it with its tile; the caller
// has drained cp.async and synchronised, so `red` may alias the K/V ring.
// Warps w and w' with w / split == w' / split hold the same 16 rows over
// disjoint keys and are merged; rows at or past `live` (counted from the
// first row of the group's tile, `row0`) are not stored.  out_row(r) is
// output row r's first element.
template <int D, int kThreads, class OutRow>
__device__ __forceinline__ void finish_rows(const WarpTile<D>& t, float* red, int split,
                                            int row0, int live, OutRow out_row) {
  constexpr int RS = Reduce<D>::kStride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mine = red + warp * Reduce<D>::kFloats;
  const int r = lane / 4, c = (lane % 4) * 2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(mine + r * RS + n * 8 + c) = make_float2(t.acc[n][0], t.acc[n][1]);
    *reinterpret_cast<float2*>(mine + (r + 8) * RS + n * 8 + c) =
        make_float2(t.acc[n][2], t.acc[n][3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = t.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (lane % 4 == 0) {
      mine[kWarpRows * RS + r + 8 * h] = t.m[h];
      mine[kWarpRows * RS + kWarpRows + r + 8 * h] = l;
    }
  }
  __syncthreads();

  const int first = warp / split * split;      // the group's first warp
  const float* grp = red + first * Reduce<D>::kFloats;
  constexpr int C = D / 8;
  for (int u = (warp - first) * 32 + lane; u < kWarpRows * C; u += 32 * split) {
    const int row = u / C, d0 = (u % C) * 8;
    if (row0 + row >= live) continue;
    float m_star = kNegInf;
    for (int w = 0; w < split; ++w)
      m_star = fmaxf(m_star, grp[w * Reduce<D>::kFloats + kWarpRows * RS + row]);
    float l_star = 0.f, o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < split; ++w) {
      const float* g = grp + w * Reduce<D>::kFloats;
      const float a = __expf(g[kWarpRows * RS + row] - m_star);
      l_star += g[kWarpRows * RS + kWarpRows + row] * a;
      const float4 x = *reinterpret_cast<const float4*>(g + row * RS + d0);
      const float4 y = *reinterpret_cast<const float4*>(g + row * RS + d0 + 4);
      o[0] += x.x * a; o[1] += x.y * a; o[2] += x.z * a; o[3] += x.w * a;
      o[4] += y.x * a; o[5] += y.y * a; o[6] += y.z * a; o[7] += y.w * a;
    }
    const float den = fmaxf(l_star, 1e-30f);
    uint4 pk;
    pk.x = pack_bf16(o[0] / den, o[1] / den);
    pk.y = pack_bf16(o[2] / den, o[3] / den);
    pk.z = pack_bf16(o[4] / den, o[5] / den);
    pk.w = pack_bf16(o[6] / den, o[7] / den);
    *reinterpret_cast<uint4*>(out_row(row0 + row) + d0) = pk;
  }
}

}  // namespace attn_mma
