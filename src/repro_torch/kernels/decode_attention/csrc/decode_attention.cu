// Flash-decoding attention kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of repro/kernels/decode_attention/kernel.py:
//   * decode_attention_pallas  (_decode_kernel)          -> flash_rows, Q=1, add=0, splits=1
//   * decode_attention_splitk  (_splitk_partial_kernel)  -> flash_rows, Q=1, add=0, splits=K,
//                                                           partial state out
//                              (_splitk_combine_kernel)  -> splitk_combine
//   * mixed_attention_pallas   (_mixed_kernel)           -> flash_rows, add=1, splits=1
//   * decode_attention_paged   (_paged_decode_kernel)    -> flash_rows, tbl, Q=1, add=0, splits=1
//   * decode_attention_paged_splitk
//                              (_paged_splitk_partial_kernel) -> flash_rows, tbl, Q=1, add=0,
//                                                           splits=K, partial state out
//                              (combine: the same splitk_combine)
//   * mixed_attention_paged    (_mixed_paged_kernel)     -> flash_rows, tbl, add=1, splits=1
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
// window view k[:, :W] of a larger cache is read in place.  Still simple:
// fp32 CUDA-core math, no wgmma/TMA; later work makes it fast.
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
