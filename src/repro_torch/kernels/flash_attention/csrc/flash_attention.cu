// GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (_flash_kernel): the prefill attention of
// Model.prefill.  q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with Hkv | Hq;
// query head h reads kv head h / G; query i sits at position i + Sk - Sq
// (right-aligned) and sees key j when j <= q_pos (causal) and
// j > q_pos - window (window > 0).
//
// What bounds it: operations.  A causal prefill of S tokens does
// 4 * D * Hq * S * (S + 1) / 2 flops over 2 * S * (Hq + Hkv) * D elements
// of q, k, v and out: at the main-path shape of qwen3-0.6b (S = 2000,
// Hq = 16, Hkv = 8, D = 128, bf16) 16.4 GFLOP against 24.6 MB, about 670
// flops per byte, far above the ~295 where the H100 stops being
// bandwidth-bound.  Its least time is 0.0166 ms at the 989 TFLOP/s of the
// bf16 tensor cores.
//
// Design.  The TPU grid walked (B*Hkv, Sq/bq, Sk/bk) in order and carried
// the online-softmax state (m, l, acc) in VMEM scratch across the KV grid
// axis.  Here one CTA owns a (query tile, kv head, batch) cell: kRows = 64
// rows, each a (query, head) pair of the GQA group -- bq = 64 / G query
// positions times the G heads that share kv head h, the JAX (G*bq, D)
// group.  The CTA stages its query rows once, then loops over kTile-key
// tiles of K and V itself, so each KV tile it loads serves all 64 rows.
// Tiles wholly above the diagonal or wholly below the window are never
// visited; the ragged tail (key >= Sk, query >= Sq) is masked per element,
// so no S % tile constraint exists.  The 256 threads form 16 row groups of
// 4 rows x 16 lanes: in the score product a thread owns 4 rows x 2 keys,
// in the PV product the same 4 rows x D/16 columns, so the running m, l
// and the fp32 accumulator stay in its registers and the softmax rescale
// needs no shared state.  Row maxima and sums reduce over the 16 lanes of
// a group with warp shuffles.  p goes through shared memory transposed
// (key-major), read as one 16-byte broadcast per key.  Shared rows are
// padded by 4 floats so 16-byte reads and writes do not conflict.
// Still simple: fp32 CUDA-core FMAs over shared-memory tiles, plain 16-byte
// loads, no mma.sync/wgmma, no TMA; a later change makes it fast.
//
// Head dims 64, 80 and 128.  The score product walks D in steps of 4, so
// any multiple of 4 works there; in the PV product a lane owns 4 columns
// of each 64-column chunk, and at D = 80 the second chunk's 16 columns
// belong to lanes 0-3 alone (the others skip it, and store nothing past
// column 80).  Shared rows stay D + 4 floats, so no column is padded.
//
// Numerics match the TPU kernel: fp32 scores and softmax state, masking
// with -1e30 (not -inf: with a window, a row's first tile can be wholly
// masked; then p = exp(0) = 1 on masked keys until a later tile's
// correction exp(m_prev - m_new) = 0 zeroes it, where -inf would give
// NaN), l summed from the unrounded p, p rounded to V's dtype before the
// PV product, the output divided by max(l, 1e-30) in q's dtype.
//
// The entry point returns cudaGetLastError() after its launch (or -1 for
// an unsupported dtype, head_dim or group size), so a refused launch is
// reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

// One 16-byte pack of T (or zeros) into shared fp32 at dst (16-byte aligned).
template <typename T>
__device__ __forceinline__ void stage_pack(const T* src, bool ok, float* dst) {
  constexpr int N = Pack<T>::N;
  float f[N];
  if (ok) {
    unpack(*reinterpret_cast<const uint4*>(src), f, T());
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < N; e += 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(FlashParams p) {
  constexpr int kS = Smem<D>::kS, kPS = Smem<D>::kPS;
  constexpr int kC = (D + 63) / 64;            // 4-column chunks per thread in PV
  // D = 80: the second chunk holds 16 columns, those of lanes 0-3 (the
  // predicate folds away where 64 divides D)
  auto col_ok = [](int c, int ln) { return D % 64 == 0 || c * 64 + ln * 4 < D; };
  constexpr int kPackN = Pack<T>::N;
  constexpr int kPacks = D / kPackN;           // 16-byte packs per row
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

  const T* __restrict__ q = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* __restrict__ k = static_cast<const T*>(p.k) + b * p.k_sb + (long long)h * D;
  const T* __restrict__ v = static_cast<const T*>(p.v) + b * p.v_sb + (long long)h * D;

  // row r is query q0 + r / G of head h * G + r % G
  for (int u = tid; u < kRows * kPacks; u += kThreads) {
    const int r = u / kPacks, d0 = (u % kPacks) * kPackN;
    const T* src = q + (long long)(q0 + r / G) * p.q_ss + (long long)(h * G + r % G) * D + d0;
    stage_pack<T>(src, r < live, qs + r * kS + d0);
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
      const int j = u / kPacks, d0 = (u % kPacks) * kPackN, pos = t0 + j;
      const bool ok = pos < p.Sk;
      stage_pack<T>(k + pos * p.k_ss + d0, ok, ks + j * kS + d0);
      stage_pack<T>(v + pos * p.v_ss + d0, ok, vs + j * kS + d0);
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
        s[i][j] = to_f(from_f<T>(pr));         // p in V's dtype for the PV product
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

  T* __restrict__ out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = r0 + i;
    if (r >= live) continue;
    const int qi = r / G, g = r % G;
    T* o = out + (((long long)b * p.Sq + q0 + qi) * p.Hq + h * G + g) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (!col_ok(c, lane)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c * 64 + lane * 4 + e] = from_f<T>(acc[i][c * 4 + e] / den);
    }
  }
}

template <typename T, int D>
int launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::kBytes;       // above 48 KB at D = 128: opt in once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.Sq + p.bq - 1) / p.bq, p.Hkv, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const FlashParams& p, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return -1;
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(D, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, p, s);
  return -1;
}
