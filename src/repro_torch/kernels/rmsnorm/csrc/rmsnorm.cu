// Row RMSNorm, optionally fused with a residual add, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernels of repro/kernels/rmsnorm/kernel.py
// rmsnorm_pallas: _rmsnorm_kernel (the plain form) and
// _rmsnorm_fused_kernel (the residual add fused with the norm).  Over M
// rows of d, with a (d,) weight w:
//
//     plain: out = (x * rsqrt(mean(x^2) + eps)) * w
//     fused: s = x + r (fp32); sum_out = s; out = (s * rsqrt(mean(s^2) + eps)) * w
//
// x, r, w, out and sum_out are in one dtype (bf16 or fp32); the sums,
// the mean and the products run in fp32, and out and sum_out are rounded
// to the dtype once (round to nearest even, as torch's cast).
//
// What bounds it: memory.  A row does about 4 flops per element on 2 (plain)
// or 4 (fused) elements moved: at the hybrid path's longest prefill
// (M = 2000, d = 2560, bf16) the plain form moves 20.5 MB, a least time of
// 0.0061 ms at 3.35 TB/s, the fused form 41 MB, 0.0122 ms.
//
// Design.  The TPU grid walked blocks of 256 full rows in VMEM.  Here one
// CTA owns one row: its threads read the row as 16-byte packs (8 bf16 or
// 4 fp32 values), kPer packs a thread, and keep them in registers, so x
// (and r) are read once and the row is written once; the sum of squares
// reduces by warp shuffles and one pass through shared memory.  The CTA
// has ceil(packs / kPer) threads rounded up to whole warps, with kPer the
// least of 1, 2, 4, 8 that keeps it at 512 threads or fewer (320 threads
// at d = 2560 and d = 5120 in bf16).  Still simple: one row per CTA, so a
// decode step's few rows leave most SMs idle.
//
// The entry point returns cudaGetLastError() after its launch (or -1 for
// an unsupported dtype or width), so a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxThreads = 512;

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
__device__ __forceinline__ uint4 repack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 repack(const float* f, __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

template <typename T, int kPer, bool kFused>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ w,
    T* __restrict__ out, T* __restrict__ sum_out, int d, float eps) {
  constexpr int kPackN = Pack<T>::N;
  __shared__ float warp_ss[kMaxThreads / 32];
  const int packs = d / kPackN;
  const long long row = static_cast<long long>(blockIdx.x) * d;
  const int tid = threadIdx.x;

  float v[kPer][kPackN];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = tid + i * blockDim.x;
    if (u < packs) {
      const long long off = row + static_cast<long long>(u) * kPackN;
      unpack(*reinterpret_cast<const uint4*>(x + off), v[i], T());
      if constexpr (kFused) {
        float rv[kPackN];
        unpack(*reinterpret_cast<const uint4*>(r + off), rv, T());
#pragma unroll
        for (int e = 0; e < kPackN; ++e) v[i][e] += rv[e];
        *reinterpret_cast<uint4*>(sum_out + off) = repack(v[i], T());
      }
#pragma unroll
      for (int e = 0; e < kPackN; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tid % 32 == 0) warp_ss[tid / 32] = ss;
  __syncthreads();
  float total = 0.f;
  for (int wi = 0; wi < static_cast<int>(blockDim.x) / 32; ++wi) total += warp_ss[wi];
  const float rinv = rsqrtf(total / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = tid + i * blockDim.x;
    if (u < packs) {
      float wv[kPackN], o[kPackN];
      unpack(*reinterpret_cast<const uint4*>(w + static_cast<long long>(u) * kPackN), wv, T());
#pragma unroll
      for (int e = 0; e < kPackN; ++e) o[e] = (v[i][e] * rinv) * wv[e];
      *reinterpret_cast<uint4*>(out + row + static_cast<long long>(u) * kPackN) =
          repack(o, T());
    }
  }
}

template <typename T, bool kFused>
int launch(const void* x, const void* r, const void* w, void* out, void* sum_out, int M, int d,
           float eps, cudaStream_t s) {
  const int packs = d / Pack<T>::N;
  int per = 1;
  while (per < 8 && packs > per * kMaxThreads) per *= 2;
  if (packs > per * kMaxThreads) return -1;
  const int threads = ((packs + per - 1) / per + 31) / 32 * 32;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  T* st = static_cast<T*>(sum_out);
  switch (per) {
    case 1: rmsnorm_kernel<T, 1, kFused><<<M, threads, 0, s>>>(xt, rt, wt, ot, st, d, eps); break;
    case 2: rmsnorm_kernel<T, 2, kFused><<<M, threads, 0, s>>>(xt, rt, wt, ot, st, d, eps); break;
    case 4: rmsnorm_kernel<T, 4, kFused><<<M, threads, 0, s>>>(xt, rt, wt, ot, st, d, eps); break;
    default: rmsnorm_kernel<T, 8, kFused><<<M, threads, 0, s>>>(xt, rt, wt, ot, st, d, eps); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* r, const void* w, void* out, void* sum_out, int M,
             int d, float eps, cudaStream_t s) {
  if (d % Pack<T>::N != 0 || M < 1) return -1;
  if (r == nullptr) return launch<T, false>(x, r, w, out, sum_out, M, d, eps, s);
  return launch<T, true>(x, r, w, out, sum_out, M, d, eps, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  r (and sum_out) null: the plain form.
// Every row is contiguous and 16-byte aligned (the wrapper checks).
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* r, const void* w, void* out,
                           void* sum_out, int M, int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, r, w, out, sum_out, M, d, eps, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, r, w, out, sum_out, M, d, eps, s);
  return -1;
}
