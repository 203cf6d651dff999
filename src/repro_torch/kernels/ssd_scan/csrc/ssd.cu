// Mamba-2 SSD scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py
// ssd_pallas (_ssd_kernel): the sequence form of mamba2.mamba2_layer that
// Model.prefill runs once per Mamba-2 layer of the hybrid family.  Per
// (batch, head), with P channels, N state dims, a scalar decay per step
// and a (P, N) fp32 state S:
//
//     S[p][n] <- exp(dt_t * A) * S[p][n] + (dt_t * x_t[p]) * B_t[n]
//     y_t[p]   = sum_n S[p][n] * C_t[n]
//
// x (B, S, H, P) in bf16 or fp32, dt (B, S, H) fp32, A (H,) fp32, B and C
// (B, S, N) in x's dtype, shared by every head, state0 (B, H, P, N) fp32 or
// null (zeros).  Returns y (B, S, H, P) fp32 (no D skip term, as the TPU
// kernel) and the final state (B, H, P, N) fp32.
//
// What bounds it: operations.  Each token and head does about 5 * P * N
// flops (the decay and the rank-1 update 3 P N, y 2 P N) on P + 2 N + 1
// input values: at the main-path shape of zamba2-2.7b (B = 1, S = 2000,
// H = 80, P = N = 64, bf16 x/B/C) 3.28 GFLOP against about 64 MB (x
// 20.5 MB, y 41.0 MB fp32), a least time of 0.049 ms at the 67 TFLOP/s
// fp32 peak (above the 0.019 ms of the bytes).  The work is a recurrence
// over time, so what limits a simple kernel is the serial chain per state
// element and the instruction throughput of the CUDA cores, not the card's
// peak.
//
// Design.  The TPU grid walked (B*H, S/C) in order, carrying S in VMEM and
// doing the intra-chunk work as MXU products over a (C, C) pairwise-decay
// matrix.  Here the time loop is serial inside the CTA, token by token.
// Channels are independent (nothing couples S[p] and S[p']), so one CTA
// owns (batch, head, a slice of kRowsCta = 16 channels): P / 16 CTAs per
// head, 320 CTAs at B = 1, H = 80, P = 64 on 132 SMs.  Inside it, kLanes =
// 8 threads share a channel row, each holding R = N / 8 state values in
// registers, so a token costs a thread R decays, updates and products,
// and the row's y is the sum of the 8 partials by three warp shuffles.
// A thread's values are n = (i / V) * 8V + lane * V + i % V, so the 8 lanes
// of a row read B and C as contiguous V-wide vectors (no bank conflicts;
// the 4 rows of a warp read the same addresses, a broadcast).  B and C are
// read once per (b, token) per CTA, not widened to H, as the TPU index_map
// drops the head coordinate.  Per barrier the CTA stages kTok = 32 tokens
// of B, C (all N, fp32), its 16 channels of x, dt and exp(dt * A) in
// shared memory.  The next block's values are loaded as 16-byte vectors
// into a fixed, unrolled set of registers (5 vectors a thread in bf16, 9
// in fp32) before the current block is computed, so their latency hides
// behind its 32 tokens of math, and are stored to shared memory after it.
// y goes through shared memory and leaves as 16-byte stores, one token's
// 16 channels per 4 threads.  The token loop always runs kTok steps: the
// tail block's missing tokens are staged as dt = 0, x = B = C = 0, and then
// exp(0 * A) = 1 and a zero update leave the state exactly as it was, so
// any S is taken with no runtime trip count in the inner loop; their y is
// not stored.  The (B, S, .) inputs are read in place through batch and
// sequence strides (x, B and C are slices of the conv output).  Still
// simple: the token loop is serial and on the CUDA cores (a chunked
// mma/wgmma form is later work).
//
// Numerics: fp32 throughout; the decay is expf (not __expf) because it is
// applied to a state that lives for thousands of steps.  The sums run in
// another order than the plain versions', within fp32 rounding.
//
// The entry point returns cudaGetLastError() after its launch (or -1 for
// an unsupported dtype or N), so a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kLanes = 8;                     // threads sharing one channel row
constexpr int kRowsCta = kThreads / kLanes;   // 16 channels per CTA
constexpr int kTok = 32;                      // tokens staged per barrier
static_assert(kTok <= kThreads, "one thread stages one token's dt");
static_assert(kTok * kRowsCta / 4 == kThreads, "one 16-byte y store per thread per block");

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

// one pack of T as fp32 into shared memory at dst (16-byte aligned)
template <typename T>
__device__ __forceinline__ void stash_pack(const uint4& u, float* dst) {
  constexpr int N = Pack<T>::N;
  float f[N];
  unpack(u, f, T());
#pragma unroll
  for (int e = 0; e < N; e += 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
}

struct SsdParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* state0;   // null => zeros
  float* y;
  float* state_out;
  int S, H, P;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;   // element strides
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const SsdParams p) {
  constexpr int R = N / kLanes;                 // state values per thread
  constexpr int V = R < 4 ? R : 4;              // width of its shared reads
  constexpr int kPackN = Pack<T>::N;
  constexpr int kNPacks = N / kPackN;           // 16-byte packs per B/C row
  constexpr int kXPacks = kRowsCta / kPackN;    // packs per token of the x slice
  constexpr int kBCUnits = kTok * kNPacks;      // packs of B (and of C) per block
  constexpr int kXUnits = kTok * kXPacks;
  constexpr int kBCPer = (kBCUnits + kThreads - 1) / kThreads;
  constexpr int kXPer = (kXUnits + kThreads - 1) / kThreads;
  static_assert(R % V == 0 && (V == 2 || V == 4), "state values are read as float2/float4");
  static_assert(N % kPackN == 0 && kRowsCta % kPackN == 0, "rows split into 16-byte packs");
  __shared__ __align__(16) float b_s[kTok][N];
  __shared__ __align__(16) float c_s[kTok][N];
  __shared__ __align__(16) float x_s[kTok][kRowsCta];
  __shared__ __align__(16) float y_s[kTok][kRowsCta];
  __shared__ float dt_s[kTok], da_s[kTok];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;              // this thread's state values
  const int pr = tid / kLanes;                // its channel row within the CTA
  const int p0 = blockIdx.x * kRowsCta;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.P + p0;
  const T* bm = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cm = static_cast<const T*>(p.Cm) + b * p.c_sb;
  const float* dt = p.dt + b * p.dt_sb + h;
  const float A = p.A[h];

  // S[p0 + pr][n(i)], n(i) = (i / V) * kLanes * V + lane * V + i % V
  const long long s_base = ((static_cast<long long>(b) * p.H + h) * p.P + p0 + pr) * N;
  float st[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = (i / V) * kLanes * V + lane * V + i % V;
    st[i] = p.state0 ? p.state0[s_base + n] : 0.f;
  }

  // the next block, in registers: a fixed, unrolled number of 16-byte loads
  uint4 breg[kBCPer], creg[kBCPer], xreg[kXPer];
  float dtreg = 0.f;
  auto fetch = [&](int t0) {
    const int nt = min(kTok, p.S - t0);
#pragma unroll
    for (int i = 0; i < kBCPer; ++i) {
      const int u = tid + i * kThreads, j = u / kNPacks, q = u % kNPacks;
      breg[i] = make_uint4(0, 0, 0, 0);
      creg[i] = make_uint4(0, 0, 0, 0);
      if ((kBCUnits % kThreads == 0 || u < kBCUnits) && j < nt) {
        const long long t = t0 + j;
        breg[i] = *reinterpret_cast<const uint4*>(bm + t * p.b_ss + q * kPackN);
        creg[i] = *reinterpret_cast<const uint4*>(cm + t * p.c_ss + q * kPackN);
      }
    }
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int u = tid + i * kThreads, j = u / kXPacks, q = u % kXPacks;
      xreg[i] = make_uint4(0, 0, 0, 0);
      if ((kXUnits % kThreads == 0 || u < kXUnits) && j < nt)
        xreg[i] = *reinterpret_cast<const uint4*>(x + (t0 + j) * p.x_ss + q * kPackN);
    }
    dtreg = tid < nt ? dt[(t0 + tid) * p.dt_ss] : 0.f;   // missing tokens: dt = 0
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kBCPer; ++i) {
      const int u = tid + i * kThreads, j = u / kNPacks, q = u % kNPacks;
      if (kBCUnits % kThreads == 0 || u < kBCUnits) {
        stash_pack<T>(breg[i], &b_s[j][q * kPackN]);
        stash_pack<T>(creg[i], &c_s[j][q * kPackN]);
      }
    }
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int u = tid + i * kThreads, j = u / kXPacks, q = u % kXPacks;
      if (kXUnits % kThreads == 0 || u < kXUnits) stash_pack<T>(xreg[i], &x_s[j][q * kPackN]);
    }
    if (tid < kTok) {
      dt_s[tid] = dtreg;
      da_s[tid] = expf(dtreg * A);                 // exactly 1 for a missing token
    }
  };

  fetch(0);
  stash();
  __syncthreads();
  for (int t0 = 0; t0 < p.S; t0 += kTok) {
    const int nt = min(kTok, p.S - t0);
    const bool more = t0 + kTok < p.S;
    if (more) fetch(t0 + kTok);                    // in flight during this block's math
#pragma unroll 4
    for (int t = 0; t < kTok; ++t) {
      const float da = da_s[t];
      const float u = dt_s[t] * x_s[t][pr];
      float yp = 0.f;
#pragma unroll
      for (int i = 0; i < R; i += V) {
        const int n = (i / V) * kLanes * V + lane * V;
        float bv[V], cv[V];
        if constexpr (V == 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(&b_s[t][n]);
          const float4 c4 = *reinterpret_cast<const float4*>(&c_s[t][n]);
          bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
          cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
        } else {
          const float2 b2 = *reinterpret_cast<const float2*>(&b_s[t][n]);
          const float2 c2 = *reinterpret_cast<const float2*>(&c_s[t][n]);
          bv[0] = b2.x; bv[1] = b2.y;
          cv[0] = c2.x; cv[1] = c2.y;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          st[i + e] = fmaf(da, st[i + e], u * bv[e]);
          yp = fmaf(st[i + e], cv[e], yp);
        }
      }
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      yp += __shfl_xor_sync(0xffffffffu, yp, 4);
      if (lane == 0) y_s[t][pr] = yp;
    }
    __syncthreads();                               // y_s written, the block consumed
    {
      const int j = tid / (kRowsCta / 4), q = tid % (kRowsCta / 4);
      if (j < nt) {
        float* dst = p.y + ((static_cast<long long>(b) * p.S + t0 + j) * p.H + h) * p.P + p0;
        *reinterpret_cast<float4*>(dst + 4 * q) = *reinterpret_cast<const float4*>(&y_s[j][4 * q]);
      }
    }
    if (more) stash();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = (i / V) * kLanes * V + lane * V + i % V;
    p.state_out[s_base + n] = st[i];
  }
}

template <typename T>
int launch(int N, const SsdParams& p, int B, cudaStream_t s) {
  const dim3 grid(p.P / kRowsCta, p.H, B);
  switch (N) {
    case 16: ssd_kernel<T, 16><<<grid, kThreads, 0, s>>>(p); break;
    case 32: ssd_kernel<T, 32><<<grid, kThreads, 0, s>>>(p); break;
    case 64: ssd_kernel<T, 64><<<grid, kThreads, 0, s>>>(p); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C).  P must be a multiple of
// 16 and every x/B/C row 16-byte aligned (the wrapper checks both).
extern "C" int ssd_fwd(int dtype, int N, const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* state0, void* y,
                       void* state_out, int B, int S, int H, int P, long long x_sb,
                       long long x_ss, long long dt_sb, long long dt_ss, long long b_sb,
                       long long b_ss, long long c_sb, long long c_ss, void* stream) {
  if (P % kRowsCta != 0) return -1;
  SsdParams p{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
              static_cast<const float*>(state0), static_cast<float*>(y),
              static_cast<float*>(state_out), S, H, P,
              x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(N, p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(N, p, B, s);
  return -1;
}
