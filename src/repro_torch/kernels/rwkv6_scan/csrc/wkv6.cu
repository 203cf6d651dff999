// WKV6 recurrence (RWKV-6 "Finch" time mix) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py
// wkv6_pallas (_wkv6_kernel): the sequence form of rwkv6.time_mix that
// Model.prefill runs once per layer.  Per (batch, head), with r, k, v, w
// rows of N and an (N, N) fp32 state S:
//
//     y_t[m] = sum_n r_t[n] * (S[n][m] + u[n] * k_t[n] * v_t[m])
//     S[n][m] <- exp(w_t[n]) * S[n][m] + k_t[n] * v_t[m]
//
// r, k, v (B, S, H, N) in bf16 or fp32, logw (B, S, H, N) fp32, u (H, N) in
// r's dtype, state0 (B, H, N, N) fp32 or null (zeros).  Returns y
// (B, S, H, N) fp32 and the final state (B, H, N, N) fp32.
//
// What bounds it: operations.  Each token and head does about 5 * N^2
// flops (r . S is 2 N^2; the decay and the rank-1 update 3 N^2) on 4 N
// input values: at the main-path shape of rwkv6-7b (B = 1, S = 2000,
// H = 64, N = 64, bf16 r/k/v) 2.62 GFLOP against 116.8 MB, a least time
// of 0.0391 ms at the 67 TFLOP/s fp32 peak (above the 0.0349 ms of the
// bytes).  The work is a recurrence over time, so what limits a simple
// kernel is the serial chain per state element, not the card's peak.
//
// Design.  The TPU grid walked (B*H, S/C) in order, carrying S in VMEM
// and doing the intra-chunk work as MXU products over a (C, C, N)
// pairwise-decay tensor.  Here the time loop is serial inside the CTA,
// token by token, as GPU RWKV kernels do.  Value columns are independent
// (nothing in the recurrence couples S[:, m] and S[:, m']), so one CTA
// owns (batch, head, a slice of kCols = 16 value columns) -- N / 16 CTAs
// per head, which fills the card at B = 1 (64 heads x 4 slices = 256
// CTAs on 132 SMs).  Inside it, kSplit = 4 threads share a column, each
// holding R = N / 4 rows of that state column in registers, so a token
// costs a thread R decays and updates, and the column's y is the sum of
// the 4 partials by two warp shuffles.  The bonus term never touches the
// state: y_t[m] = r_t . S[:, m] + v_t[m] * (r_t . (u o k_t)), so each
// thread also sums r . (u o k) over its rows.  Per barrier the CTA stages
// kTok = 32 tokens of r, k, exp(w) and u o k (all N rows, fp32) and of v
// (its 16 columns) in shared memory; rows are padded by 4 floats per
// row slice so the 4 slices' 16-byte reads fall in distinct banks.  The
// (B, S, H, N) inputs are read in place: a token's N values of one head
// are contiguous, and consecutive threads stage consecutive values.  A
// thread issues its staging loads kBatch = 8 at a time (unrolled, all
// loads before any store), so a block waits on the load latency a few
// times rather than once per value: with ~4 warps per SM nothing else
// hides it.  The tail block (S % kTok) is the same code with the missing
// tokens predicated off, so any S is taken.  Still simple: the token loop is serial and on the CUDA
// cores (a chunked mma/wgmma form is later work).
//
// Numerics: fp32 throughout; the decay is expf (not __expf) because it is
// applied to a state that lives for thousands of steps.  The sums run in
// another order than the plain version's, within fp32 rounding.
//
// The entry point returns cudaGetLastError() after its launch (or -1 for
// an unsupported dtype or N), so a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kCols = 16;                 // value columns per CTA
constexpr int kSplit = 4;                 // threads sharing one state column
constexpr int kThreads = kCols * kSplit;  // 64 = 2 full warps
constexpr int kTok = 32;                  // tokens staged per barrier
constexpr int kPad = 4;                   // floats of padding per row slice
constexpr int kBatch = 8;                 // staging loads in flight per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Wkv6Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const void* u;
  const float* state0;   // null => zeros
  float* y;
  float* state_out;
  int S, H;
  long long r_sb, r_ss, k_sb, k_ss, v_sb, v_ss, w_sb, w_ss;   // element strides
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) wkv6_kernel(const Wkv6Params p) {
  constexpr int R = N / kSplit;             // state rows per thread
  constexpr int kSlice = R + kPad;          // padded floats per row slice
  constexpr int kRow = kSplit * kSlice;     // padded floats per token row
  constexpr int kJ = kTok * N / kThreads;   // r/k/w values per thread per block
  constexpr int kJv = kTok * kCols / kThreads;  // v values per thread per block
  static_assert(R % 4 == 0, "rows per thread are read as float4");
  static_assert(kJ % kBatch == 0 && kTok * kCols % kThreads == 0, "even staging");
  __shared__ __align__(16) float r_s[kTok][kRow];
  __shared__ __align__(16) float k_s[kTok][kRow];
  __shared__ __align__(16) float e_s[kTok][kRow];
  __shared__ __align__(16) float uk_s[kTok][kRow];
  __shared__ float v_s[kTok][kCols];
  __shared__ float u_s[N];

  const int tid = threadIdx.x;
  const int ks = tid % kSplit;              // this thread's row slice
  const int c = tid / kSplit;               // its column within the CTA
  const int col0 = blockIdx.x * kCols;
  const int m = col0 + c;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * N;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * N;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * N + col0;
  const float* w = p.logw + b * p.w_sb + h * N;
  for (int n = tid; n < N; n += kThreads) u_s[n] = to_f(static_cast<const T*>(p.u)[h * N + n]);

  // S[n][m] for n in [ks * R, ks * R + R)
  const long long s_base = (static_cast<long long>(b) * p.H + h) * N * N + m;
  float st[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    st[i] = p.state0 ? p.state0[s_base + static_cast<long long>(ks * R + i) * N] : 0.f;
  float* y = p.y + (static_cast<long long>(b) * p.S * p.H + h) * N + m;
  const long long y_ss = static_cast<long long>(p.H) * N;

  for (int t0 = 0; t0 < p.S; t0 += kTok) {
    const int nt = min(kTok, p.S - t0);
    __syncthreads();                        // u_s written / the last block consumed
    // value j of this thread is token (tid + j * kThreads) / N, row % N;
    // kBatch of them are loaded before any is stored, so a block waits on
    // the load latency kJ / kBatch times, not kJ times (the batches stay a
    // loop, so the compiler cannot hoist every load and run out of registers)
#pragma unroll 1
    for (int j0 = 0; j0 < kJ; j0 += kBatch) {
      float lr[kBatch], lk[kBatch], lw[kBatch];
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int idx = tid + (j0 + jj) * kThreads;
        const long long tok = t0 + idx / N;
        const int n = idx % N;
        const bool in = idx / N < nt;
        lr[jj] = in ? to_f(r[tok * p.r_ss + n]) : 0.f;
        lk[jj] = in ? to_f(k[tok * p.k_ss + n]) : 0.f;
        lw[jj] = in ? w[tok * p.w_ss + n] : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int idx = tid + (j0 + jj) * kThreads;
        const int t = idx / N, n = idx % N;
        const int pos = (n / R) * kSlice + n % R;
        if (t < nt) {
          r_s[t][pos] = lr[jj];
          k_s[t][pos] = lk[jj];
          e_s[t][pos] = expf(lw[jj]);
          uk_s[t][pos] = u_s[n] * lk[jj];
        }
      }
    }
    float lv[kJv];
#pragma unroll
    for (int j = 0; j < kJv; ++j) {
      const int idx = tid + j * kThreads;
      lv[j] = idx / kCols < nt ? to_f(v[(t0 + idx / kCols) * p.v_ss + idx % kCols]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kJv; ++j) {
      const int idx = tid + j * kThreads;
      if (idx / kCols < nt) v_s[idx / kCols][idx % kCols] = lv[j];
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float vv = v_s[t][c];
      const float* rr = &r_s[t][ks * kSlice];
      const float* kr = &k_s[t][ks * kSlice];
      const float* er = &e_s[t][ks * kSlice];
      const float* ur = &uk_s[t][ks * kSlice];
      float yp = 0.f, bp = 0.f;
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rr + i);
        const float4 k4 = *reinterpret_cast<const float4*>(kr + i);
        const float4 e4 = *reinterpret_cast<const float4*>(er + i);
        const float4 u4 = *reinterpret_cast<const float4*>(ur + i);
        yp = fmaf(r4.x, st[i + 0], yp);
        yp = fmaf(r4.y, st[i + 1], yp);
        yp = fmaf(r4.z, st[i + 2], yp);
        yp = fmaf(r4.w, st[i + 3], yp);
        bp = fmaf(r4.x, u4.x, bp);
        bp = fmaf(r4.y, u4.y, bp);
        bp = fmaf(r4.z, u4.z, bp);
        bp = fmaf(r4.w, u4.w, bp);
        st[i + 0] = fmaf(e4.x, st[i + 0], k4.x * vv);
        st[i + 1] = fmaf(e4.y, st[i + 1], k4.y * vv);
        st[i + 2] = fmaf(e4.z, st[i + 2], k4.z * vv);
        st[i + 3] = fmaf(e4.w, st[i + 3], k4.w * vv);
      }
      float out = fmaf(vv, bp, yp);
      out += __shfl_xor_sync(0xffffffffu, out, 1);
      out += __shfl_xor_sync(0xffffffffu, out, 2);
      if (ks == 0) y[(t0 + t) * y_ss] = out;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    p.state_out[s_base + static_cast<long long>(ks * R + i) * N] = st[i];
}

template <typename T>
int launch(int N, const Wkv6Params& p, int B, cudaStream_t s) {
  const dim3 grid(N / kCols, p.H, B);
  switch (N) {
    case 16: wkv6_kernel<T, 16><<<grid, kThreads, 0, s>>>(p); break;
    case 32: wkv6_kernel<T, 32><<<grid, kThreads, 0, s>>>(p); break;
    case 64: wkv6_kernel<T, 64><<<grid, kThreads, 0, s>>>(p); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wkv6_fwd(int dtype, int N, const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* state0, void* y,
                        void* state_out, int B, int S, int H, long long r_sb, long long r_ss,
                        long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                        long long w_sb, long long w_ss, void* stream) {
  Wkv6Params p{r, k, v, static_cast<const float*>(logw), u,
               static_cast<const float*>(state0), static_cast<float*>(y),
               static_cast<float*>(state_out), S, H,
               r_sb, r_ss, k_sb, k_ss, v_sb, v_ss, w_sb, w_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(N, p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(N, p, B, s);
  return -1;
}
