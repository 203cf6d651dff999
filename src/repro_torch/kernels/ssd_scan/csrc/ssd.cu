// Mamba-2 SSD scan for Hopper (sm_90a), plain C interface: ssd_chunk_kernel
// for bf16 inputs (tensor cores), ssd_kernel for fp32 (CUDA cores).
//
// Both replace the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py
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
// What bounds it.  Each token and head does about 5 * P * N flops (the
// decay and the rank-1 update 3 P N, y 2 P N) on P + 2 N + 1 input values:
// at the main-path shape of zamba2-2.7b (B = 1, S = 2000, H = 80, P = N =
// 64, bf16 x/B/C) 3.28 GFLOP against about 64 MB (x 20.5 MB, y 41.0 MB
// fp32).  The bf16 kernel runs those flops on the tensor cores as TF32
// products in which one operand (x, B or C: bf16, exact in TF32) needs no
// split, so two passes each (495 / 2 = 247.5 TFLOP/s): 0.0133 ms, below
// the bytes' 0.0191 ms at 3.35 TB/s, so bytes.  The fp32 kernel runs them
// on the CUDA cores: 0.049 ms at the 67 TFLOP/s fp32 peak, operations.
//
// bf16: ssd_chunk_kernel<N, R>, the TPU kernel's chunked recurrence.  A
// serial token loop is one dependent chain of decays and updates per
// state element (the fp32 kernel below).  Here, as on the TPU, the
// sequence goes in chunks of C = 64 tokens (the TPU's 128 halves the
// per-token work of the within-chunk product): within a chunk every
// product is a matrix product, and only the (P, N) state is carried.
// Mamba-2's decay is one scalar per head and step, so the within-chunk
// decays form one (C, C) matrix per head:
//
//     y_t  = 2^(cum_t) C_t . S_prev^T + sum_(s <= t) att[t, s] x_s,
//     att[t, s] = (C_t . B_s) 2^(cum_t - cum_s) dt_s,
//     S   <- 2^(cum_end) S + (x o w)^T . B,   w_s = dt_s 2^(cum_end - cum_s),
//
// cum the inclusive cumsum of dt * A in log2 units.
//
//   Grid.  One CTA per (slice of R channels, head, batch): channels are
//   independent, and each slice recomputes the chunk's C . B^T, which is
//   cheap.  The wrapper picks R (kernel.py chunk_rows), the widest of 64,
//   32 and 16 that divides P: 64 at zamba2's shapes (80 CTAs at B = 1,
//   640 at B = 8), the fastest width at both.
//   8 warps, 256 threads; each CTA walks its (batch, head)'s chunks in
//   order, the state on chip.
//
//   Staging.  x (its R channels), B and C (bf16) and dt (fp32) of a chunk
//   go to shared memory by cp.async (16 bytes; 4 for dt, whose heads
//   interleave, copied by warp 0, which scans it) through a 2-stage ring,
//   the next chunk's copies in flight during this chunk's work.  A row at
//   or past S is zero-filled through cp.async's src-size operand, never
//   skipped: dt = 0 is a decay of 1 and x = 0 adds nothing, so the state
//   passes through; y rows past S are not stored.  x, B and C are read in
//   place (batch and sequence strides: mamba2_layer passes slices of the
//   conv output).
//
//   Exponents, all <= 0 by construction.  Per chunk, four lanes take the
//   cumsum of dt * A (log2 units) in order, each over one 16-token
//   sub-chunk, from 0: l_t, sums of at most 16 terms; the sub-chunk
//   offsets b_0 = 0, b_(i+1) = b_i + l(last of i) follow in order, and
//   u_s = l(last of j) - l_s for s in sub-chunk j.  All are stored, and
//   every exponent is a sum of stored differences whose sign is known
//   (fp32 rounding keeps each stored sequence non-increasing):
//     pairs in one sub-chunk: 2^(l_t - l_s), masked (s <= t) before the exp;
//     s in an earlier sub-chunk j < i: 2^(l_t) 2^(b_i - b_(j+1)) 2^(u_s),
//       three factors each <= 1 (one that underflows does so only where
//       the product is below 2^-126);
//     y_inter: 2^(b_i + l_t);  state decay: 2^(b_4);
//     w_s: dt_s 2^((b_4 - b_(j+1)) + u_s).
//   No exponent is cum - dA, and none is a difference of two sums of
//   more than 16 terms, so its rounding stays at a few ulps of its own
//   size however long the chunk's cumsum runs (at strong decay that
//   cumsum reaches about -2000; a pair's exponent, the part that matters,
//   is tens).
//
//   Products.  mma.sync with fp32 accumulation.  C . B^T: both bf16, one
//   exact pass of m16n8k16 in bf16, only the 10 blocks of 16 x 16 on or
//   below the diagonal.  The rest are TF32 m16n8k8 in 3xTF32 with the
//   zero-lo term dropped (tf32_mma.cuh): att . x (att split, x exact),
//   C . S_prev^T (C exact, S split), (x o w)^T . B (x o w split, B exact):
//   two passes each.  att is split once, where it is made, and the state
//   after each update, each kept as 16-byte (hi, hi, lo, lo) pairs of
//   adjacent columns; in y_inter and att . x the k slots tq and tq + 4 of
//   a k8 step are the adjacent columns 2 tq and 2 tq + 1 (the same in both
//   operands), so C's two values are one bf16x2 load and a split pair one
//   16-byte load.
//
//   Warps.  Warp w owns the y rows of one sub-chunk, w for w < 4 and 7 - w
//   after (so the two warps of an SM quarter, w and w + 4, hold 10 k steps
//   of att . x between them), over half of the R / 8 channel tiles (w / 4,
//   w / 4 + 2, ..); and a tile set of the state (m16 tile w % (R / 16), n8
//   tiles from w / (R / 16) in steps of 8 / (R / 16)), which lives in its
//   registers.  Per chunk, two barriers: C . B^T and att (20 n8 halves of
//   the 10 blocks over the 8 warps, the diagonal ones first), y_inter and
//   the state update; a barrier; att . x for the warp's rows (2 to 8 k
//   steps: the tiles above the diagonal are skipped), y stored, the new
//   state's split written, and warp 0 (sub-chunk 0's rows: 2 k steps)
//   scans the next chunk, whose dt it copied itself; a barrier once every
//   thread's copies of the next chunk have landed; the copies of the
//   chunk after it.
//
//   What limits it: 0.14 ms at B = 1, S = 2000, about 7.4x its bound
//   (PERF.md has the measured times).  Timing variants of the kernel with
//   one part left out (on an NVIDIA H100 80GB HBM3 at 700 W) put the state
//   update first (0.039 ms of 0.144) and C . B^T with att second (0.023);
//   at the dense TF32 rate the chunk's mma.sync work would take about a
//   third of the measured time.  Three variants were slower and were not
//   kept: 16 warps per CTA, the state's tokens split between the two warps
//   of an m-tile, and x o w split once per chunk into shared memory a
//   chunk ahead.  Which unit binds is not measured.
//
// fp32: ssd_kernel<float, N>.  The time loop is serial inside the CTA,
// token by token.  Channels are independent (nothing couples S[p] and
// S[p']), so one CTA owns (batch, head, a slice of kRowsCta = 16
// channels): P / 16 CTAs per head.  Inside it, kLanes = 8 threads share a
// channel row, each holding R = N / 8 state values in registers, so a
// token costs a thread R decays, updates and products, and the row's y is
// the sum of the 8 partials by three warp shuffles.  A thread's values
// are n = (i / V) * 8V + lane * V + i % V, so the 8 lanes of a row read B
// and C as contiguous V-wide vectors (no bank conflicts; the 4 rows of a
// warp read the same addresses, a broadcast).  B and C are read once per
// (b, token) per CTA, not widened to H, as the TPU index_map drops the
// head coordinate.  Per barrier the CTA stages kTok = 32 tokens of B, C
// (all N, fp32), its 16 channels of x, dt and exp(dt * A) in shared
// memory.  The next block's values are loaded as 16-byte vectors into a
// fixed, unrolled set of registers (9 vectors a thread) before the
// current block is computed, so their latency hides behind its 32 tokens
// of math, and are stored to shared memory after it.  y goes through
// shared memory and leaves as 16-byte stores, one token's 16 channels per
// 4 threads.  The token loop always runs kTok
// steps: the tail block's missing tokens are staged as dt = 0, x = B = C
// = 0, and then exp(0 * A) = 1 and a zero update leave the state exactly
// as it was, so any S is taken with no runtime trip count in the inner
// loop; their y is not stored.  The (B, S, .) inputs are read in place
// through batch and sequence strides.  What limits it: the serial chain
// per state element and the CUDA cores' instruction throughput, not the
// card's peak.  Numerics: fp32 throughout; the decay is expf (not
// __expf) because it is applied to a state that lives for thousands of
// steps.  The sums run in another order than the plain versions', within
// fp32 rounding.
//
// The entry point returns cudaGetLastError() after its launch (or -1 for
// an unsupported dtype, N or channel slice), so a refused launch is
// reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "tf32_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the chunked recurrence on the tensor cores
// ---------------------------------------------------------------------------

namespace chunk {

using bf16 = __nv_bfloat16;
using namespace tf32;

constexpr int kC = 64;                            // tokens per chunk
constexpr int kSub = 16;                          // tokens per sub-chunk (an m16 tile of rows)
constexpr int kBlocks = kC / kSub;                // 4 sub-chunks
// the 10 blocks of C . B^T on or below the diagonal, each in two n8 halves
constexpr int kHalves = kBlocks * (kBlocks + 1);
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;             // 256
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA, in bytes: a 2-stage ring of x (bf16, rows of
// R + 8), B and C (bf16, N + 8) and dt (fp32); the scores att and the
// state, each split into TF32 hi and lo and kept as pairs: columns 2m and
// 2m + 1 of a row are the 16 bytes hi(2m), hi(2m + 1), lo(2m), lo(2m + 1)
// (rows of 2 kC + 16 and 2 N + 16 words); the scan's per-token values
// (fp32, 5 rows of kC) and b_0..b_4.  The paddings put the fragment loads
// of a quarter warp in distinct banks; every row stays a multiple of 16
// bytes for cp.async and the 16-byte loads.
template <int N, int R>
struct Layout {
  static constexpr int kX = R + 8;
  static constexpr int kBC = N + 8;
  static constexpr int kA = 2 * kC + 16;
  static constexpr int kS = 2 * N + 16;
  static constexpr int kXBytes = kC * kX * 2;
  static constexpr int kBCBytes = kC * kBC * 2;
  static constexpr int kStage = kXBytes + 2 * kBCBytes + kC * 4;
  static constexpr int kAttOff = 2 * kStage;
  static constexpr int kStateOff = kAttOff + kC * kA * 4;
  static constexpr int kScanOff = kStateOff + R * kS * 4;
  static constexpr int kBytes = kScanOff + (5 * kC + 8) * 4;
  static_assert(kXBytes % 16 == 0 && kBCBytes % 16 == 0, "16-byte rows");
};

// Stage the W bf16 values of each row of tokens [t0, t0 + kC): a row at or
// past S is zero-filled.
template <int W>
__device__ __forceinline__ void stage_rows(bf16* dst, int dst_stride, const bf16* src,
                                           long long src_stride, int t0, int S) {
  constexpr int kPieces = W / 8;                  // 16-byte pieces per row
  constexpr int kUnits = kC * kPieces;
#pragma unroll
  for (int i = 0; i < (kUnits + kThreads - 1) / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads, t = u / kPieces, c = u % kPieces;
    if (kUnits % kThreads != 0 && u >= kUnits) break;
    const bool in = t0 + t < S;
    cp_async16(dst + t * dst_stride + c * 8, src + (in ? t0 + t : 0) * src_stride + c * 8, in);
  }
}

template <int N, int R>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const SsdParams& p, const bf16* x,
                                            const bf16* bm, const bf16* cm, const float* dt,
                                            int t0) {
  using L = Layout<N, R>;
  bf16* xs = reinterpret_cast<bf16*>(st);
  stage_rows<R>(xs, L::kX, x, p.x_ss, t0, p.S);
  stage_rows<N>(xs + kC * L::kX, L::kBC, bm, p.b_ss, t0, p.S);
  stage_rows<N>(xs + kC * L::kX + kC * L::kBC, L::kBC, cm, p.c_ss, t0, p.S);
  if (threadIdx.x < 32) {               // dt by warp 0 alone, which scans it
#pragma unroll
    for (int t = threadIdx.x; t < kC; t += 32) {
      const bool in = t0 + t < p.S;
      cp_async4(reinterpret_cast<float*>(st + L::kXBytes + 2 * L::kBCBytes) + t,
                dt + (in ? static_cast<long long>(t0 + t) * p.dt_ss : 0), in);
    }
  }
}

// The scan of one chunk, by warp 0: lane i < 4 sums sub-chunk i's dt * A
// (log2 units, a2 = A log2 e) in order from 0 (l); then the offsets b in
// order (the same operations in every lane); then, for two tokens a lane,
// with u_s = l(last of its sub-chunk j) - l_s <= 0:
//   sE = 2^l_t, sF = dt_s 2^u_s (the off-diagonal scores' row and column
//   factors), sw = dt_s 2^((b_4 - b_(j+1)) + u_s), sy = 2^(b_i + l_t).
__device__ __forceinline__ void chunk_scan(const float* ds, float a2, float* sl, float* sE,
                                           float* sF, float* sw, float* sy, float* sb,
                                           int lane) {
  if (lane < kBlocks) {
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      run = fmaf(ds[lane * kSub + j], a2, run);
      sl[lane * kSub + j] = run;
    }
  }
  __syncwarp();
  float bo = 0.f;
#pragma unroll
  for (int i = 0; i <= kBlocks; ++i) {
    if (lane == i) sb[i] = bo;
    if (i < kBlocks) bo += sl[i * kSub + kSub - 1];
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < kC / 32; ++e) {
    const int t = lane + 32 * e, i = t / kSub;
    const float u = sl[i * kSub + kSub - 1] - sl[t];
    sE[t] = ex2(sl[t]);
    sF[t] = ds[t] * ex2(u);
    sw[t] = ds[t] * ex2((sb[kBlocks] - sb[i + 1]) + u);
    sy[t] = ex2(sb[i] + sl[t]);
  }
}

// One CTA per (channel slice of R, head, batch); 8 warps.
template <int N, int R>
__global__ void __launch_bounds__(kThreads, R < 64 ? 2 : 1) ssd_chunk_kernel(const SsdParams p) {
  using L = Layout<N, R>;
  constexpr int NT = N / 8;              // n8 tiles of the state's columns (and k8 steps over N)
  constexpr int MT = R / 16;             // m16 tiles of the state's rows
  constexpr int WG = kWarps / MT;        // warps sharing a state m-tile
  constexpr int TN = (NT + WG - 1) / WG; // state n-tiles per warp
  constexpr int YG = kWarps / kBlocks;   // warps sharing a sub-chunk's y rows
  constexpr int YQ = R / 8 / YG;         // y channel tiles per warp
  static_assert(YQ >= 1 && (R / 8) % YG == 0, "y channel tiles over the warps");
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* att = reinterpret_cast<uint32_t*>(smem + L::kAttOff);
  uint32_t* S2 = reinterpret_cast<uint32_t*>(smem + L::kStateOff);
  float* sl = reinterpret_cast<float*>(smem + L::kScanOff);   // l_t: cumsum within the sub-chunk
  float* sE = sl + kC;                   // 2^l_t
  float* sF = sE + kC;                   // dt_s 2^u_s
  float* sw = sF + kC;                   // w_s = dt_s 2^(b_4 - b_(j+1) + u_s)
  float* sy = sw + kC;                   // 2^(b_i + l_t)
  float* sb = sy + kC;                   // b_0 .. b_4

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int p0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const bf16* x = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.P + p0;
  const bf16* bm = static_cast<const bf16*>(p.Bm) + b * p.b_sb;
  const bf16* cm = static_cast<const bf16*>(p.Cm) + b * p.c_sb;
  const float* dt = p.dt + b * p.dt_sb + h;
  const float a2 = p.A[h] * kLog2e;
  const int nchunks = (p.S + kC - 1) / kC;

  stage_chunk<N, R>(smem, p, x, bm, cm, dt, 0);
  cp_async_commit();
  if (nchunks > 1) stage_chunk<N, R>(smem + L::kStage, p, x, bm, cm, dt, kC);
  cp_async_commit();

  // the state tiles this warp owns, in the m16n8 accumulator layout: rows
  // mr0 = mt*16 + g and mr0 + 8, columns (ng + q*WG)*8 + 2*tq, +1
  const int mt = warp % MT, ng = warp / MT;
  const int mr0 = mt * 16 + g, mr1 = mr0 + 8;
  const bool owns_state = ng < NT;
  const long long s_row = (static_cast<long long>(b) * p.H + h) * p.P + p0;
  float st[TN][4];
#pragma unroll
  for (int q = 0; q < TN; ++q) {
    const int c = (ng + q * WG) * 8 + 2 * tq;
    st[q][0] = st[q][1] = st[q][2] = st[q][3] = 0.f;
    if (ng + q * WG < NT) {
      if (p.state0 != nullptr) {
        const float2 v0 = *reinterpret_cast<const float2*>(p.state0 + (s_row + mr0) * N + c);
        const float2 v1 = *reinterpret_cast<const float2*>(p.state0 + (s_row + mr1) * N + c);
        st[q][0] = v0.x; st[q][1] = v0.y; st[q][2] = v1.x; st[q][3] = v1.y;
      }
      store_pair(S2 + mr0 * L::kS + 2 * c, st[q][0], st[q][1]);
      store_pair(S2 + mr1 * L::kS + 2 * c, st[q][2], st[q][3]);
    }
  }

  // the y rows this warp owns: sub-chunk yi (rows ta, tb of the m16 tile),
  // channel tiles yh, yh + YG, ..; the warps of one SM quarter (w % 4 = q)
  // take sub-chunks q and 3 - q in turn, 10 k steps of att . x a pair
  const int yh = warp / kBlocks;
  const int yi = yh % 2 == 0 ? warp % kBlocks : kBlocks - 1 - warp % kBlocks;
  const int ta = yi * kSub + g, tb = ta + 8;

  auto dt_stage = [&](int c) {
    return reinterpret_cast<const float*>(smem + (c & 1) * L::kStage + L::kXBytes +
                                          2 * L::kBCBytes);
  };
  cp_async_wait1();                      // chunk 0's copies (chunk 1's may be in flight)
  __syncthreads();                       // everyone's copies, and the state, visible
  if (warp == 0) chunk_scan(dt_stage(0), a2, sl, sE, sF, sw, sy, sb, lane);
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    unsigned char* stg = smem + (c & 1) * L::kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(stg);
    const bf16* bs = xs + kC * L::kX;
    const bf16* cs = bs + kC * L::kBC;
    const float* ds = dt_stage(c);

    // C . B^T on the blocks (i, j), j <= i, and att = (C . B^T) o 2^(...) o
    // dt_s, split and stored, one n8 half of a block at a time: the halves
    // of the 4 diagonal blocks first, then those of the 6 below (the warps
    // that take a second half take an off-diagonal one)
    for (int hb = warp; hb < kHalves; hb += kWarps) {
      const int blk = hb / 2, nt = hb % 2;
      const int bi = blk < 4 ? blk : blk < 7 ? blk - 3 : blk < 9 ? blk - 5 : 3;
      const int bj = blk < 4 ? blk : blk < 7 ? blk - 4 : blk < 9 ? blk - 7 : 0;
      const int ra = bi * kSub + g, rb = ra + 8;
      const int s = bj * kSub + nt * 8 + 2 * tq;        // this lane's two columns
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int k0 = kk * 16 + 2 * tq;
        const uint32_t a[4] = {bf2(cs + ra * L::kBC + k0), bf2(cs + rb * L::kBC + k0),
                               bf2(cs + ra * L::kBC + k0 + 8), bf2(cs + rb * L::kBC + k0 + 8)};
        const int sk = bj * kSub + nt * 8 + g;          // the key row of this lane's B fragment
        mma_bf16(acc, a, bf2(bs + sk * L::kBC + k0), bf2(bs + sk * L::kBC + k0 + 8));
      }
      if (bi == bj) {
        // pairwise: 2^(l_t - l_s), masked (s <= t) before the exp
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = half ? rb : ra;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ex = s + e <= t ? sl[t] - sl[s + e] : -1e30f;   // 2^-1e30 = 0
            v[e] = acc[2 * half + e] * ex2(ex) * ds[s + e];
          }
          store_pair(att + t * L::kA + 2 * s, v[0], v[1]);
        }
      } else {
        // 2^(l_t) 2^(b_i - b_(j+1)) dt_s 2^(u_s): each factor <= 1
        const float G = ex2(sb[bi] - sb[bj + 1]);
        const float ea = sE[ra] * G, eb = sE[rb] * G, f0 = sF[s], f1 = sF[s + 1];
        store_pair(att + ra * L::kA + 2 * s, acc[0] * ea * f0, acc[1] * ea * f1);
        store_pair(att + rb * L::kA + 2 * s, acc[2] * eb * f0, acc[3] * eb * f1);
      }
    }

    // y_inter = 2^(cum_t) C_t . S_prev^T on this warp's rows and channel
    // tiles.  The k index is taken in pairs: slots tq and tq + 4 of a k8
    // step are state dims n0 = 8 kk + 2 tq and n0 + 1, in both operands, so
    // C's two values are one bf16x2 load and S's hi and lo one 16-byte load.
    float yacc[YQ][4];
#pragma unroll
    for (int q = 0; q < YQ; ++q) yacc[q][0] = yacc[q][1] = yacc[q][2] = yacc[q][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int n0 = kk * 8 + 2 * tq;
      const uint32_t ca = bf2(cs + ta * L::kBC + n0), cb = bf2(cs + tb * L::kBC + n0);
      const uint32_t a[4] = {ca << 16, cb << 16, ca & 0xffff0000u, cb & 0xffff0000u};
#pragma unroll
      for (int q = 0; q < YQ; ++q) {
        const uint4 sv = *reinterpret_cast<const uint4*>(S2 + ((yh + YG * q) * 8 + g) * L::kS +
                                                         2 * n0);
        mma2_exact_a(yacc[q], a, sv.x, sv.y, sv.z, sv.w);
      }
    }
    {
      const float ya = sy[ta], yb = sy[tb];
#pragma unroll
      for (int q = 0; q < YQ; ++q) {
        yacc[q][0] *= ya; yacc[q][1] *= ya; yacc[q][2] *= yb; yacc[q][3] *= yb;
      }
    }

    // S <- 2^(b_4) S + (x o w)^T . B on this warp's state tiles, in
    // registers.  The chunk's update goes to a fresh accumulator and joins
    // the state by one fmaf: the state lives for the whole sequence, and
    // carried through the tensor cores' accumulation (not rounded to
    // nearest) 16 times a chunk it drifts where the decay is slow.
    if (owns_state) {
      float du[TN][4];
#pragma unroll
      for (int q = 0; q < TN; ++q) du[q][0] = du[q][1] = du[q][2] = du[q][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kC / 8; ++kk) {
        const int s0 = kk * 8 + tq, s1 = s0 + 4;
        const float w0 = sw[s0], w1 = sw[s1];
        uint32_t ah[4], al[4];
        split(bf(xs + s0 * L::kX + mr0) * w0, ah[0], al[0]);
        split(bf(xs + s0 * L::kX + mr1) * w0, ah[1], al[1]);
        split(bf(xs + s1 * L::kX + mr0) * w1, ah[2], al[2]);
        split(bf(xs + s1 * L::kX + mr1) * w1, ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < TN; ++q) {
          const int nt = ng + q * WG;
          if (nt < NT) {
            const int n = nt * 8 + g;
            mma2_exact_b(du[q], ah, al, bf_bits(bs + s0 * L::kBC + n),
                         bf_bits(bs + s1 * L::kBC + n));
          }
        }
      }
      const float dec = ex2(sb[kBlocks]);
#pragma unroll
      for (int q = 0; q < TN; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[q][e] = fmaf(st[q][e], dec, du[q][e]);
      }
    }
    __syncthreads();                     // att complete; every read of S_prev done

    // y += att . x over keys 0 .. 16(yi + 1): the tiles above the diagonal
    // skipped; k in pairs as for y_inter (keys s0 = 8 kk + 2 tq and s0 + 1),
    // so a row's att hi and lo are one 16-byte load
#pragma unroll
    for (int kk = 0; kk < 2 * kBlocks; ++kk) {
      if (kk < 2 * (yi + 1)) {
        const int s0 = kk * 8 + 2 * tq;
        const uint4 va = *reinterpret_cast<const uint4*>(att + ta * L::kA + 2 * s0);
        const uint4 vb = *reinterpret_cast<const uint4*>(att + tb * L::kA + 2 * s0);
        const uint32_t ah[4] = {va.x, vb.x, va.y, vb.y}, al[4] = {va.z, vb.z, va.w, vb.w};
#pragma unroll
        for (int q = 0; q < YQ; ++q) {
          const int pc = (yh + YG * q) * 8 + g;
          mma2_exact_b(yacc[q], ah, al, bf_bits(xs + s0 * L::kX + pc),
                       bf_bits(xs + (s0 + 1) * L::kX + pc));
        }
      }
    }
    const int tok = c * kC;
#pragma unroll
    for (int q = 0; q < YQ; ++q) {
      const int col = p0 + (yh + YG * q) * 8 + 2 * tq;
      if (tok + ta < p.S)
        *reinterpret_cast<float2*>(
            p.y + ((static_cast<long long>(b) * p.S + tok + ta) * p.H + h) * p.P + col) =
            make_float2(yacc[q][0], yacc[q][1]);
      if (tok + tb < p.S)
        *reinterpret_cast<float2*>(
            p.y + ((static_cast<long long>(b) * p.S + tok + tb) * p.H + h) * p.P + col) =
            make_float2(yacc[q][2], yacc[q][3]);
    }
    // the new state's split, for the next chunk's y_inter
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int c2 = (ng + q * WG) * 8 + 2 * tq;
      if (ng + q * WG < NT) {
        store_pair(S2 + mr0 * L::kS + 2 * c2, st[q][0], st[q][1]);
        store_pair(S2 + mr1 * L::kS + 2 * c2, st[q][2], st[q][3]);
      }
    }

    // the next chunk's scan, by warp 0 (its y rows are sub-chunk 0's, two k
    // steps of att . x): the scan arrays' last reader was this chunk's first
    // phase, and warp 0 copied the next chunk's dt itself
    if (warp == 0 && c + 1 < nchunks) {
      cp_async_wait0();
      __syncwarp();
      chunk_scan(dt_stage(c + 1), a2, sl, sE, sF, sw, sy, sb, lane);
    }
    cp_async_wait0();                    // this thread's copies of chunk c + 1
    __syncthreads();                     // every read of this stage done; chunk c + 1 visible
    if (c + 2 < nchunks) stage_chunk<N, R>(stg, p, x, bm, cm, dt, (c + 2) * kC);
    cp_async_commit();
  }

#pragma unroll
  for (int q = 0; q < TN; ++q) {
    const int c2 = (ng + q * WG) * 8 + 2 * tq;
    if (ng + q * WG < NT) {
      *reinterpret_cast<float2*>(p.state_out + (s_row + mr0) * N + c2) =
          make_float2(st[q][0], st[q][1]);
      *reinterpret_cast<float2*>(p.state_out + (s_row + mr1) * N + c2) =
          make_float2(st[q][2], st[q][3]);
    }
  }
}

template <int N, int R>
int launch(const SsdParams& p, int B, cudaStream_t s) {
  constexpr int bytes = Layout<N, R>::kBytes;     // above 48 KB: opt in once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel<N, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_chunk_kernel<N, R><<<dim3(p.P / R, p.H, B), kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int N, int rows, const SsdParams& p, int B, cudaStream_t s) {
  if (p.P % rows != 0) return -1;
  switch (N * 1000 + rows) {
    case 16016: return launch<16, 16>(p, B, s);
    case 16032: return launch<16, 32>(p, B, s);
    case 16064: return launch<16, 64>(p, B, s);
    case 32016: return launch<32, 16>(p, B, s);
    case 32032: return launch<32, 32>(p, B, s);
    case 32064: return launch<32, 64>(p, B, s);
    case 64016: return launch<64, 16>(p, B, s);
    case 64032: return launch<64, 32>(p, B, s);
    case 64064: return launch<64, 64>(p, B, s);
    default: return -1;
  }
}

}  // namespace chunk

}  // namespace

// dtype: 0 = float32 (ssd_kernel), 1 = bfloat16 x, B and C (ssd_chunk_kernel,
// rows channels per CTA: 16, 32 or 64, dividing P).  P must be a multiple of
// 16 and every x/B/C row 16-byte aligned (the wrapper checks both).
extern "C" int ssd_fwd(int dtype, int N, int rows, const void* x, const void* dt, const void* A,
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
  if (dtype == 1) return chunk::dispatch(N, rows, p, B, s);
  return -1;
}
