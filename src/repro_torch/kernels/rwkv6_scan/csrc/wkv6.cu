// WKV6 recurrence (RWKV-6 "Finch" time mix) for Hopper (sm_90a), plain C
// interface: wkv6_chunk_kernel for bf16 inputs (tensor cores), wkv6_kernel
// for fp32 (CUDA cores).
//
// Both replace the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py
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
// What bounds it.  Each token and head does about 5 * N^2 flops (r . S is
// 2 N^2; the decay and the rank-1 update 3 N^2) on 4 N input values: at
// the main-path shape of rwkv6-7b (B = 1, S = 2000, H = 64, N = 64, bf16
// r/k/v) 2.62 GFLOP against 115.7 MB read and written.  The bf16 kernel
// runs those flops on the tensor cores in 3xTF32 (495 / 3 = 165 TFLOP/s,
// 0.0159 ms), so the bytes bound it: 0.0346 ms at 3.35 TB/s.  The fp32
// kernel runs them on the CUDA cores: 0.0391 ms at the 67 TFLOP/s fp32
// peak, operations.
//
// bf16: wkv6_chunk_kernel<N, VC>, the TPU kernel's chunked recurrence.
// A serial token loop is one dependent chain of decays and updates per
// state element (the fp32 kernel below: about 700 cycles a token).  Here,
// as on the TPU, the sequence goes in chunks of C = 64 tokens: within a
// chunk every product is a matrix product, and only the (N, N) state is
// carried from chunk to chunk.
//
//   Grid.  One CTA per (slice of VC value columns, head, batch): the
//   state's columns are independent.  The wrapper picks VC (kernel.py
//   chunk_cols): the most slices, none under 16 columns, that keep the
//   CTAs within one per SM -- 2 slices of 32 (128 CTAs) at B = 1, H = 64;
//   one of 64 (512 CTAs) at B = 8.  8 warps, 256 threads.
//
//   Staging.  r, k, v (its VC columns) and logw of a chunk go to shared
//   memory by 16-byte cp.async through a 2-stage ring, the next chunk's
//   copies in flight during this chunk's work.  A row at or past S is
//   zero-filled through cp.async's src-size operand, never skipped: logw
//   = 0 is a decay of 1 and k = 0 adds nothing, so the state passes
//   through; y rows past S are not stored.  r, k, v are read in place
//   (batch and sequence strides, (H, N) dense); the wrapper raises for a
//   view that a 16-byte copy cannot read.
//
//   Exponents, all <= 0 by construction.  Per chunk and channel the
//   inclusive cumsum cum of logw (in log2 units) is taken in order and
//   stored; a_t = cum_{t-1} (a_0 = 0) is the stored value itself, never
//   cum - w.  Every exponent below is the difference of two stored
//   cumsums whose order is known (logw <= 0, and fp32 rounding keeps the
//   stored sums non-increasing), so nothing overflows at any decay.  With
//   b_i = cum at the token before 16-token sub-chunk i:
//     R[t] = r_t o 2^(a_t - b_i), t in sub-chunk i;
//     K[s] = k_s o 2^(b_(j+1) - cum_s), s in sub-chunk j;
//     y_inter = (R o 2^b_i) . S_prev;
//     scores A[t, s] for s in an earlier sub-chunk j < i:
//       (R_i o 2^(b_i - b_(j+1))) . K_j^T;
//     within a sub-chunk: the lower-left 8x8 tile relative to b' = the
//       cum before its second half, (r o 2^(a - b')) . (k o 2^(b' - cum))^T;
//       the two 8x8 diagonal blocks pairwise on the CUDA cores,
//       sum_n r_t k_s 2^(a_t - cum_s) for s < t, as the TPU kernel does for
//       its whole chunk; the u-bonus sum_n r_t u k_t on the diagonal;
//     y += A . V (y_intra and the bonus);
//     S <- 2^(cum_end) o S + (K o 2^(cum_end - b_(j+1)))^T . V.
//   The factors 2^(b_i), 2^(b_i - b_(j+1)) and 2^(cum_end - b_(j+1)) are
//   per channel, each <= 1, so every product of factors stays in [0, 1].
//
//   Products.  mma.sync.m16n8k8 in TF32 with fp32 accumulate, in 3xTF32:
//   each operand x is split into hi = x rounded to TF32 (to nearest, ties
//   away: cvt.rna.tf32's rounding, done by two integer operations) and lo
//   = x - hi rounded the same way, and lo.hi + hi.lo + hi.hi is summed,
//   about fp32's precision: r, k and the state scaled by decays are not
//   exact in bf16 or TF32, and a single pass keeps only 8 or 11 bits of
//   each.  V (bf16) is exact in TF32, so its lo is 0 and the hi.lo term
//   of a product with V is not issued.
//
//   Warps.  Warp w < 4 is sub-chunk w's diagonal warp: its 16x16 diagonal
//   block of the scores, then one m16 tile of the state (its VC columns)
//   through the update, the state living in its registers.  Warp 4 + i is
//   sub-chunk i's row warp: one or two of the six off-diagonal score tiles
//   ((3,0) (3,1) | (3,2) (2,1) | (2,0) | (1,0)), y_inter for its rows,
//   then y_intra, balanced to 5 k-steps each by having the row warps of
//   sub-chunks 0 and 1 compute part of 3's and 2's into a partial the
//   owner adds after a barrier of the pair.  Per chunk: the scan (256 / N
//   threads per channel, each summing its tokens in order; after a
//   barrier, the offsets, the stored cumsums, R, K and the factor table),
//   a barrier, the scores and y_inter, a barrier, the update and y_intra,
//   a barrier, the next chunk's copies.  The state is kept in shared
//   memory already split into TF32 hi and lo, since all four row warps
//   read it.
//
//   Build (nvcc -Xptxas -v, sm_90a): no spills; registers (N, VC) = (64,
//   64) 188, (64, 32) 151, (64, 16) 134, (32, 32) 106, (32, 16) 94, (16,
//   16) 72; dynamic shared memory 193,312 / 164,640 / 150,304 / 103,328 /
//   93,088 / 64,480 bytes (Layout::kBytes), so one CTA per SM.
//
//   What limits it: 0.2032 ms at B = 1, S = 2000 (attention_timing.py,
//   queued, on an NVIDIA H100 80GB HBM3 at 700 W), 5.9x its bound.  One
//   CTA per SM and four barrier-separated phases per chunk, each as long
//   as its slowest warp; whether shared-memory traffic, instruction issue
//   from two warps per SM quarter or the chains of dependent loads,
//   exponentials and mma.sync bind is not measured.
//
// fp32: wkv6_kernel<float, N>.  The time loop is serial inside the CTA,
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
// tokens predicated off, so any S is taken.  Numerics: fp32 throughout;
// the decay is expf (not __expf) because it is applied to a state that
// lives for thousands of steps.  The sums run in another order than the
// plain version's, within fp32 rounding.
//
// The entry point returns cudaGetLastError() after its launch (or -1 for
// an unsupported dtype, N or column slice), so a refused launch is
// reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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


// ---------------------------------------------------------------------------
// bf16: the chunked recurrence on the tensor cores
// ---------------------------------------------------------------------------

namespace chunk {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                   // tokens per chunk, the TPU kernel's
constexpr int kSub = 16;                 // tokens per sub-chunk (an m16 tile of rows)
constexpr int kBlocks = kC / kSub;       // 4 sub-chunks
constexpr int kWarps = 2 * kBlocks;      // 8: a diagonal warp and a row warp per sub-chunk
constexpr int kThreads = 32 * kWarps;    // 256
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA, in bytes: a 2-stage ring of r, k (bf16, rows
// of N + 8), v (bf16, VC + 8) and logw (fp32, N + 4, with a leading row of
// zeros); the chunk's scaled operands R and K (fp32, N + 4); per-channel
// factors (fp32, 12 rows of N); the state split into TF32 hi and lo
// (VC + 8 each); the chunk's scores (fp32, kC + 4); two row warps' partial
// y (fp32, 16 rows of VC + 8 each); u (fp32); the cumsum's part totals
// (fp32, one per thread).  The paddings put most fragment loads in distinct banks; every
// row stays a multiple of 16 bytes for cp.async and the vector loads.
template <int N, int VC>
struct Layout {
  static constexpr int kRK = N + 8;
  static constexpr int kV = VC + 8;
  static constexpr int kW = N + 4;
  static constexpr int kS = VC + 8;
  static constexpr int kA = kC + 4;
  static constexpr int kRBytes = kC * kRK * 2;
  static constexpr int kVBytes = kC * kV * 2;
  static constexpr int kWBytes = (kC + 1) * kW * 4;
  static constexpr int kStage = 2 * kRBytes + kVBytes + kWBytes;
  static constexpr int kOpOff = 2 * kStage;                 // R, then K: kC rows of kW
  static constexpr int kFacOff = kOpOff + 2 * kC * kW * 4;  // kFactors rows of N
  static constexpr int kStateOff = kFacOff + 12 * N * 4;
  static constexpr int kScoreOff = kStateOff + 2 * N * kS * 4;
  static constexpr int kPartOff = kScoreOff + kC * kA * 4;
  static constexpr int kUOff = kPartOff + 2 * kSub * kS * 4;
  static constexpr int kTotOff = kUOff + N * 4;
  static constexpr int kBytes = kTotOff + kThreads * 4;
  static_assert(kRBytes % 16 == 0 && kVBytes % 16 == 0 && kWBytes % 16 == 0, "16-byte rows");
};

// Rows of the per-channel factor table, each exp of a difference of stored
// cumsums (b_i = cum at the token before sub-chunk i, b_0 = 0, b_4 = the
// chunk's last cumsum), every one <= 0:
//   kEb + i   2^(b_i), i = 0..4 (i = 4: the chunk's decay of the state)
//   kF + j    2^(b_4 - b_(j+1)), j = 0..3
//   kM + x    2^(b_i - b_(j+1)) for the tiles (i, j) = (2, 0), (3, 0), (3, 1)
constexpr int kEb = 0, kF = 5, kM = 9;

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
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 2^x; every x here is <= 0, so the result is in [0, 1]
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32's
// rounding, which costs more as an instruction), as fp32 bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, each rounded to TF32: the 3xTF32 split
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// two adjacent state values, split once for every warp that reads them
__device__ __forceinline__ void store_split(uint32_t* hi, uint32_t* lo, int at, float x0,
                                            float x1) {
  uint2 h, l;
  split(x0, h.x, l.x);
  split(x1, h.y, l.y);
  *reinterpret_cast<uint2*>(hi + at) = h;
  *reinterpret_cast<uint2*>(lo + at) = l;
}

// d += a * b in 3xTF32: lo.hi + hi.lo + hi.hi, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// d += a * v with v a bf16 value, exact in TF32: v's lo is 0, so of the
// three 3xTF32 terms lo.hi + hi.lo + hi.hi the middle one adds exact zeros
// and is not issued
__device__ __forceinline__ void mma3_exact_b(float (&d)[4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint32_t b0, uint32_t b1) {
  mma_tf32(d, al, b0, b1);
  mma_tf32(d, ah, b0, b1);
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }
// a bf16 value as fp32 (= TF32) bits
__device__ __forceinline__ uint32_t bf_bits(const bf16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16;
}
// 4 bf16 (8-byte aligned) as fp32
__device__ __forceinline__ void bf4(const bf16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(x.x << 16);
  out[1] = __uint_as_float(x.x & 0xffff0000u);
  out[2] = __uint_as_float(x.y << 16);
  out[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void f4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
// PW (2 or 4) values as fp32, PW-aligned
template <int PW> __device__ __forceinline__ void ld_f(const float* p, float* out) {
  if constexpr (PW == 4) {
    f4(p, out);
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}
template <int PW> __device__ __forceinline__ void ld_bf(const bf16* p, float* out) {
  if constexpr (PW == 4) {
    bf4(p, out);
  } else {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(x << 16);
    out[1] = __uint_as_float(x & 0xffff0000u);
  }
}

// Stage the chunk of tokens [t0, t0 + kC) into one ring stage: every row
// is copied, and a row at or past S is zero-filled (r = k = v = 0, logw =
// 0: a decay of 1 that adds nothing, so the state passes through).
template <int W, class Src>
__device__ __forceinline__ void stage_rows(void* dst, int dst_stride, const Src* src,
                                           long long src_stride, int t0, int S) {
  constexpr int kPieces = W * static_cast<int>(sizeof(Src)) / 16;   // per row
  constexpr int kElems = 16 / static_cast<int>(sizeof(Src));
#pragma unroll
  for (int i = 0; i < (kC * kPieces + kThreads - 1) / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads, t = u / kPieces, c = u % kPieces;
    if (kC * kPieces % kThreads != 0 && u >= kC * kPieces) break;
    const bool in = t0 + t < S;
    cp_async16(static_cast<Src*>(dst) + t * dst_stride + c * kElems,
               src + (in ? t0 + t : 0) * src_stride + c * kElems, in);
  }
}

template <int N, int VC>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const Wkv6Params& p,
                                            const bf16* r, const bf16* k, const bf16* v,
                                            const float* w, int t0) {
  using L = Layout<N, VC>;
  bf16* rs = reinterpret_cast<bf16*>(st);
  stage_rows<N>(rs, L::kRK, r, p.r_ss, t0, p.S);
  stage_rows<N>(rs + kC * L::kRK, L::kRK, k, p.k_ss, t0, p.S);
  stage_rows<VC>(rs + 2 * kC * L::kRK, L::kV, v, p.v_ss, t0, p.S);
  stage_rows<N>(reinterpret_cast<float*>(st + 2 * L::kRBytes + L::kVBytes) + L::kW, L::kW, w,
                p.w_ss, t0, p.S);
}

// The per-chunk pass over the staged logw, r and k, in two halves around
// a barrier.  P = kThreads / N threads share a channel: thread (q, n) takes
// tokens [q Lq, q Lq + Lq) of channel n (a warp's lanes take consecutive
// channels of one part, so their rows share no bank).
//   scan_local: the inclusive cumsum of its tokens' logw in log2 units, in
//   order, into registers; its total into tot.
//   scan_store (after the barrier): the offsets o_0 = 0, o_{p+1} = o_p +
//   tot_p, each rounded once, the same operations in every thread; the
//   cumsums o_q + local, stored in place of logw (row t + 1 = cum_t), so
//   part q's last cumsum is o_{q+1} itself and every channel's cumsums are
//   non-increasing as stored; b_i = o at sub-chunk i's first token; then
//   the scaled operands R[t] = r_t o 2^(a_t - b_i) (t in sub-chunk i: a_t
//   <= b_i) and K[s] = k_s o 2^(b_(j+1) - cum_s) (s in sub-chunk j: cum_s
//   >= b_(j+1)), a_t the stored cum_{t-1} itself; and the factor table.
template <int N>
struct ChunkScan {
  static constexpr int P = kThreads / N, Lq = kC / P;
  static_assert(kThreads % N == 0 && kC % P == 0 && kSub % Lq == 0,
                "whole parts, each inside one sub-chunk");
  float loc[Lq];

  __device__ __forceinline__ void scan_local(const float* cs, int kW, float* tot) {
    const int n = threadIdx.x % N, q = threadIdx.x / N;
    const float* col = cs + (1 + q * Lq) * kW + n;
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < Lq; ++j) {
      run = fmaf(col[j * kW], kLog2e, run);
      loc[j] = run;
    }
    tot[q * N + n] = run;
  }

  __device__ __forceinline__ void scan_store(float* cs, int kW, const bf16* rs, const bf16* ks,
                                             int kRK, float* R_s, float* K_s, float* fac,
                                             const float* tot) {
    const int n = threadIdx.x % N, q = threadIdx.x / N;
    float off = 0.f, acc = 0.f, ob[kBlocks + 1];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p == q) off = acc;                        // o_q
      if (p * Lq % kSub == 0) ob[p * Lq / kSub] = acc;
      acc = p == 0 ? tot[n] : acc + tot[p * N + n];
    }
    ob[kBlocks] = acc;                              // the chunk's last cumsum
    const int i = q * Lq / kSub;
    float bi = ob[0], bn = ob[1];
#pragma unroll
    for (int x = 1; x < kBlocks; ++x)
      if (i == x) { bi = ob[x]; bn = ob[x + 1]; }
    float prev = off;                               // a of the part's first token
#pragma unroll
    for (int j = 0; j < Lq; ++j) {
      const int t = q * Lq + j;
      const float cm = off + loc[j];
      cs[(t + 1) * kW + n] = cm;
      R_s[t * kW + n] = __bfloat162float(rs[t * kRK + n]) * ex2(prev - bi);
      K_s[t * kW + n] = __bfloat162float(ks[t * kRK + n]) * ex2(bn - cm);
      prev = cm;
    }
    // factor row x is 2^(b_hi - b_lo): rows kEb + i (hi i, lo 0), kF + j
    // (4, j + 1), kM + 0..2 for the tiles (2, 0), (3, 0), (3, 1): (2, 1),
    // (3, 1), (3, 2)
#pragma unroll
    for (int x = 0; x < kM + 3; ++x) {
      if (x % P == q) {
        const int hi = x < kF ? x : x < kM ? 4 : (x == kM ? 2 : 3);
        const int lo = x < kF ? 0 : x < kM ? x - kF + 1 : (x == kM + 2 ? 2 : 1);
        fac[x * N + n] = ex2(ob[hi] - ob[lo]);
      }
    }
  }
};

// acc += A[rows ta, tb; keys 8 kk0 .. 8 kk1) . V, the keys' k steps in turn
template <int N, int VC>
__device__ __forceinline__ void intra(float (&acc)[VC / 8][4], const float* A_s, const bf16* vs,
                                      int ta, int tb, int kk0, int kk1, int g, int tq) {
  using L = Layout<N, VC>;
#pragma unroll
  for (int kk = 0; kk < kC / 8; ++kk) {
    if (kk >= kk0 && kk < kk1) {
      const int s0 = kk * 8 + tq, s1 = s0 + 4;
      uint32_t ah[4], al[4];
      split(A_s[ta * L::kA + s0], ah[0], al[0]);
      split(A_s[tb * L::kA + s0], ah[1], al[1]);
      split(A_s[ta * L::kA + s1], ah[2], al[2]);
      split(A_s[tb * L::kA + s1], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < VC / 8; ++nt)
        mma3_exact_b(acc[nt], ah, al, bf_bits(vs + s0 * L::kV + nt * 8 + g),
                     bf_bits(vs + s1 * L::kV + nt * 8 + g));
    }
  }
}

// a barrier of the two row warps of a pair (64 threads, named barrier id)
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}

// One CTA per (value-column slice of VC, head, batch); 8 warps.  Warp w < 4
// is sub-chunk w's diagonal warp (the scores within the sub-chunk) and
// then owns state tiles; warp 4 + i is sub-chunk i's row warp (the
// off-diagonal score tiles, then y for its 16 rows).
template <int N, int VC>
__global__ void __launch_bounds__(kThreads, 1) wkv6_chunk_kernel(const Wkv6Params p) {
  using L = Layout<N, VC>;
  constexpr int NT = VC / 8;             // n8 tiles of the value columns
  constexpr int KN = N / 8;              // k8 steps over the channels
  constexpr int NQ = N / 8;              // channels per lane in the pairwise pass,
  constexpr int PW = NQ < 4 ? NQ : 4;    // in pieces of PW
  constexpr int MT = N / 16;             // m16 tiles of the state's rows
  static_assert(kBlocks % MT == 0, "state rows over the diagonal warps");
  constexpr int WN = kBlocks / MT;       // warps sharing an m-tile
  constexpr int TN = (NT + WN - 1) / WN; // n-tiles of the state per warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* R_s = reinterpret_cast<float*>(smem + L::kOpOff);
  float* K_s = R_s + kC * L::kW;
  float* fac = reinterpret_cast<float*>(smem + L::kFacOff);
  uint32_t* S_hi = reinterpret_cast<uint32_t*>(smem + L::kStateOff);
  uint32_t* S_lo = S_hi + N * L::kS;
  float* Y_x = reinterpret_cast<float*>(smem + L::kPartOff);
  float* A_s = reinterpret_cast<float*>(smem + L::kScoreOff);
  float* u_s = reinterpret_cast<float*>(smem + L::kUOff);
  float* tot = reinterpret_cast<float*>(smem + L::kTotOff);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const bool diag_warp = warp < kBlocks;
  const int blk = warp % kBlocks, t0 = blk * kSub;   // this warp's sub-chunk
  const int col0 = blockIdx.x * VC, h = blockIdx.y, b = blockIdx.z;
  const bf16* r = static_cast<const bf16*>(p.r) + b * p.r_sb + h * N;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * N;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * N + col0;
  const float* w = p.logw + b * p.w_sb + h * N;
  const int nchunks = (p.S + kC - 1) / kC;

  stage_chunk<N, VC>(smem, p, r, k, v, w, 0);
  cp_async_commit();
  if (nchunks > 1) stage_chunk<N, VC>(smem + L::kStage, p, r, k, v, w, kC);
  cp_async_commit();

  for (int n = threadIdx.x; n < N; n += kThreads) {
    u_s[n] = __bfloat162float(static_cast<const bf16*>(p.u)[h * N + n]);
    // row 0 of each stage's logw: the a_0 = 0 that every chunk starts from
    reinterpret_cast<float*>(smem + 2 * L::kRBytes + L::kVBytes)[n] = 0.f;
    reinterpret_cast<float*>(smem + L::kStage + 2 * L::kRBytes + L::kVBytes)[n] = 0.f;
  }

  // the state tiles a diagonal warp owns, in the m16n8 accumulator layout:
  // rows mr0 = mt*16 + g and mr0 + 8, columns (nt0 + q*WN)*8 + 2*tq, +1
  const int mt = blk % MT, nt0 = blk / MT;
  const int mr0 = mt * 16 + g, mr1 = mr0 + 8;
  float st[TN][4];
  const long long s_row = (static_cast<long long>(b) * p.H + h) * N;
#pragma unroll
  for (int q = 0; q < TN; ++q) {
    const int c = (nt0 + q * WN) * 8 + 2 * tq;
    st[q][0] = st[q][1] = st[q][2] = st[q][3] = 0.f;
    if (diag_warp && nt0 + q * WN < NT) {
      if (p.state0 != nullptr) {
        const float2 x0 = *reinterpret_cast<const float2*>(p.state0 + (s_row + mr0) * N + col0 + c);
        const float2 x1 = *reinterpret_cast<const float2*>(p.state0 + (s_row + mr1) * N + col0 + c);
        st[q][0] = x0.x; st[q][1] = x0.y; st[q][2] = x1.x; st[q][3] = x1.y;
      }
      store_split(S_hi, S_lo, mr0 * L::kS + c, st[q][0], st[q][1]);
      store_split(S_hi, S_lo, mr1 * L::kS + c, st[q][2], st[q][3]);
    }
  }

  const int ta = t0 + g, tb = ta + 8;    // a lane's rows in A and C fragments
  for (int c = 0; c < nchunks; ++c) {
    unsigned char* stg = smem + (c & 1) * L::kStage;
    const bf16* rs = reinterpret_cast<const bf16*>(stg);
    const bf16* ks = rs + kC * L::kRK;
    const bf16* vs = ks + kC * L::kRK;
    // cs row t = cum_{t-1} = a_t (row 0 = 0), row t + 1 = cum_t; row 16i =
    // b_i, row kC = the chunk's last cumsum
    float* cs = reinterpret_cast<float*>(stg + 2 * L::kRBytes + L::kVBytes);
    cp_async_wait1();                    // this chunk's copies (the next may be in flight)
    __syncthreads();                     // everyone's copies, and the state, visible
    ChunkScan<N> scan;
    scan.scan_local(cs, L::kW, tot);
    __syncthreads();
    scan.scan_store(cs, L::kW, rs, ks, L::kRK, R_s, K_s, fac, tot);
    __syncthreads();

    float yacc[NT][4];
    if (diag_warp) {
      // Sub-chunk blk's 16x16 diagonal block of the scores.  Its lower-left
      // 8x8 tile (rows t0+8.., keys t0..t0+7) on the tensor cores relative
      // to b' = cum_{t0+7}: (r o 2^(a - b')) . (k o 2^(b' - cum))^T, rows
      // 0-7 of the m16 tile zero.
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};   // even, odd k steps
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        const int n0 = kk * 8 + tq, n1 = n0 + 4;
        const float* bp = cs + (t0 + 8) * L::kW;
        uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
        split(bf(rs + tb * L::kRK + n0) * ex2(cs[tb * L::kW + n0] - bp[n0]), ah[1], al[1]);
        split(bf(rs + tb * L::kRK + n1) * ex2(cs[tb * L::kW + n1] - bp[n1]), ah[3], al[3]);
        uint32_t bh[2], bl[2];
        split(bf(ks + ta * L::kRK + n0) * ex2(bp[n0] - cs[(ta + 1) * L::kW + n0]), bh[0], bl[0]);
        split(bf(ks + ta * L::kRK + n1) * ex2(bp[n1] - cs[(ta + 1) * L::kW + n1]), bh[1], bl[1]);
        mma3(sc[kk % 2], ah, al, bh, bl);
      }
      *reinterpret_cast<float2*>(A_s + tb * L::kA + t0 + 2 * tq) =
          make_float2(sc[0][2] + sc[1][2], sc[0][3] + sc[1][3]);

      // the two 8x8 diagonal blocks pairwise on the CUDA cores, one after
      // the other: A[t, s] = sum_n r_t k_s 2^(a_t - cum_s) for s < t;
      // A[t, t] = sum_n r_t u k_t (the bonus).  Lane (rp, cg) takes rows t1
      // = rp and t2 = 7 - rp of the block (7 pairs in all, the same for
      // every lane) over channel pieces cg, cg + 8, .. of PW channels; a
      // quarter warp (one rp) reads 8 consecutive pieces of one row, so no
      // two of its lanes share a bank; the 8 lanes of a row sum by three
      // shuffles.
      const int rp = lane / 8, cg = lane % 8;
#pragma unroll 1
      for (int hb = 0; hb < 2; ++hb) {
        const int s0 = t0 + 8 * hb, t1 = s0 + rp, t2 = s0 + 7 - rp;
        float r1[NQ], a1[NQ], r2[NQ], a2[NQ], k1[NQ], k2[NQ];
#pragma unroll
        for (int m = 0; m < NQ / PW; ++m) {
          const int c = (m * 8 + cg) * PW;
          ld_bf<PW>(rs + t1 * L::kRK + c, r1 + m * PW);
          ld_bf<PW>(rs + t2 * L::kRK + c, r2 + m * PW);
          ld_bf<PW>(ks + t1 * L::kRK + c, k1 + m * PW);
          ld_bf<PW>(ks + t2 * L::kRK + c, k2 + m * PW);
          ld_f<PW>(cs + t1 * L::kW + c, a1 + m * PW);
          ld_f<PW>(cs + t2 * L::kW + c, a2 + m * PW);
        }
        float bo1 = 0.f, bo2 = 0.f;
#pragma unroll
        for (int e = 0; e < NQ; ++e) {
          const float ue = u_s[((e / PW) * 8 + cg) * PW + e % PW];
          bo1 = fmaf(r1[e] * ue, k1[e], bo1);
          bo2 = fmaf(r2[e] * ue, k2[e], bo2);
        }
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          const bool first = j < rp;
          const int s = s0 + (first ? j : j - rp), t = first ? t1 : t2;
          float kv[NQ], cv[NQ];
#pragma unroll
          for (int m = 0; m < NQ / PW; ++m) {
            const int c = (m * 8 + cg) * PW;
            ld_bf<PW>(ks + s * L::kRK + c, kv + m * PW);
            ld_f<PW>(cs + (s + 1) * L::kW + c, cv + m * PW);
          }
          float acc[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < NQ; ++e)
            acc[e % 2] = fmaf((first ? r1[e] : r2[e]) * kv[e],
                              ex2((first ? a1[e] : a2[e]) - cv[e]), acc[e % 2]);
          float x = acc[0] + acc[1];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          if (cg == 0) A_s[t * L::kA + s] = x;
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          bo1 += __shfl_xor_sync(0xffffffffu, bo1, o);
          bo2 += __shfl_xor_sync(0xffffffffu, bo2, o);
        }
        if (cg == 0) {
          A_s[t1 * L::kA + t1] = bo1;
          A_s[t2 * L::kA + t2] = bo2;
        }
      }
      // zeros above the diagonal of the 16x16 block
#pragma unroll
      for (int e = 0; e < kSub * kSub / 32; ++e) {
        const int x = lane + 32 * e, i = x / kSub, j = x % kSub;
        if (j > i) A_s[(t0 + i) * L::kA + t0 + j] = 0.f;
      }
    } else {
      // Row warp of sub-chunk blk.  The off-diagonal score tiles A[i, j],
      // j < i: (R_i o 2^(b_i - b_(j+1))) . K_j^T, the factor 1 for j = i-1;
      // the six tiles over the four row warps as (3,0) (3,1) | (3,2) (2,1)
      // | (2,0) | (1,0).
      const int tiles = blk < 2 ? 2 : 1;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (x < tiles) {
          const int ti = blk == 0 ? 3 : blk == 1 ? (x == 0 ? 3 : 2) : blk == 2 ? 2 : 1;
          const int tj = blk == 0 ? x : blk == 1 ? (x == 0 ? 2 : 1) : 0;
          const int mrow = ti == 2 ? kM + 0 : (tj == 0 ? kM + 1 : kM + 2);
          const bool scaled = tj < ti - 1;
          const int ra = ti * kSub + g, rb = ra + 8;
          float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < KN; ++kk) {
            const int n0 = kk * 8 + tq, n1 = n0 + 4;
            uint32_t ah[4], al[4];
            split(R_s[ra * L::kW + n0], ah[0], al[0]);
            split(R_s[rb * L::kW + n0], ah[1], al[1]);
            split(R_s[ra * L::kW + n1], ah[2], al[2]);
            split(R_s[rb * L::kW + n1], ah[3], al[3]);
            const float m0 = scaled ? fac[mrow * N + n0] : 1.f;
            const float m1 = scaled ? fac[mrow * N + n1] : 1.f;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int s = tj * kSub + nt * 8 + g;
              uint32_t bh[2], bl[2];
              split(K_s[s * L::kW + n0] * m0, bh[0], bl[0]);
              split(K_s[s * L::kW + n1] * m1, bh[1], bl[1]);
              mma3(sc[nt], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = tj * kSub + nt * 8 + 2 * tq;
            *reinterpret_cast<float2*>(A_s + ra * L::kA + col) = make_float2(sc[nt][0], sc[nt][1]);
            *reinterpret_cast<float2*>(A_s + rb * L::kA + col) = make_float2(sc[nt][2], sc[nt][3]);
          }
        }
      }

      // y_inter = (R o 2^b_i) . S_prev for this warp's 16 rows
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) yacc[nt][0] = yacc[nt][1] = yacc[nt][2] = yacc[nt][3] = 0.f;
      const float* eb = fac + (kEb + blk) * N;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        const int n0 = kk * 8 + tq, n1 = n0 + 4;
        uint32_t ah[4], al[4];
        split(R_s[ta * L::kW + n0] * eb[n0], ah[0], al[0]);
        split(R_s[tb * L::kW + n0] * eb[n0], ah[1], al[1]);
        split(R_s[ta * L::kW + n1] * eb[n1], ah[2], al[2]);
        split(R_s[tb * L::kW + n1] * eb[n1], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t bh[2] = {S_hi[n0 * L::kS + nt * 8 + g], S_hi[n1 * L::kS + nt * 8 + g]};
          const uint32_t bl[2] = {S_lo[n0 * L::kS + nt * 8 + g], S_lo[n1 * L::kS + nt * 8 + g]};
          mma3(yacc[nt], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();                     // the scores complete; every read of S_prev done

    if (diag_warp) {
      // S <- 2^b_4 o S + (K o 2^(b_4 - b_(j+1)))^T . V on this warp's tiles
      const float d0 = fac[(kEb + 4) * N + mr0], d1 = fac[(kEb + 4) * N + mr1];
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        st[q][0] *= d0; st[q][1] *= d0; st[q][2] *= d1; st[q][3] *= d1;
      }
#pragma unroll
      for (int kk = 0; kk < kC / 8; ++kk) {
        const int s0 = kk * 8 + tq, s1 = s0 + 4;
        const float* f = fac + (kF + kk / 2) * N;   // keys s0, s1 lie in sub-chunk kk / 2
        uint32_t ah[4], al[4];
        split(K_s[s0 * L::kW + mr0] * f[mr0], ah[0], al[0]);
        split(K_s[s0 * L::kW + mr1] * f[mr1], ah[1], al[1]);
        split(K_s[s1 * L::kW + mr0] * f[mr0], ah[2], al[2]);
        split(K_s[s1 * L::kW + mr1] * f[mr1], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < TN; ++q) {
          const int nt = nt0 + q * WN;
          if (nt < NT)
            mma3_exact_b(st[q], ah, al, bf_bits(vs + s0 * L::kV + nt * 8 + g),
                         bf_bits(vs + s1 * L::kV + nt * 8 + g));
        }
      }
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int c2 = (nt0 + q * WN) * 8 + 2 * tq;
        if (nt0 + q * WN < NT) {
          store_split(S_hi, S_lo, mr0 * L::kS + c2, st[q][0], st[q][1]);
          store_split(S_hi, S_lo, mr1 * L::kS + c2, st[q][2], st[q][3]);
        }
      }
    } else {
      // y += A[t, 0 .. t0 + 16) . V (y_intra and the bonus).  Sub-chunk i
      // has 2(i+1) k steps; the row warps of sub-chunks 0 and 1 also take
      // the first 3 of sub-chunk 3's and the first 1 of sub-chunk 2's, into
      // a partial that the owner adds after a barrier of the pair, so each
      // row warp runs 5 k steps.
      const int helps = 3 - blk;                       // the sub-chunk a light warp helps
      const int own0 = blk == 3 ? 3 : blk == 2 ? 1 : 0, own1 = 2 * (blk + 1);
      intra<N, VC>(yacc, A_s, vs, ta, tb, own0, own1, g, tq);
      if (blk < 2) {
        float xacc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) xacc[nt][0] = xacc[nt][1] = xacc[nt][2] = xacc[nt][3] = 0.f;
        const int xa = helps * kSub + g;
        intra<N, VC>(xacc, A_s, vs, xa, xa + 8, 0, blk == 0 ? 3 : 1, g, tq);
        float* part = Y_x + blk * kSub * L::kS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          *reinterpret_cast<float2*>(part + g * L::kS + nt * 8 + 2 * tq) =
              make_float2(xacc[nt][0], xacc[nt][1]);
          *reinterpret_cast<float2*>(part + (g + 8) * L::kS + nt * 8 + 2 * tq) =
              make_float2(xacc[nt][2], xacc[nt][3]);
        }
      }
      pair_sync(blk < 2 ? 1 + blk : 1 + helps);        // pairs (0, 3) and (1, 2)
      if (blk >= 2) {
        const float* part = Y_x + helps * kSub * L::kS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 x0 = *reinterpret_cast<const float2*>(part + g * L::kS + nt * 8 + 2 * tq);
          const float2 x1 =
              *reinterpret_cast<const float2*>(part + (g + 8) * L::kS + nt * 8 + 2 * tq);
          yacc[nt][0] += x0.x; yacc[nt][1] += x0.y; yacc[nt][2] += x1.x; yacc[nt][3] += x1.y;
        }
      }
      const int tok = c * kC;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cc = col0 + nt * 8 + 2 * tq;
        if (tok + ta < p.S)
          *reinterpret_cast<float2*>(
              p.y + ((static_cast<long long>(b) * p.S + tok + ta) * p.H + h) * N + cc) =
              make_float2(yacc[nt][0], yacc[nt][1]);
        if (tok + tb < p.S)
          *reinterpret_cast<float2*>(
              p.y + ((static_cast<long long>(b) * p.S + tok + tb) * p.H + h) * N + cc) =
              make_float2(yacc[nt][2], yacc[nt][3]);
      }
    }

    __syncthreads();                     // every read of this stage done
    if (c + 2 < nchunks) stage_chunk<N, VC>(stg, p, r, k, v, w, (c + 2) * kC);
    cp_async_commit();
  }

  if (diag_warp) {
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int c2 = (nt0 + q * WN) * 8 + 2 * tq;
      if (nt0 + q * WN < NT) {
        *reinterpret_cast<float2*>(p.state_out + (s_row + mr0) * N + col0 + c2) =
            make_float2(st[q][0], st[q][1]);
        *reinterpret_cast<float2*>(p.state_out + (s_row + mr1) * N + col0 + c2) =
            make_float2(st[q][2], st[q][3]);
      }
    }
  }
}

template <int N, int VC>
int launch(const Wkv6Params& p, int B, cudaStream_t s) {
  constexpr int bytes = Layout<N, VC>::kBytes;   // above 48 KB: opt in once
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_chunk_kernel<N, VC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  wkv6_chunk_kernel<N, VC><<<dim3(N / VC, p.H, B), kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int N, int cols, const Wkv6Params& p, int B, cudaStream_t s) {
  switch (N * 1000 + cols) {
    case 16016: return launch<16, 16>(p, B, s);
    case 32016: return launch<32, 16>(p, B, s);
    case 32032: return launch<32, 32>(p, B, s);
    case 64016: return launch<64, 16>(p, B, s);
    case 64032: return launch<64, 32>(p, B, s);
    case 64064: return launch<64, 64>(p, B, s);
    default: return -1;
  }
}

}  // namespace chunk

}  // namespace

extern "C" int wkv6_fwd(int dtype, int N, int cols, const void* r, const void* k, const void* v,
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
  if (dtype == 1) return chunk::dispatch(N, cols, p, B, s);
  return -1;
}
