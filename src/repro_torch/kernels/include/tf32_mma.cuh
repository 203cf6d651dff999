// Pieces of a chunked recurrence on Hopper's tensor cores (sm_90a):
// cp.async staging with zero-fill, ex2, the 3xTF32 split, and mma.sync in
// TF32 (m16n8k8) and bf16 (m16n8k16), both with fp32 accumulation.
//
// 3xTF32: an fp32 operand x is split into hi = x rounded to TF32 (to
// nearest, ties away: cvt.rna.tf32's rounding, done by two integer
// operations) and lo = x - hi rounded the same way; lo.hi + hi.lo + hi.hi
// is about fp32's precision.  An operand that is a bf16 value is exact in
// TF32 (its lo is 0), so a product with one takes two passes, not three.
// The tensor cores' fp32 accumulation is not rounded to nearest: a value
// that must keep fp32's precision over many steps is summed outside them.
//
// Fragments follow PTX's mma.sync layouts: with g = lane / 4, tq = lane % 4,
//   m16n8k8 TF32  A: a0 (g, tq), a1 (g + 8, tq), a2 (g, tq + 4), a3 (g + 8, tq + 4);
//                 B: b0 (k tq, n g), b1 (k tq + 4, n g);
//   m16n8k16 bf16 A: a0 (g, 2tq..2tq+1), a1 (g + 8, ..), a2 (g, 2tq+8..), a3 (g + 8, 2tq+8..);
//                 B: b0 (k 2tq..2tq+1, n g), b1 (k 2tq+8..2tq+9, n g);
//   C/D (both):   c0, c1 (g, 2tq..2tq+1), c2, c3 (g + 8, 2tq..2tq+1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false, 16 zero bytes (src-size 0:
// nothing is read, src only has to be some global address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
// 4 bytes global -> shared, zero-filled the same way
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group of this thread but the most recent one has landed
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// every group of this thread has landed
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x; every x it is given is <= 0, so the result is in [0, 1]
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 to nearest, ties away from zero, as fp32 bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each rounded to TF32: the 3xTF32 split
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b with a split (ah + al) and b exact in TF32: al.b, then ah.b
__device__ __forceinline__ void mma2_exact_b(float (&d)[4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint32_t b0, uint32_t b1) {
  mma_tf32(d, al, b0, b1);
  mma_tf32(d, ah, b0, b1);
}

// d += a * b with a exact in TF32 and b split (bh + bl): a.bl, then a.bh
__device__ __forceinline__ void mma2_exact_a(float (&d)[4], const uint32_t (&a)[4], uint32_t bh0,
                                             uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, a, bl0, bl1);
  mma_tf32(d, a, bh0, bh1);
}

// a bf16 value in shared memory as fp32 (= TF32) bits, and as a float
__device__ __forceinline__ uint32_t bf_bits(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16;
}
__device__ __forceinline__ float bf(const __nv_bfloat16* p) { return __uint_as_float(bf_bits(p)); }
// two adjacent bf16 values (4-byte aligned), as one bf16x2 register
__device__ __forceinline__ uint32_t bf2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two adjacent fp32 values x0, x1, split once for every warp that reads
// them, as the 16 bytes hi(x0), hi(x1), lo(x0), lo(x1) at dst (16-byte
// aligned): what a fragment whose k slots tq and tq + 4 are the pair loads
// in one access
__device__ __forceinline__ void store_pair(uint32_t* dst, float x0, float x1) {
  uint4 v;
  split(x0, v.x, v.z);
  split(x1, v.y, v.w);
  *reinterpret_cast<uint4*>(dst) = v;
}

}  // namespace tf32
