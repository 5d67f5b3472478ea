// f32-accurate products on Hopper's tensor cores: the 3xTF32 split, thin
// wrappers for the warp-level mma.sync tile and the warpgroup wgmma tiles,
// and cp.async copies.  Shared by ssd.cu and flash_attention.cu; wkv6.cu
// takes only its cp.async copies and the staging switch.
//
// The split.  A TF32 tensor-core product reads the top 19 bits of each
// operand (sign, 8 exponent bits, 10 of mantissa).  Each f32 operand a
// becomes big = tf32(a), rounded to nearest with ties away from zero (the
// rounding of cvt.rna.tf32.f32, done here by an integer add of half a TF32
// ulp and a mask: ptxas expands cvt.rna into the same two operations
// behind a test for inf and NaN), plus small = a - big, exact in f32, whose
// 13 low bits the tensor core drops (a rounding toward zero to TF32).  Then
//
//   a b ~= big_a big_b + big_a small_b + small_a big_b
//
// with the small_a small_b term dropped.  Error model: |small| <= 2^-11 |a|
// and the tensor core keeps all but 2^-10 of it, so a ~= big + small to
// within 2^-21 |a|, and the dropped term is at most 2^-22 |a b|: about
// 2^-20 of sum |a||b| per product, plus the f32 accumulation the tensor
// core does anyway.  A plain TF32 product (big_a big_b alone) is off by up
// to 2^-11 of sum |a||b|: for a 64-long dot of unit normals, whose
// sum |a||b| is about 41 against a result of about 8, that is up to 2e-2,
// and softmax or an SSD chunk carries errors of that order to the outputs,
// past the 2e-4 to which the kernels are held against their plain f32
// versions (tests/test_torch_tf32x3.py shows one TF32 term failing it).
// The split meets it with room.
//
// Operands that arrived as bf16 are exact in one term: every bf16 value
// is a TF32 value (8 exponent bits, 7 of mantissa), so small is zero and
// the kernels skip its terms at compile time.  A bf16 x bf16 product is
// exact in f32, so a bf16 wgmma is exact up to f32 accumulation.
//
// The three terms run at a third of the TF32 rate: 495 / 3 = 165 TFLOP/s
// on an H100 SXM, against 67 TFLOP/s for f32 outside the tensor cores.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 8, row): a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C, D (16 x 8, f32): c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)
//                       c3 (g+8, 2t+1)
// A wgmma accumulator (64 x 64, f32) holds, in warp w of the warpgroup,
// rows 16w.. in the same C layout for each of its 8 n-tiles.
// The C layout is not the A layout: a C tile that feeds a later product
// as its A operand goes through c_to_a (four pairs of quad shuffles).
//
// Writing code on these tiles.  Put independent mma instructions back
// to back (mma3 runs one term over all n-tiles before the next term), and
// keep tile counts compile-time: a runtime guard puts a branch and a
// WARPSYNC before each HMMA.  `cuobjdump -sass` shows what a source line
// became.  A ptxas warning C7519 means it serialized wgmma around register
// operands.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tf32x3 {

// Ablation switches, for timing the kernels with a part taken out
// (`python3 chip_smoke.py --ablation` builds with -D; the results are then
// wrong, only the times mean something):
//   REPRO_ABLATE_SMALL_TERMS  every 3xTF32 product keeps only big x big;
//   REPRO_ABLATE_PRODUCTS     no mma or wgmma runs (the operands are still
//                             loaded and split: a test on their bits that
//                             never holds keeps them live);
//   REPRO_ABLATE_STAGING      (ssd) no chunk after the first is loaded;
//                             (wkv6) no stretch after the first three
//                             (one a stage) is loaded.
#ifdef REPRO_ABLATE_SMALL_TERMS
constexpr bool kSmallTerms = false;
#else
constexpr bool kSmallTerms = true;
#endif
#ifdef REPRO_ABLATE_STAGING
constexpr bool kStaging = false;
#else
constexpr bool kStaging = true;
#endif

// big of the split: a rounded to nearest TF32, ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// big and small of the split (small's 13 low bits are left for the tensor
// core to drop)
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(a);
  small = __float_as_uint(a - __uint_as_float(big));
}

// 2^x on the special function unit (ex2.approx: relative error about
// 2^-22); the kernels' exponentials are ex2((x - m) log2 e) with x - m <= 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// An operand of type T as TF32 terms: f32 is split, bf16 is exact (its
// f32 bits are already TF32 bits) and has no small term.
template <typename T>
struct Operand {
  static constexpr bool kSplit = true;
};
template <>
struct Operand<__nv_bfloat16> {
  static constexpr bool kSplit = false;
};

template <bool kSplitIt>
__device__ __forceinline__ void terms(float x, uint32_t& big,
                                      uint32_t& small) {
  if constexpr (kSplitIt) {
    split(x, big, small);
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}

// d += a b on one m16n8k8 TF32 tile (not volatile: the compiler may
// schedule it like any arithmetic)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#ifdef REPRO_ABLATE_PRODUCTS
  if (a[0] != 0x7fffffffu) return;
#endif
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a b[j] for the kN n-tiles j (d may hold more), in up to three
// TF32 terms: the small terms first, then big x big; kA / kB say whether
// a / b carry a small term.  Term by term over the tiles, so that
// consecutive mma instructions write different accumulators and do not
// wait on each other.
template <bool kA, bool kB, int kN, int kM>
__device__ __forceinline__ void mma3(float (&d)[kM][4],
                                     const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[kN][2],
                                     const uint32_t (&b_small)[kN][2]) {
  static_assert(kN <= kM, "more b tiles than accumulators");
  if constexpr (kA && kSmallTerms) {
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_tf32(d[j], a_small, b_big[j]);
  }
  if constexpr (kB && kSmallTerms) {
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_tf32(d[j], a_big, b_small[j]);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) mma_tf32(d[j], a_big, b_big[j]);
}

// A compile-time int, for generic lambdas that take their tile counts
template <int kV>
struct Int {
  static constexpr int value = kV;
};

// The A fragment of k-step kk (columns 8kk..8kk+7) from the C fragment c
// of n-tile kk (the same 16 x 8 block in the C layout).
__device__ __forceinline__ void c_to_a(const float (&c)[4], float (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int src = (lane & ~3) | ((lane & 3) >> 1);
  const bool odd = lane & 1;
  const float c00 = __shfl_sync(0xffffffffu, c[0], src);
  const float c01 = __shfl_sync(0xffffffffu, c[1], src);
  const float c02 = __shfl_sync(0xffffffffu, c[2], src);
  const float c03 = __shfl_sync(0xffffffffu, c[3], src);
  const float c20 = __shfl_sync(0xffffffffu, c[0], src + 2);
  const float c21 = __shfl_sync(0xffffffffu, c[1], src + 2);
  const float c22 = __shfl_sync(0xffffffffu, c[2], src + 2);
  const float c23 = __shfl_sync(0xffffffffu, c[3], src + 2);
  a[0] = odd ? c01 : c00;   // (g, t)
  a[1] = odd ? c03 : c02;   // (g+8, t)
  a[2] = odd ? c21 : c20;   // (g, t+4)
  a[3] = odd ? c23 : c22;   // (g+8, t+4)
}

// wgmma (warpgroup, asynchronous): a 64 x 64 f32 tile d (this thread's
// fragment in the C layout above, for the warp's 16 rows: d[j] is n-tile
// j) += A B^T, A [64 rows][K] and B [64 rows][K] both in shared memory in
// the no-swizzle K-major layout: 8-row x 16-byte core matrices, 128 bytes
// each, consecutive along K (lbo = 128 bytes) and sbo bytes apart along
// the rows.  A descriptor holds the tile's shared address, lbo and sbo in
// 16-byte units.  Shared memory written by threads is made visible to the
// tensor cores by fence_proxy_async() before the barrier; d is read only
// after wgmma_wait0().
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile,
                                               uint32_t sbo) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A B^T over K = 8 TF32 values
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], uint64_t a,
                                           uint64_t b) {
#ifdef REPRO_ABLATE_PRODUCTS
  if (a != 1ull) return;
#endif
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B^T over K = 16 bf16 values
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4], uint64_t a,
                                           uint64_t b) {
#ifdef REPRO_ABLATE_PRODUCTS
  if (a != 1ull) return;
#endif
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// cp.async: 16 bytes (src_bytes of them read, the rest zero-filled) and
// 4 bytes, global to shared, then commit and wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

}  // namespace tf32x3
