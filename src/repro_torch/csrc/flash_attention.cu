// Causal or non-causal GQA flash attention, hand-written for Hopper (sm_90a),
// its products on the tensor cores at f32 accuracy (3xTF32).
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py
// (flash_attention_hm, inner `_kernel`).  Head-major layouts:
// q [B, H, Sq, D], k/v [B, Hkv, Skv, D], out [B, H, Sq, D] in q's type;
// query head h reads kv head h / (H / Hkv).  For every query row
//
//   out = softmax(q k^T / sqrt(D)) v,   causal: key kpos visible iff
//                                        kpos <= qpos (both from 0)
//
// with the Pallas body's numerics: scores and softmax in f32, running max
// m, sum l and accumulator acc in f32, masked scores set to NEG_INF =
// -1e30, P kept in f32, and out = acc / max(l, 1e-30).
//
// Design, in the FlashAttention-2 shape.  The Pallas grid walks the kv
// blocks as a sequential axis with m/l/acc in VMEM scratch.  Here one block
// of 4 warps (one warpgroup) owns a 64-row query tile of one (b, h) and
// loops over 64-key tiles itself, stopping at the causal horizon (the last
// key tile that starts at or below the tile's last row); warp w owns rows
// 16w..16w+15, and its m, l and acc stay in its registers.
//   S = Q K^T on wgmma, both operands in shared memory in its core-matrix
//     layout: Q's TF32 terms are written once, when the block loads Q;
//     each kv tile's K arrives raw by cp.async and one pass of the block
//     writes its terms.  f32: three TF32 terms (mma_tf32x3.cuh), bf16: one
//     bf16 term, exact in the f32 accumulator.
//   softmax: on the accumulator fragments in registers; a row's max and
//     sum are reduced across its quad by two shuffles.  The mask is
//     applied only on tiles that cross the diagonal or the end of the keys.
//   O += P V on mma.sync m16n8k8 TF32: P is f32 (as the reference keeps it,
//     never rounded to bf16), moved from the C to the A fragment layout by
//     quad shuffles and split; V is split in f32 and exact in bf16: three
//     terms or two.
// f32 at D = 128 runs two warpgroups on each query tile (256 threads): both
// compute the tile's scores and softmax in full, and each accumulates P V
// for its own 64 of the 128 output columns.  With one warpgroup a thread
// holds the 64 accumulators of 128 columns beside the 32 of the scores,
// and the variant spilled at the 255-register cap; with two it holds 32.
// The scores are computed twice, half again the tensor-core work, and the
// block's 199,680 B of shared memory leave one block an SM, of 8 warps.
// K of tile i + 1 arrives while tile i's scores, softmax and P V run, V of
// tile i while its scores do; three barriers a kv tile.  Raw K rows are
// padded by 16 bytes (8 threads reading 8 rows hit distinct banks) and V
// rows by 8 elements (read as row t, column g).  Heavy (late) query tiles
// are launched first to shorten the causal tail.
// Bound.  Causal attention at B=2, S=4096, H=32, D=64 (llama3.2-1b's
// prefill) is 4 * B * H * D * S(S+1)/2 = 137.5 GFLOP against 168 MB of
// q/k/v/o.  At f32 accuracy the card's rate is 3xTF32's 495/3 = 165
// TFLOP/s: 0.833 ms, bound by operations (2.05 ms at the 67 TFLOP/s of f32
// outside the tensor cores).  In bf16 the products run at 989 TFLOP/s, and
// the S(S+1)/2 B H exponentials on the SFU bound it beside them.
//
// Contract.  The kernel launches on the caller's stream, does not
// synchronize and allocates nothing; the caller checks devices, types,
// shapes, contiguity and 16-byte alignment.  D is 64 or 128; any Sq, Skv
// >= 1 (ragged tiles are masked).  The entry point returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBQ = 64;           // query rows of a block
constexpr int kBK = 64;           // keys of a kv tile
constexpr int kNT = kBK / 8;      // its n-tiles of scores
constexpr int kWarps = 4;         // a warp owns 16 query rows
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory layout for element type T and head dim D: Q's and K's
// TF32 terms (f32: big and small; bf16: the values) in wgmma's core-matrix
// layout, K's raw tile (rows padded by 16 bytes, so that 8 threads reading
// 8 rows hit 8 distinct banks), and V (read as row t, column g: padded by
// 8 elements).
template <typename T, int D>
struct Layout {
  static constexpr int kE = 16 / sizeof(T);     // elements in 16 bytes
  static constexpr int kTerms = Operand<T>::kSplit ? 2 : 1;
  static constexpr int kLdK = D + kE, kLdV = D + 8;
  static constexpr size_t kCore = sizeof(T) * kBQ * D;   // one 64-row tile
  static constexpr uint32_t kSbo = 8 * D * sizeof(T);    // 8-row groups
  static constexpr size_t kQ = kTerms * kCore;
  static constexpr size_t kKraw = sizeof(T) * kBK * kLdK;
  static constexpr size_t kK = kTerms * kCore;
  static constexpr size_t kV = sizeof(T) * kBK * kLdV;
  static constexpr size_t kBytes = kQ + kKraw + kK + kV;
  static_assert(kBQ == kBK, "Q and K tiles share the core layout");

  // element (r, k) of a [64][D] tile in the core-matrix layout
  __device__ static __forceinline__ int core_at(int r, int k) {
    return (r >> 3) * (8 * D) + (k / kE) * (8 * kE) + (r & 7) * kE + k % kE;
  }
  // the 16-byte chunk i of a [64][D] tile: 8 consecutive chunks are the 8
  // rows of one core matrix, so a warp's 16-byte stores are contiguous
  __device__ static __forceinline__ void chunk(int i, int& r, int& c) {
    const int rest = i >> 3;
    r = ((rest / (D / kE)) << 3) | (i & 7);
    c = (rest % (D / kE)) * kE;
  }
};

// Warpgroups a block: two for f32 at D = 128, each holding half of the
// output's columns (see the note at the top), else one.
template <typename T, int D>
struct Groups {
  static constexpr int kWG = D == 128 && Operand<T>::kSplit ? 2 : 1;
  static constexpr int kThreads = 32 * kWarps * kWG;
  static constexpr int kMinBlocks = kWG == 1 ? 2 : 1;
};

// Rows r0 .. r0+63 of a [rows, D] matrix into dst[64][ld] by 16-byte
// cp.async; rows at or past `rows` are zero-filled.
template <typename T, int D, int kNThreads>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src,
                                           int r0, int rows) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kPerRow = D / kE;
  static_assert(kBK * kPerRow % kNThreads == 0, "whole copies a thread");
#pragma unroll
  for (int k = 0; k < kBK * kPerRow / kNThreads; ++k) {
    const int i = threadIdx.x + k * kNThreads;
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kE;
    const bool valid = r0 + r < rows;
    const T* s = valid ? src + static_cast<size_t>(r0 + r) * D + c : src;
    cp_async16(dst + r * ld + c, s, valid ? 16 : 0);
  }
}

// 16 bytes of a tile into its terms in the core layout: f32 as big and
// small, bf16 as it is
__device__ __forceinline__ void put_terms(uint32_t* big, uint32_t* small,
                                          int at, float4 x) {
  uint4 b4, s4;
  split(x.x, b4.x, s4.x);
  split(x.y, b4.y, s4.y);
  split(x.z, b4.z, s4.z);
  split(x.w, b4.w, s4.w);
  *reinterpret_cast<uint4*>(big + at) = b4;
  *reinterpret_cast<uint4*>(small + at) = s4;
}
__device__ __forceinline__ void put_terms(__nv_bfloat16* tile,
                                          __nv_bfloat16*, int at, uint4 x) {
  *reinterpret_cast<uint4*>(tile + at) = x;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(Groups<T, D>::kThreads,
                                  Groups<T, D>::kMinBlocks)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int Sq, int Skv, float scale, int causal) {
  using L = Layout<T, D>;
  constexpr bool kSplit = Operand<T>::kSplit;
  // a tile's 16-byte chunks as loaded, and its terms as stored
  using Chunk = typename std::conditional<kSplit, float4, uint4>::type;
  using Term = typename std::conditional<kSplit, uint32_t, T>::type;
  constexpr int kWG = Groups<T, D>::kWG;
  constexpr int kNThreads = Groups<T, D>::kThreads;
  constexpr int kND = D / 8 / kWG;   // n-tiles of the warpgroup's output
  constexpr int kG = D == 64 ? 8 : 4;   // output n-tiles a P V pass takes
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  Term* sQb = reinterpret_cast<Term*>(smem);
  Term* sQs = sQb + (kSplit ? kBQ * D : 0);
  T* sKraw = reinterpret_cast<T*>(smem + L::kQ);
  Term* sKb = reinterpret_cast<Term*>(smem + L::kQ + L::kKraw);
  Term* sKs = sKb + (kSplit ? kBK * D : 0);
  T* sV = reinterpret_cast<T*>(smem + L::kQ + L::kKraw + L::kK);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * (kWG == 1 ? warp : warp % kWarps);
  // the warpgroup's first output column
  const int c0 = kWG == 1 ? 0 : warp / kWarps * (D / kWG);
  const int bh = blockIdx.y;                     // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heavy tiles first
  const T* qb = q + static_cast<size_t>(bh) * Sq * D;
  const size_t kv_off = static_cast<size_t>(b * Hkv + hk) * Skv * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  stage_tile<T, D, kNThreads>(sKraw, L::kLdK, kb, 0, Skv);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBQ * D / L::kE; i += kNThreads) {
    int r, c;
    L::chunk(i, r, c);
    Chunk x = {};
    if (q0 + r < Sq)
      x = *reinterpret_cast<const Chunk*>(qb + static_cast<size_t>(q0 + r) * D + c);
    put_terms(sQb, sQs, L::core_at(r, c), x);
  }

  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float o[kND / kG][kG][4];   // output n-tile j at o[j / kG][j % kG]
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j / kG][j % kG][e] = 0.f;
  const int qpos_lo = q0 + row0 + g, qpos_hi = qpos_lo + 8;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    cp_async_wait<0>();
    __syncthreads();   // K of tile it has landed; tile it - 1 is done
    stage_tile<T, D, kNThreads>(sV, L::kLdV, vb, k0, Skv);
    cp_async_commit();
    for (int i = threadIdx.x; i < kBK * D / L::kE; i += kNThreads) {
      int r, c;
      L::chunk(i, r, c);
      put_terms(sKb, sKs, L::core_at(r, c),
                *reinterpret_cast<const Chunk*>(sKraw + r * L::kLdK + c));
    }
    fence_proxy_async();
    __syncthreads();   // K's (and Q's) terms are visible to the tensor cores
    if (it + 1 < ntiles)
      stage_tile<T, D, kNThreads>(sKraw, L::kLdK, kb, k0 + kBK, Skv);
    cp_async_commit();

    // S = Q K^T on wgmma: three TF32 terms (small ones first) for f32, one
    // bf16 term for bf16; each instruction takes 16 bytes of K a row, two
    // core matrices, 256 bytes on in the layout
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / (2 * L::kE); ++kk) {
      const int at = 16 * L::kE * kk;
      const uint64_t qd = wgmma_desc(sQb + at, L::kSbo);
      const uint64_t kd = wgmma_desc(sKb + at, L::kSbo);
      if constexpr (kSplit) {
        if constexpr (kSmallTerms) {
          wgmma_tf32(s, wgmma_desc(sQs + at, L::kSbo), kd);
          wgmma_tf32(s, qd, wgmma_desc(sKs + at, L::kSbo));
        }
        wgmma_tf32(s, qd, kd);
      } else {
        wgmma_bf16(s, qd, kd);
      }
    }
    wgmma_commit();
    wgmma_wait0();

    // scale, mask (only tiles crossing the diagonal or the end of the
    // keys), online softmax on the fragments: a row's quad holds it
    const bool mask = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (mask) {
          const int kpos = k0 + 8 * nt + 2 * t + (e & 1);
          const int qpos = e >= 2 ? qpos_hi : qpos_lo;
          if (kpos >= Skv || (causal && kpos > qpos)) x = kNegInf;
        }
        s[nt][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = ex2((m_lo - mn_lo) * kLog2e);
    const float corr_hi = ex2((m_hi - mn_hi) * kLog2e);
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2((s[nt][e] - (e < 2 ? mn_lo : mn_hi)) * kLog2e);
        s[nt][e] = p;
        if (e < 2) ps_lo += p;
        else ps_hi += p;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps_lo += __shfl_xor_sync(kFull, ps_lo, off);
      ps_hi += __shfl_xor_sync(kFull, ps_hi, off);
    }
    l_lo = l_lo * corr_lo + ps_lo;
    l_hi = l_hi * corr_hi + ps_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      float* oj = o[j / kG][j % kG];
      oj[0] *= corr_lo;
      oj[1] *= corr_lo;
      oj[2] *= corr_hi;
      oj[3] *= corr_hi;
    }

    // O += P V on mma.sync, P split into its TF32 terms, V split in f32
    cp_async_wait<1>();   // V of tile it (K of tile it + 1 may still fly)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      float pa[4];
      c_to_a(s[kk], pa);
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(pa[e], ab[e], as[e]);
      const T* vr = sV + (8 * kk + t) * L::kLdV + c0 + g;
#pragma unroll
      for (int j0 = 0; j0 < kND; j0 += kG) {   // kG n-tiles at a time
        uint32_t bb[kG][2], bs[kG][2];
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          terms<kSplit>(to_f32(vr[8 * (j0 + j)]), bb[j][0], bs[j][0]);
          terms<kSplit>(to_f32(vr[4 * L::kLdV + 8 * (j0 + j)]), bb[j][1],
                         bs[j][1]);
        }
        mma3<true, kSplit>(o[j0 / kG], ab, as, bb, bs);
      }
    }
  }

  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  T* ob = out + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int j = 0; j < kND; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    const float* oj = o[j / kG][j % kG];
    if (qpos_lo < Sq)
      store2(ob + static_cast<size_t>(qpos_lo) * D + c, oj[0] * inv_lo,
             oj[1] * inv_lo);
    if (qpos_hi < Sq)
      store2(ob + static_cast<size_t>(qpos_hi) * D + c, oj[2] * inv_hi,
             oj[3] * inv_hi);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int Sq, int Skv, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<T, D>::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, Groups<T, D>::kThreads, Layout<T, D>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Sq, Skv,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))), causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t occupancy(int* out) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t kBytes = Layout<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBytes));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      Groups<T, D>::kThreads,
                                                      kBytes);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(kBytes);
  out[3] = blocks;
  out[4] = Groups<T, D>::kThreads;
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
extern "C" int flash_attention_hm(const void* q, const void* k, const void* v,
                                  void* out, int B, int H, int Hkv, int Sq,
                                  int Skv, int D, int causal, int dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the kernel for (dtype, D) occupies: out[0] registers a thread,
// out[1] local (spilled) bytes a thread, out[2] dynamic shared memory a
// block, out[3] blocks an SM can hold, out[4] threads a block.
extern "C" int flash_attention_occupancy(int dtype, int D, int* out) {
  if (dtype == 0 && D == 64) return static_cast<int>(occupancy<float, 64>(out));
  if (dtype == 0 && D == 128) return static_cast<int>(occupancy<float, 128>(out));
  if (dtype == 1 && D == 64)
    return static_cast<int>(occupancy<__nv_bfloat16, 64>(out));
  if (dtype == 1 && D == 128)
    return static_cast<int>(occupancy<__nv_bfloat16, 128>(out));
  return static_cast<int>(cudaErrorInvalidValue);
}
