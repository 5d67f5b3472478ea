// The Mamba2 SSD (state space dual) chunked scan, hand-written for Hopper
// (sm_90a), its products on the tensor cores at f32 accuracy (3xTF32).
//
// Replaces the Pallas kernel of src/repro/kernels/ssd.py (ssd_pallas,
// inner `_kernel`).  x [B, S, H, P], Bm and Cm [B, S, N] in one type (f32
// or bf16); dt [B, S, H] f32 (>= 0), A [H] f32 (< 0); the state
// [B, H, P, N] f32.  For each (b, h) the recurrence
//
//   state <- exp(dt_t A) state + dt_t x_t B_t^T;   y_t = state C_t
//
// is evaluated a chunk of kL = 64 steps at a time, in f32.  With
// cum[t] = sum_{s<=t} dt_s A inside the chunk (so cum is non-increasing):
//
//   y[t]  = exp(cum[t]) state C_t                              (inter)
//         + sum_{s<=t} (C_t . B_s) exp(cum[t] - cum[s]) dt_s x_s  (intra)
//   state <- exp(cum[end]) state + sum_s dt_s exp(cum[end] - cum[s]) x_s B_s^T
//
// y is written in x's type, the final state in f32.  No initial state (a
// null pointer) means zeros.  The chunk is the kernel's own: the Pallas
// kernel's `chunk` (zamba2-7b's 256) gives the same function up to
// rounding, and a shorter chunk does less intra-chunk work.
//
// Design.  The Pallas grid carries the [P, N] state in VMEM scratch across
// a sequential axis of chunks.  Here a block walks its (b, h)'s chunks in
// series and keeps the state on chip from the first chunk to the last: in
// the registers of the warps that update it (mma accumulators) and, split
// into its two TF32 terms, in shared memory for the next chunk's C state^T.
// The state never crosses device memory.  (Mamba2's own GPU kernels split
// the scan into chunk-parallel states, a sequential pass and
// chunk-parallel outputs; at zamba2-7b's f32 prefill shape that writes and
// reads a [2,64,112,64,64] f32 state tensor, 235 MB, three more times:
// about 1.65 GB in all, a floor of 0.49 ms against the 0.14 ms of this
// design's bytes.)
//
// Two kernels a call.  G = C B^T depends on the chunk but not on the head
// (Bm and Cm are shared by all H heads), so ssd_gram_kernel computes it
// once per (b, chunk), at or below the diagonal, into f32 scratch (16 KB a
// chunk, read back from L2).  The scan then takes each (b, h) in blocks
// that own kPB = 32 columns of P each (32 rows of the state, 32 columns of
// x and y): the prefill step's [2, 4096, 112, 64] runs 448 blocks on the
// 132 SMs, two to an SM.  4 warps; in a chunk, warp i owns rows
// 16i..16i+15 and the kNtg = 2i + 2 n-tiles of G that reach the diagonal
// (a compile-time count for each warp, so no mma is guarded):
//   1. its tiles of G are loaded from the scratch, and yacc = C state^T by
//      one m16n8k8 pass over N;
//   2. M = G exp(cum[t] - cum[s]) dt_s at or below the diagonal, on the
//      fragments in f32 (masked before the exponential: above the diagonal
//      cum[t] - cum[s] > 0 overflows exp for large dt |A|, and inf * 0
//      would be NaN, so there the exponent is -inf and the factor 0), then
//      y = exp(cum[t]) yacc + M x, M moved from the C to the A fragment
//      layout by quad shuffles;
//   3. state = exp(cum[end]) state + (x diag(w))^T B, w_s = dt_s
//      exp(cum[end] - cum[s]): warp w owns state rows 16(w % 2).. and
//      columns 32(w / 2).., accumulated in its registers.
// Every product runs on m16n8k8 TF32 tiles in three terms per f32 operand
// pair (mma_tf32x3.cuh); bf16 x, B and C are exact in one term, so their
// small terms are skipped.  Chunk c + 1's x, B, C (16-byte cp.async, in
// their own type) and dt (4-byte cp.async, one lane a step) are in flight
// while chunk c multiplies: two stages of shared memory.  Warp 0 scans dt
// into cum with shuffles.  Two barriers a chunk.  Shared-memory rows are
// padded (x: 40, C and B: 68 f32 or 72 bf16) so that fragment loads fall
// on distinct banks, but for the state update's B, two lanes a bank.  The
// tail of a sequence that is not a multiple of 64 is zero-filled with
// dt = 0 (decay 1, no contribution), as the reference pads.
//
// Bound.  At zamba2-7b's prefill step (x [2, 4096, 112, 64], N = 64, f32)
// the kernel must read x, dt, A, Bm and Cm and write y and the final
// state: 481 MB, 0.144 ms at 3.35 TB/s.  The least work is the chunked
// form at its best chunk, about 4.27 P N a (step, head), 16.0 GFLOP: 0.097
// ms at 3xTF32's 165 TFLOP/s, so bound by bytes.  This kernel does about
// 4 P N + kL (N / H + P) a (step, head).
//
// Contract.  The kernel launches on the caller's stream, does not
// synchronize and allocates nothing; the caller checks devices, types,
// shapes and contiguity.  1 <= P, N <= 64.  The entry point returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kL = 64;            // time steps of a chunk
constexpr int kN = 64;            // N, zero-padded
constexpr int kPB = 32;           // columns of P a block owns
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdS = 68;          // state rows in shared memory
constexpr unsigned kFull = 0xffffffffu;

// Row strides of a stage's tiles for stream type T.  Fragment loads read
// x as (row t, column g) and C, B and the state as (row g, column t)
// (g = lane / 4, t = lane % 4); the strides put the 32 lanes of each such
// load on 32 banks.  The state update also reads B as (row t, column g),
// two lanes to a bank.
template <typename T>
struct Tiles {
  static constexpr int kLdX = 40, kLdC = 68, kLdB = 68;
};
template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int kLdX = 40, kLdC = 72, kLdB = 72;
};

template <typename T>
struct Smem {
  using Ti = Tiles<T>;
  static constexpr size_t kStage =
      sizeof(T) * kL * (Ti::kLdX + Ti::kLdC + Ti::kLdB) + sizeof(float) * kL;
  // two stages, the state's big and small terms, then cum, exp(cum), w
  // and exp(cum[end])
  static constexpr size_t kBytes = 2 * kStage +
                                   2 * sizeof(uint32_t) * kPB * kLdS +
                                   sizeof(float) * (3 * kL + 4);
};

template <typename T>
struct Stage {
  T* x;       // [kL][kLdX]   x[s][p]
  T* c;       // [kL][kLdC]   C[t][n]
  T* b;       // [kL][kLdB]   B[s][n]
  float* dt;  // [kL]
  __device__ explicit Stage(unsigned char* base) {
    x = reinterpret_cast<T*>(base);
    c = x + kL * Tiles<T>::kLdX;
    b = c + kL * Tiles<T>::kLdC;
    dt = reinterpret_cast<float*>(b + kL * Tiles<T>::kLdB);
  }
};

// One element, global to shared, zero when !valid: 4-byte cp.async for
// f32, a plain copy for bf16 (cp.async takes 4, 8 or 16 bytes).
__device__ __forceinline__ void copy1(float* dst, const float* src,
                                      bool valid) {
  cp_async4(dst, src, valid ? 4 : 0);
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool valid) {
  *dst = valid ? *src : __float2bfloat16(0.f);
}

// Rows t0 .. t0 + kL - 1 of a stream whose row t starts at src + t * stride
// and holds `cols` valid values, into kWidth columns of a tile of row
// stride ld; zero past S or cols.  With vec, cols is a multiple of 16
// bytes and src is 16-byte aligned: one cp.async per 16 bytes.
template <typename T, int kWidth>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           size_t stride, int t0, int S,
                                           int cols, bool vec) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kPerRow = kWidth / kE;
    static_assert(kL * kPerRow % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int k = 0; k < kL * kPerRow / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * kE;
      const bool valid = t0 + r < S && c < cols;
      const T* s = valid ? src + static_cast<size_t>(t0 + r) * stride + c : src;
      cp_async16(dst + r * ld + c, s, valid ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kL * kWidth; i += kThreads) {
      const int r = i / kWidth;
      const int c = i % kWidth;
      const bool valid = t0 + r < S && c < cols;
      const T* s = valid ? src + static_cast<size_t>(t0 + r) * stride + c : src;
      copy1(dst + r * ld + c, s, valid);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_chunk(Stage<T> st, const T* xb,
                                            const float* dtb, const T* Bb,
                                            const T* Cb, int t0, int S,
                                            int H, int P, int Pj, int N,
                                            bool vec) {
  using Ti = Tiles<T>;
  stage_rows<T, kPB>(st.x, Ti::kLdX, xb, static_cast<size_t>(H) * P, t0, S,
                     Pj, vec);
  stage_rows<T, kN>(st.c, Ti::kLdC, Cb, static_cast<size_t>(N), t0, S, N,
                    vec);
  stage_rows<T, kN>(st.b, Ti::kLdB, Bb, static_cast<size_t>(N), t0, S, N,
                    vec);
  if (threadIdx.x < kL) {
    const int r = threadIdx.x;
    const bool valid = t0 + r < S;
    cp_async4(st.dt + r,
              valid ? dtb + static_cast<size_t>(t0 + r) * H : dtb,
              valid ? 4 : 0);
  }
}

// Warp i's chunk rows 16i..16i+15 reach the diagonal at n-tile 2i + 1:
// its tiles of G = C B^T (and of M) are the kNtg = 2i + 2 first ones.
// Calls f(Int<kNtg>) with that count as a compile-time constant.
template <typename F>
__device__ __forceinline__ void with_diagonal_tiles(int warp, F&& f) {
  switch (warp) {
    case 0: f(Int<2>{}); break;
    case 1: f(Int<4>{}); break;
    case 2: f(Int<6>{}); break;
    default: f(Int<8>{}); break;
  }
}

// G = C B^T of every chunk, the scores all H heads share: gram[b, c, t, s]
// for the chunk's rows t and columns s, f32 (three TF32 terms for f32 C and
// B, one for bf16).  Only the tiles at or below the diagonal are written;
// the scan reads no others.  One block of 4 warps a (b, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_gram_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                float* __restrict__ gram, int S, int N, int vec) {
  constexpr bool kSplitT = Operand<T>::kSplit;
  constexpr int kLdC = Tiles<T>::kLdC, kLdB = Tiles<T>::kLdB;
  __shared__ __align__(16) T sC[kL * kLdC];
  __shared__ __align__(16) T sB[kL * kLdB];
  const int nc = (S + kL - 1) / kL;
  const int b = blockIdx.x / nc;
  const int t0 = (blockIdx.x % nc) * kL;
  stage_rows<T, kN>(sC, kLdC, Cm + static_cast<size_t>(b) * S * N,
                    static_cast<size_t>(N), t0, S, N, vec != 0);
  stage_rows<T, kN>(sB, kLdB, Bm + static_cast<size_t>(b) * S * N,
                    static_cast<size_t>(N), t0, S, N, vec != 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int offC = (16 * warp + g) * kLdC + t;   // C as A: (row g, col t)
  const int offB = g * kLdB + t;                 // B as B: (s=g, n=t)
  float* out = gram + static_cast<size_t>(blockIdx.x) * kL * kL +
               (16 * warp + g) * kL + 2 * t;
  with_diagonal_tiles(warp, [&](auto ntg) {
    constexpr int kNtg = decltype(ntg)::value;
    float acc[kNtg][4] = {};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const T* cr = sC + offC + 8 * kk;
      uint32_t ab[4], as[4];
      terms<kSplitT>(to_f32(cr[0]), ab[0], as[0]);
      terms<kSplitT>(to_f32(cr[8 * kLdC]), ab[1], as[1]);
      terms<kSplitT>(to_f32(cr[4]), ab[2], as[2]);
      terms<kSplitT>(to_f32(cr[8 * kLdC + 4]), ab[3], as[3]);
      uint32_t bb[kNtg][2], bs[kNtg][2];
#pragma unroll
      for (int nt = 0; nt < kNtg; ++nt) {
        const T* br = sB + offB + 8 * nt * kLdB + 8 * kk;
        terms<kSplitT>(to_f32(br[0]), bb[nt][0], bs[nt][0]);
        terms<kSplitT>(to_f32(br[4]), bb[nt][1], bs[nt][1]);
      }
      mma3<kSplitT, kSplitT>(acc, ab, as, bb, bs);
    }
#pragma unroll
    for (int nt = 0; nt < kNtg; ++nt) {
      *reinterpret_cast<float2*>(out + 8 * nt) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + 8 * kL + 8 * nt) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ s0,
           const float* __restrict__ gram, T* __restrict__ y,
           float* __restrict__ sf, int S, int H, int P, int N, int vec) {
  constexpr bool kSplitT = Operand<T>::kSplit;
  constexpr int kLdX = Tiles<T>::kLdX, kLdC = Tiles<T>::kLdC,
                kLdB = Tiles<T>::kLdB;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  uint32_t* sSb = reinterpret_cast<uint32_t*>(base + 2 * Smem<T>::kStage);
  uint32_t* sSs = sSb + kPB * kLdS;              // state[p][n] big, small
  float* sCum = reinterpret_cast<float*>(sSs + kPB * kLdS);
  float* sSeg = sCum + kL;                       // exp(cum[t])
  float* sW = sSeg + kL;                         // dt_s exp(cum[end] - cum[s])
  float* sEnd = sW + kL;                         // exp(cum[end])

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nPB = (P + kPB - 1) / kPB;
  const int bh = blockIdx.x / nPB;               // b * H + h
  const int p0 = (blockIdx.x % nPB) * kPB;
  const int Pj = min(kPB, P - p0);               // columns of P here
  const int b = bh / H;
  const int h = bh % H;
  const float a_h = A[h];
  const size_t xrow = static_cast<size_t>(H) * P;     // stride of t in x, y
  const size_t xoff = (static_cast<size_t>(b) * S * H + h) * P + p0;
  const T* xb = x + xoff;
  T* yb = y + xoff;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const T* Bb = Bm + static_cast<size_t>(b) * S * N;
  const T* Cb = Cm + static_cast<size_t>(b) * S * N;
  const int nc = (S + kL - 1) / kL;

  // state rows 16 ps + g (+8) and columns 8 (nb + j) + 2t (+1) live in
  // this warp's accumulators st[j]
  const int ps = warp & 1;
  const int nb = 4 * (warp >> 1);
  float st[4][4];
  const float* s0b = s0 == nullptr ? nullptr
                                   : s0 + static_cast<size_t>(bh) * P * N;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * ps + g + (e >= 2 ? 8 : 0);
      const int n = 8 * (nb + j) + 2 * t + (e & 1);
      st[j][e] = (s0b != nullptr && p < Pj && n < N)
                     ? s0b[static_cast<size_t>(p0 + p) * N + n] : 0.f;
    }
  const int s_at = (16 * ps + g) * kLdS + 8 * nb + 2 * t;
  auto publish_state = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = s_at + (e >= 2 ? 8 * kLdS : 0) + 8 * j + (e & 1);
        uint32_t big, small;
        split(st[j][e], big, small);
        sSb[at] = big;
        sSs[at] = small;
      }
  };
  publish_state();

  // this thread's fragment offsets into a stage's tiles and the state;
  // the rest of each address is a constant
  const int row0 = 16 * warp;                    // this warp's chunk rows
  const int offC = (row0 + g) * kLdC + t;        // C as A: (row g, col t)
  const int offS = g * kLdS + t;                 // state as B: (p=g, n=t)
  const int offXy = t * kLdX + g;                // x as y's B: (s=t, p=g)
  const int offXs = t * kLdX + 16 * ps + g;      // x as A^T: (s=t, p=g)
  const int offBs = t * kLdB + 8 * nb + g;       // B as B: (s=t, n=g)
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  // this thread's G fragments: rows r_lo and r_hi, columns 8 nt + 2t (+1)
  const float* gram_t = gram + static_cast<size_t>(b) * nc * kL * kL +
                        r_lo * kL + 2 * t;

  stage_chunk(Stage<T>(base), xb, dtb, Bb, Cb, 0, S, H, P, Pj, N, vec != 0);
  cp_async_commit();

  for (int ic = 0; ic < nc; ++ic) {
    const int t0 = ic * kL;
    const Stage<T> cur(base + (ic & 1) * Smem<T>::kStage);
    cp_async_wait<0>();
    __syncthreads();   // chunk ic has landed; chunk ic - 1's readers are done
    if (kStaging && ic + 1 < nc)
      stage_chunk(Stage<T>(base + ((ic + 1) & 1) * Smem<T>::kStage), xb, dtb,
                  Bb, Cb, t0 + kL, S, H, P, Pj, N, vec != 0);
    cp_async_commit();

    // this warp's tiles of G, from the gram kernel (in flight while the
    // scan and C state^T run)
    float gacc[8][4];
    const float* gp = gram_t + static_cast<size_t>(ic) * kL * kL;
    with_diagonal_tiles(warp, [&](auto ntg) {
      constexpr int kNtg = decltype(ntg)::value;
#pragma unroll
      for (int nt = 0; nt < kNtg; ++nt) {
        const float2 lo = *reinterpret_cast<const float2*>(gp + 8 * nt);
        const float2 hi =
            *reinterpret_cast<const float2*>(gp + 8 * kL + 8 * nt);
        gacc[nt][0] = lo.x;
        gacc[nt][1] = lo.y;
        gacc[nt][2] = hi.x;
        gacc[nt][3] = hi.y;
      }
    });

    if (warp == 0) {
      // lane l owns steps 2l and 2l+1; padded steps have dt = 0
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float d0 = cur.dt[i0], d1 = cur.dt[i1];
      const float a0 = d0 * a_h, a1 = d1 * a_h;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + a0;
      const float c1 = c0 + a1;
      const float end = __shfl_sync(kFull, c1, 31);
      sCum[i0] = c0;
      sCum[i1] = c1;
      sSeg[i0] = expf(c0);
      sSeg[i1] = expf(c1);
      sW[i0] = d0 * expf(end - c0);
      sW[i1] = d1 * expf(end - c1);
      if (lane == 0) *sEnd = expf(end);
    }

    // 1. yacc = C state^T (this warp's chunk rows, all columns of P)
    float yacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const T* cr = cur.c + offC + 8 * kk;
      uint32_t ab[4], as[4];
      terms<kSplitT>(to_f32(cr[0]), ab[0], as[0]);
      terms<kSplitT>(to_f32(cr[8 * kLdC]), ab[1], as[1]);
      terms<kSplitT>(to_f32(cr[4]), ab[2], as[2]);
      terms<kSplitT>(to_f32(cr[8 * kLdC + 4]), ab[3], as[3]);
      uint32_t sb[4][2], ss[4][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int at = offS + 8 * np * kLdS + 8 * kk;
        sb[np][0] = sSb[at];
        sb[np][1] = sSb[at + 4];
        ss[np][0] = sSs[at];
        ss[np][1] = sSs[at + 4];
      }
      mma3<kSplitT, true>(yacc, ab, as, sb, ss);
    }
    __syncthreads();   // cum is ready; every read of the state is done

    // 2. M = G exp(cum[t] - cum[s]) dt_s on the G fragments (masked on the
    //    two diagonal tiles, before the exponential), then
    //    y = exp(cum[t]) C state^T + M x
    const float cum_lo = sCum[r_lo], cum_hi = sCum[r_hi];
    auto products2 = [&](auto ntg) {
      constexpr int kNtg = decltype(ntg)::value;
#pragma unroll
      for (int nt = 0; nt < kNtg; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 8 * nt + 2 * t + (e & 1);
          // above the diagonal the exponent is -inf, so the factor is 0
          const bool keep = nt < kNtg - 2 || s <= (e >= 2 ? r_hi : r_lo);
          const float arg =
              keep ? ((e >= 2 ? cum_hi : cum_lo) - sCum[s]) * kLog2e
                   : __int_as_float(0xff800000);   // -inf
          gacc[nt][e] *= ex2(arg) * cur.dt[s];
        }
#pragma unroll
      for (int kk = 0; kk < kNtg; ++kk) {
        float ma[4];
        c_to_a(gacc[kk], ma);
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(ma[e], ab[e], as[e]);
        const T* xr = cur.x + offXy + 8 * kk * kLdX;
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          terms<kSplitT>(to_f32(xr[8 * np]), bb[np][0], bs[np][0]);
          terms<kSplitT>(to_f32(xr[4 * kLdX + 8 * np]), bb[np][1],
                         bs[np][1]);
        }
        mma3<true, kSplitT>(yacc, ab, as, bb, bs);
      }
    };
    const float seg_lo = sSeg[r_lo], seg_hi = sSeg[r_hi];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      yacc[np][0] *= seg_lo;
      yacc[np][1] *= seg_lo;
      yacc[np][2] *= seg_hi;
      yacc[np][3] *= seg_hi;
    }
    with_diagonal_tiles(warp, products2);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = t0 + (e >= 2 ? r_hi : r_lo);
        const int p = 8 * np + 2 * t + (e & 1);
        if (tt < S && p < Pj)
          store(yb + static_cast<size_t>(tt) * xrow + p, yacc[np][e]);
      }
    }

    // 3. state = exp(cum[end]) state + (x diag(w))^T B on this warp's
    //    rows and columns of the state
    const float e_end = *sEnd;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= e_end;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float w0 = sW[8 * kk + t], w1 = sW[8 * kk + t + 4];
      const T* xr = cur.x + offXs + 8 * kk * kLdX;
      uint32_t ab[4], as[4];
      split(to_f32(xr[0]) * w0, ab[0], as[0]);
      split(to_f32(xr[8]) * w0, ab[1], as[1]);
      split(to_f32(xr[4 * kLdX]) * w1, ab[2], as[2]);
      split(to_f32(xr[4 * kLdX + 8]) * w1, ab[3], as[3]);
      const T* br = cur.b + offBs + 8 * kk * kLdB;
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        terms<kSplitT>(to_f32(br[8 * j]), bb[j][0], bs[j][0]);
        terms<kSplitT>(to_f32(br[4 * kLdB + 8 * j]), bb[j][1], bs[j][1]);
      }
      mma3<true, kSplitT>(st, ab, as, bb, bs);
    }
    publish_state();
  }

  float* sfb = sf + static_cast<size_t>(bh) * P * N;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * ps + g + (e >= 2 ? 8 : 0);
      const int n = 8 * (nb + j) + 2 * t + (e & 1);
      if (p < Pj && n < N) sfb[static_cast<size_t>(p0 + p) * N + n] = st[j][e];
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* s0,
                   void* gram, void* y, void* sf, int B, int S, int H, int P,
                   int N, cudaStream_t stream) {
  auto kernel = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<T>::kBytes));
  if (err != cudaSuccess) return err;
  constexpr int kE = 16 / sizeof(T);
  const bool vec = P % kE == 0 && N % kE == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  const int nc = (S + kL - 1) / kL;
  ssd_gram_kernel<T><<<B * nc, kThreads, 0, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<float*>(gram), S, N, vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = B * H * ((P + kPB - 1) / kPB);
  kernel<<<blocks, kThreads, Smem<T>::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(s0),
      static_cast<const float*>(gram), static_cast<T*>(y),
      static_cast<float*>(sf), S, H, P, N, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int* out) {
  auto kernel = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<T>::kBytes));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kThreads, Smem<T>::kBytes);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(Smem<T>::kBytes);
  out[3] = blocks;
  out[4] = kThreads;
  return err;
}

}  // namespace

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  s0 may be null.
// gram is f32 scratch of B * ceil(S / 64) * 64 * 64 floats for the chunks'
// C B^T.  Returns a cudaError_t as int.
extern "C" int ssd(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* s0, void* gram,
                   void* y, void* sf, int B, int S, int H, int P, int N,
                   int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 64 || N <= 0 || N > kN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, s0, gram, y, sf, B, S, H, P, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, s0, gram, y, sf, B, S, H,
                                 P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the kernel for dtype occupies: out[0] registers a thread, out[1]
// local (spilled) bytes a thread, out[2] dynamic shared memory a block,
// out[3] blocks an SM can hold, out[4] threads a block.
extern "C" int ssd_occupancy(int dtype, int* out) {
  if (dtype == 0) return static_cast<int>(occupancy<float>(out));
  if (dtype == 1) return static_cast<int>(occupancy<__nv_bfloat16>(out));
  return static_cast<int>(cudaErrorInvalidValue);
}
