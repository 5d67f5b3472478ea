// The RWKV6 (WKV) recurrence, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/wkv6.py (wkv6_pallas,
// inner `_kernel`).  r, k, v are [B, S, H, D] in one type (f32 or bf16),
// w [B, S, H, D] in that type or f32 (the RWKV6 layer computes its decay
// in f32), u is [H, D] f32, the state [B, H, D, D] f32 (key-major:
// S[d][e]).  For each (b, h) and each step t, in f32:
//
//   out_t[e] = sum_d r_t[d] * (S[d][e] + u[d] * k_t[d] * v_t[e])
//            = sum_d r_t[d] * S[d][e] + v_t[e] * sum_d r_t[d] u[d] k_t[d]
//   S[d][e] <- w_t[d] * S[d][e] + k_t[d] * v_t[e]
//
// out is written in r's type; the final state in f32.  No initial state
// (a null pointer) means zeros.  The recurrence itself takes no
// exponential, logarithm or division, so it holds for every w in [0, 1],
// 0 and 1 included (a chunked form that factors the decay as
// r exp(cum) and k exp(-cum) leaves the f32 range once the cumulative log
// decay of a chunk passes -87).
//
// Bound.  The kernel must read four [B,S,H,D] streams, u and the initial
// state, and write out and the final state.  At rwkv6-1.6b's serve
// prefill (B=4, S=512, H=32, D=64, f32, with a state) that is 88,088,576
// bytes, 26.3 us at 3.35 TB/s; at its prefill step (B=2, S=4096, no
// state) 336,601,088 bytes, 100.5 us.  Its f32 work is 5 operations per
// (step, d, e) -- an FMA of r . S, the k v product and the decay FMA --
// plus 5 per (step, d) for the bonus: 1.36 and 5.45 GFLOP, 20.3 and
// 81.4 us at 67 TFLOP/s.  So it is bound by bytes, and the f32 pipes
// alone could reach that bound: its products are rank-1 updates, which
// the tensor cores would take only in the chunked form above.  What holds
// this design is shared memory's delivery to the threads, 128 bytes a
// clock an SM: every thread receives its rows of r, k, w and its columns
// of v each step, at D=64 about 10,300 floats a (step, head) with the
// partials and the staging, about 156 clocks a step at the prefill step.
//
// Design.  The Pallas grid carries the [D, D] state in VMEM scratch
// across a sequential axis of time chunks.  Here the state stays in
// registers for the whole sequence, split so that the card has enough
// warps and each step has a short dependence chain:
//   1. The split.  Column e of the state only ever meets v_t[e] and feeds
//      only out_t[e], so a block owns E columns of one (b, h): the grid is
//      B*H*(D/E) blocks, the D/E blocks of one (b, h) adjacent in blockIdx
//      so that their reads of the same r, k, w rows meet in L2.  In the
//      block, G key groups of E/C threads each hold R = D/G rows of C
//      columns; a thread's rows of r, k, w serve its C columns, and its
//      columns of v its R rows.  D=64: E=32, G=16, R=4, C=2, 256 threads;
//      256 blocks at the serve shape, 128 at the prefill step's, 8 warps
//      an SM at either.  (One column a thread moves half again as many
//      floats: `--ablation`'s "one column a thread".  Splits with fewer,
//      fuller threads move fewer floats but leave 4 warps an SM at the
//      prefill step, and ran slower on an H100.)
//   2. The deferred reduction.  A step is, for each of a thread's C
//      columns, its share of r . S over its R rows (two independent
//      chains) and the decay FMA st = w st + k v: one FMA a step on the
//      recurrence's own chain.  The thread stores its C partials of out_t
//      to shared memory; no shuffle and no barrier a step.  Once a stretch
//      of TS steps, after the stretch's one barrier, the block sums the G
//      partials of each (t, e) of the stretch before in group order, adds
//      v_t[e] * bonus_t and writes out coalesced, while warps that are
//      done go on to this stretch's steps (two sets of partials).
//      bonus_t = sum_d r u k is formed once a step, as Q partial sums of
//      D/Q rows, in a pass before the stretch's steps.
//   3. The staging.  A stretch holds TS rows of r, k, w (all D) and the
//      block's E columns of v, in their own types, copied by 16-byte
//      cp.async into three stages: stretch s + 1 is in flight while
//      stretch s computes and stretch s - 1 is written out, and a stretch
//      costs one barrier.  (Two stages and a barrier pair a stretch ran
//      slower at both path shapes on an H100.)  Rows past S are filled
//      with r = k = v = 0 and w = 1, which leaves the state exactly as it
//      was, so a short tail needs no test in the steps.  Pointers that
//      are not 16-byte aligned are copied an element at a time.  r and k
//      rows carry 16 bytes of padding, so the bonus pass reads them
//      without bank conflicts.
//
// Contract.  The kernel launches on the caller's stream, does not
// synchronize and allocates nothing; the caller checks devices, types,
// shapes and contiguity.  D is 8, 16, 32, 64 or 128.  The entry point
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"   // cp.async, and the staging ablation switch

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

// The split of each head dim: E state columns a block, G key groups
// (R = D / G rows a thread), C columns a thread, TS steps a stretch.
template <int D> struct Split;
template <> struct Split<8> { static constexpr int E = 8, G = 2, C = 2, TS = 32; };
template <> struct Split<16> { static constexpr int E = 16, G = 4, C = 2, TS = 32; };
template <> struct Split<32> { static constexpr int E = 16, G = 8, C = 2, TS = 32; };
// REPRO_ABLATE_COLUMN_BLOCKING (`chip_smoke.py --ablation`): one column a
// thread and 16 a block at D=64, the split this design started from.
#ifdef REPRO_ABLATE_COLUMN_BLOCKING
template <> struct Split<64> { static constexpr int E = 16, G = 8, C = 1, TS = 16; };
#else
template <> struct Split<64> { static constexpr int E = 32, G = 16, C = 2, TS = 16; };
#endif
template <> struct Split<128> { static constexpr int E = 32, G = 16, C = 2, TS = 16; };

template <typename T, typename TW, int D>
struct Layout {
  static constexpr int E = Split<D>::E, G = Split<D>::G, C = Split<D>::C;
  static constexpr int TS = Split<D>::TS, R = D / G, NT = G * (E / C);
  // the bonus pass: Q threads a step, DQ rows each
  static constexpr int Q = D >= 16 ? 4 : 2, DQ = D / Q;
  // row pitches in elements: 16 bytes of padding
  static constexpr int kLd = D + 16 / sizeof(T), kLdW = D + 16 / sizeof(TW);
  // a stage: r, k [TS][kLd], w [TS][kLdW], v [TS][E]
  static constexpr size_t kOffK = sizeof(T) * TS * kLd;
  static constexpr size_t kOffW = 2 * kOffK;
  static constexpr size_t kOffV = kOffW + sizeof(TW) * TS * kLdW;
  static constexpr size_t kStage = kOffV + sizeof(T) * TS * E;
  static constexpr int kStages = 3;
  // the stages, then two sets of the partials [TS][G][E] and the bonus
  // partials [TS][Q], and u [D], all f32
  static constexpr int kPart = TS * G * E, kBon = TS * Q;
  static constexpr size_t kBytes =
      kStages * kStage + sizeof(float) * (2 * (kPart + kBon) + D);
  static_assert(DQ % 4 == 0, "the bonus pass reads rows four at a time");
  static_assert(R % 2 == 0, "two chains of r . S");
  static_assert(kStage % 16 == 0 && kOffV % 16 == 0, "16-byte stages");
  static_assert(sizeof(T) * E % 16 == 0, "v rows of whole 16-byte chunks");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename X> __device__ __forceinline__ X from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive values of a shared-memory row, widened to f32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <int C, typename X>
__device__ __forceinline__ void ldcols(const X* p, float (&out)[C]);
template <int N, typename X>
__device__ __forceinline__ void ldrow(const X* p, float (&out)[N]) {
  if constexpr (N < 4) {
    ldcols(p, out);
  } else {
    static_assert(N % 4 == 0, "rows are read four at a time");
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = ld4(p + i);
      out[i] = q.x;
      out[i + 1] = q.y;
      out[i + 2] = q.z;
      out[i + 3] = q.w;
    }
  }
}

// A thread's C consecutive values of a shared-memory row, widened to f32.
template <int C, typename X>
__device__ __forceinline__ void ldcols(const X* p, float (&out)[C]) {
  static_assert(C == 1 || C == 2 || C == 4, "one load");
  if constexpr (C == 4) {
    ldrow(p, out);
  } else if constexpr (C == 2) {
    if constexpr (sizeof(X) == 4) {
      const float2 q = *reinterpret_cast<const float2*>(p);
      out[0] = q.x;
      out[1] = q.y;
    } else {
      const float2 q = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p));
      out[0] = q.x;
      out[1] = q.y;
    }
  } else {
    out[0] = to_f32(*p);
  }
}

// C consecutive f32 values to shared memory.
template <int C>
__device__ __forceinline__ void stcols(float* p, const float (&x)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// One element, global to shared: 4-byte cp.async for f32, a plain copy
// for bf16 (cp.async takes 4, 8 or 16 bytes).
__device__ __forceinline__ void copy1(float* dst, const float* src) {
  cp_async4(dst, src, 4);
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  *dst = *src;
}

// TS rows of W elements, row t from src + t * step, into dst at pitch Ld;
// rows at or past n are set to `fill`.
template <int TS, int W, int Ld, int NT, typename X>
__device__ __forceinline__ void stage_rows(X* dst, const X* src, size_t step,
                                           int n, bool vec, float fill) {
  const X f = from_f32<X>(fill);
  if (vec) {
    constexpr int kPer = 16 / sizeof(X), kChunks = W / kPer;
    static_assert(W % kPer == 0, "rows of whole 16-byte chunks");
    static_assert(NT % kChunks == 0, "a thread copies one column of chunks");
    // this thread copies chunk j of rows t, t + kRows, ...
    constexpr int kRows = NT / kChunks;
    const int t0 = threadIdx.x / kChunks, j = (threadIdx.x % kChunks) * kPer;
    const X* s = src + t0 * step + j;
    X* d = dst + t0 * Ld + j;
    for (int t = t0; t < TS; t += kRows, s += kRows * step, d += kRows * Ld) {
      if (t < n) {
        cp_async16(d, s, 16);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) d[i] = f;
      }
    }
  } else {
    for (int c = threadIdx.x; c < TS * W; c += NT) {
      const int t = c / W, j = c % W;
      if (t < n) copy1(dst + t * Ld + j, src + t * step + j);
      else dst[t * Ld + j] = f;
    }
  }
}

template <typename T, typename TW, int D>
__global__ void __launch_bounds__(Layout<T, TW, D>::NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ sf, int S, int H,
            int vec) {
  using L = Layout<T, TW, D>;
  constexpr int E = L::E, G = L::G, C = L::C, TS = L::TS, R = L::R;
  constexpr int NT = L::NT;
  constexpr int Q = L::Q, DQ = L::DQ, kLd = L::kLd, kLdW = L::kLdW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const part0 = reinterpret_cast<float*>(smem + L::kStages * L::kStage);
  float* const bon0 = part0 + 2 * L::kPart;
  float* const su = bon0 + 2 * L::kBon;

  const int tid = threadIdx.x;
  // key group, first of the thread's C columns in the block
  const int g = tid / (E / C), c0 = (tid % (E / C)) * C;
  const int bh = blockIdx.x / (D / E);  // b * H + h
  const int e0 = (blockIdx.x % (D / E)) * E;
  const int b = bh / H, h = bh % H;
  const size_t step = static_cast<size_t>(H) * D;   // stride of t
  const size_t head = (static_cast<size_t>(b) * S * H + h) * D;
  const int ns = (S + TS - 1) / TS;

  auto stage = [&](int s) {
    unsigned char* base = smem + (s % L::kStages) * L::kStage;
    const size_t at = head + static_cast<size_t>(s) * TS * step;
    const int n = min(TS, S - s * TS);
    stage_rows<TS, D, kLd, NT>(reinterpret_cast<T*>(base), r + at, step, n,
                               vec, 0.f);
    stage_rows<TS, D, kLd, NT>(reinterpret_cast<T*>(base + L::kOffK), k + at,
                               step, n, vec, 0.f);
    stage_rows<TS, D, kLdW, NT>(reinterpret_cast<TW*>(base + L::kOffW),
                                w + at, step, n, vec, 1.f);
    stage_rows<TS, E, E, NT>(reinterpret_cast<T*>(base + L::kOffV),
                             v + at + e0, step, n, vec, 0.f);
  };

  float st[R][C];   // S[g*R + i][e0 + c0 + j]
  const float* s0b =
      s0 == nullptr ? nullptr : s0 + static_cast<size_t>(bh) * D * D;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j)
      st[i][j] = s0b == nullptr ? 0.f : s0b[(g * R + i) * D + e0 + c0 + j];
  for (int d = tid; d < D; d += NT) su[d] = u[h * D + d];

  // Iteration s: stretch s's bonus and steps, and the output of stretch
  // s - 1, whose partials the one barrier has made whole.
  stage(0);
  cp_async_commit();
  for (int s = 0; s <= ns; ++s) {
    cp_async_wait<0>();
    // stretch s has landed; stretch s - 1's partials are all in; the
    // stage that stretch s + 1 takes (stretch s - 2's) is all read
    __syncthreads();
    if (s + 1 < ns && (tf32x3::kStaging || s + 1 < L::kStages)) stage(s + 1);
    cp_async_commit();

    if (s > 0) {   // out for stretch s - 1: its G partials in order, then v
                   // times its bonus
      const float* part = part0 + ((s - 1) & 1) * L::kPart;
      const float* bon = bon0 + ((s - 1) & 1) * L::kBon;
      const T* sv = reinterpret_cast<const T*>(
          smem + ((s - 1) % L::kStages) * L::kStage + L::kOffV);
      const int t0 = (s - 1) * TS, n = min(TS, S - t0);
      for (int i = tid; i < n * E; i += NT) {
        const int t = i / E, c = i % E;
        float o = part[t * G * E + c];
#pragma unroll
        for (int j = 1; j < G; ++j) o += part[(t * G + j) * E + c];
        float bonus = bon[t * Q];
#pragma unroll
        for (int q = 1; q < Q; ++q) bonus += bon[t * Q + q];
        store1(out + head + static_cast<size_t>(t0 + t) * step + e0 + c,
               fmaf(to_f32(sv[t * E + c]), bonus, o));
      }
    }
    if (s == ns) break;

    float* part = part0 + (s & 1) * L::kPart;
    float* bon = bon0 + (s & 1) * L::kBon;
    const unsigned char* base = smem + (s % L::kStages) * L::kStage;
    const T* sr = reinterpret_cast<const T*>(base);
    const T* sk = reinterpret_cast<const T*>(base + L::kOffK);
    const TW* sw = reinterpret_cast<const TW*>(base + L::kOffW);
    const T* sv = reinterpret_cast<const T*>(base + L::kOffV);

    // the bonus: Q partial sums of r u k a step
    for (int i = tid; i < TS * Q; i += NT) {
      const int t = i / Q, d0 = (i % Q) * DQ;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < DQ; j += 4) {
        const int d = d0 + j;
        const float4 rr = ld4(sr + t * kLd + d), kk = ld4(sk + t * kLd + d);
        const float4 uu = *reinterpret_cast<const float4*>(su + d);
        acc = fmaf(rr.x * uu.x, kk.x, acc);
        acc = fmaf(rr.y * uu.y, kk.y, acc);
        acc = fmaf(rr.z * uu.z, kk.z, acc);
        acc = fmaf(rr.w * uu.w, kk.w, acc);
      }
      bon[i] = acc;
    }

    // the steps: this thread's share of r . S, then the decay
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      float rr[R], kk[R], ww[R], vv[C], p[C];
      ldcols(sv + t * E + c0, vv);
      ldrow(sr + t * kLd + g * R, rr);
      ldrow(sk + t * kLd + g * R, kk);
      ldrow(sw + t * kLdW + g * R, ww);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int i = 0; i < R; i += 2) {
          p0 = fmaf(rr[i], st[i][j], p0);
          p1 = fmaf(rr[i + 1], st[i + 1][j], p1);
        }
        p[j] = p0 + p1;
#pragma unroll
        for (int i = 0; i < R; ++i)
          st[i][j] = fmaf(ww[i], st[i][j], kk[i] * vv[j]);
      }
      stcols(part + (t * G + g) * E + c0, p);
    }
  }

  float* sfb = sf + static_cast<size_t>(bh) * D * D;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) sfb[(g * R + i) * D + e0 + c0 + j] = st[i][j];
}

template <typename T, typename TW, int D>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(wkv6_kernel<T, TW, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Layout<T, TW, D>::kBytes));
}

template <typename T, typename TW, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* out, void* sf, int B,
                   int S, int H, cudaStream_t stream) {
  using L = Layout<T, TW, D>;
  cudaError_t err = set_smem<T, TW, D>();
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  wkv6_kernel<T, TW, D><<<B * H * (D / L::E), L::NT, L::kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(sf), S, H, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* out,
                     void* sf, int B, int S, int H, int D, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, TW, 8>(r, k, v, w, u, s0, out, sf, B, S, H, s);
    case 16: return launch<T, TW, 16>(r, k, v, w, u, s0, out, sf, B, S, H, s);
    case 32: return launch<T, TW, 32>(r, k, v, w, u, s0, out, sf, B, S, H, s);
    case 64: return launch<T, TW, 64>(r, k, v, w, u, s0, out, sf, B, S, H, s);
    case 128: return launch<T, TW, 128>(r, k, v, w, u, s0, out, sf, B, S, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename TW, int D>
cudaError_t occupancy(int* out) {
  using L = Layout<T, TW, D>;
  cudaError_t err = set_smem<T, TW, D>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, wkv6_kernel<T, TW, D>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, wkv6_kernel<T, TW, D>, L::NT, L::kBytes);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(L::kBytes);
  out[3] = blocks;
  out[4] = L::NT;
  return err;
}

template <typename T, typename TW>
cudaError_t occupancy_of(int D, int* out) {
  switch (D) {
    case 8: return occupancy<T, TW, 8>(out);
    case 16: return occupancy<T, TW, 16>(out);
    case 32: return occupancy<T, TW, 32>(out);
    case 64: return occupancy<T, TW, 64>(out);
    case 128: return occupancy<T, TW, 128>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v and out) and wdtype (of w): 0 = float32,
// 1 = bfloat16; w is in r's type or float32.  s0 may be null.  Returns a
// cudaError_t as int.
extern "C" int wkv6(const void* r, const void* k, const void* v, const void* w,
                    const void* u, const void* s0, void* out, void* sf, int B,
                    int S, int H, int D, int dtype, int wdtype,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(err);
  if (dtype == 0 && wdtype == 0)
    err = dispatch<float, float>(r, k, v, w, u, s0, out, sf, B, S, H, D, s);
  else if (dtype == 1 && wdtype == 1)
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, out, sf,
                                                 B, S, H, D, s);
  else if (dtype == 1 && wdtype == 0)
    err = dispatch<__nv_bfloat16, float>(r, k, v, w, u, s0, out, sf, B, S, H,
                                         D, s);
  return static_cast<int>(err);
}

// What the kernel for (dtype, wdtype, D) occupies: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] dynamic shared
// memory a block, out[3] blocks an SM can hold, out[4] threads a block.
extern "C" int wkv6_occupancy(int dtype, int wdtype, int D, int* out) {
  if (dtype == 0 && wdtype == 0)
    return static_cast<int>(occupancy_of<float, float>(D, out));
  if (dtype == 1 && wdtype == 1)
    return static_cast<int>(
        occupancy_of<__nv_bfloat16, __nv_bfloat16>(D, out));
  if (dtype == 1 && wdtype == 0)
    return static_cast<int>(occupancy_of<__nv_bfloat16, float>(D, out));
  return static_cast<int>(cudaErrorInvalidValue);
}
