// The Mamba2 SSD (state space dual) chunked scan, hand-written for Hopper
// (sm_90a).
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
// a sequential axis of chunks.  Here one block of 256 threads owns one
// (b, h) and loops over the chunks itself, with the state in shared
// memory for the whole sequence.  A chunk's x, B and C are staged in
// shared memory as f32 (P and N zero-padded to 64, rows padded to 68
// floats so float4 reads of eight neighbouring rows fall in distinct
// banks); warp 0 loads dt and forms cum with a warp scan (two steps a
// lane).  Then three 64 x 64 x 64 products, each thread a 4 x 4 tile
// (ty = 0..15 picks rows 4ty..4ty+3, tx = 0..15 columns tx + 16i):
//   1. G = C B^T (scores) and C state^T (the inter term, scaled by
//      exp(cum[t]));  M = G exp(cum[t] - cum[s]) dt_s at or below the
//      diagonal, written transposed to shared memory.  The decay is
//      masked before the exponential: above the diagonal cum[t] - cum[s]
//      is positive and overflows exp for large dt |A|, and inf * 0 would
//      be NaN.
//   2. y = inter + M x, each warp stopping at its last row's diagonal.
//   3. the state update x^T diag(w) B, w_s = dt_s exp(cum[end] - cum[s]),
//      added to exp(cum[end]) state in place.
// Products are plain f32 FMAs: no TF32 (the reference's f32 tolerance is
// about TF32's precision) and no wgmma or TMA yet.  Bm and Cm are shared
// by all H heads and re-read by each head's block, as the Pallas grid
// re-reads them; they stay in the 50 MB L2.  The tail of a sequence that
// is not a multiple of 64 is zero-padded with dt = 0 (decay 1, no
// contribution), as the reference pads.
//
// Bound.  At zamba2-7b's serve prefill (x [4, 512, 112, 64], N = 64, f32)
// the kernel must read x (58.7 MB), dt, A, Bm, Cm (2 MB) and the initial
// state (7.3 MB), and write y (58.7 MB) and the final state (7.3 MB):
// about 134 MB, 40 us at 3.35 TB/s.  The least work is the chunked form
// at its best chunk L: a (step, head) needs 2 P N for C . state, 2 P N
// for the state update, P N / L to decay the state once a chunk, and
// (L + 1)(P + 1 + N / H) for the pairs at or below the diagonal (M x,
// the decay, and C . B shared by all H heads).  At L = 8 that is about
// 4.27 P N, 4.0 GFLOP, 60 us at 67 TFLOP/s: bound by operations.  This
// kernel does about 4 P N + kL (2 N + P) a (step, head) (G over the
// whole tile per head, M x to each warp's diagonal), 64% more at
// kL = 64, to fill 64-wide products.
//
// Contract.  The kernel launches on the caller's stream, does not
// synchronize and allocates nothing; the caller checks devices, types,
// shapes and contiguity.  1 <= P, N <= 64.  The entry point returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;            // time steps of a chunk
constexpr int kD = 64;            // P and N, zero-padded
constexpr int kLD = kD + 4;       // padded row stride in shared memory
constexpr int kThreads = 256;     // 16 row groups x 16 column lanes
constexpr unsigned kFull = 0xffffffffu;
// x, B, C, state, M^T tiles, then cum, dt, exp(cum), w and exp(cum[end])
constexpr size_t kSmemFloats = 5 * kL * kLD + 4 * kL + 4;
constexpr size_t kSmem = sizeof(float) * kSmemFloats;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows t0 .. t0+kL-1 of a stream whose row t starts at src + t * stride
// and holds `cols` values, into dst[kL][kLD] as f32; zero past S or cols.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t stride, int t0, int S,
                                          int cols) {
  for (int idx = threadIdx.x; idx < kL * kD; idx += kThreads) {
    const int r = idx / kD;
    const int c = idx % kD;
    float v = 0.f;
    if (t0 + r < S && c < cols)
      v = to_f32(src[static_cast<size_t>(t0 + r) * stride + c]);
    dst[r * kLD + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ sf, int S, int H, int P,
           int N) {
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);   // [kL][kLD]  x[s][p]
  float* sB = sX + kL * kLD;                     // [kL][kLD]  B[s][n]
  float* sC = sB + kL * kLD;                     // [kL][kLD]  C[t][n]
  float* sS = sC + kL * kLD;                     // [kD][kLD]  state[p][n]
  float* sM = sS + kD * kLD;                     // [kL][kLD]  M[t][s] at [s][t]
  float* sCum = sM + kL * kLD;                   // [kL]
  float* sDt = sCum + kL;                        // [kL]
  float* sSeg = sDt + kL;                        // [kL] exp(cum[t])
  float* sW = sSeg + kL;                         // [kL] dt_s exp(cum[end] - cum[s])
  float* sEnd = sW + kL;                         // exp(cum[end])

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;                     // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const float a_h = A[h];
  const size_t xrow = static_cast<size_t>(H) * P;    // stride of t in x, y
  const size_t xoff = (static_cast<size_t>(b) * S * H + h) * P;
  const T* xb = x + xoff;
  T* yb = y + xoff;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const T* Bb = Bm + static_cast<size_t>(b) * S * N;
  const T* Cb = Cm + static_cast<size_t>(b) * S * N;

  const float* s0b = s0 == nullptr ? nullptr
                                   : s0 + static_cast<size_t>(bh) * P * N;
  for (int idx = threadIdx.x; idx < kD * kD; idx += kThreads) {
    const int r = idx / kD;
    const int c = idx % kD;
    sS[r * kLD + c] = (s0b != nullptr && r < P && c < N) ? s0b[r * N + c]
                                                          : 0.f;
  }

  // warp w's rows end at 8w + 7: the intra product stops at that diagonal
  const int s_end = ((threadIdx.x >> 5) + 1) * 8;

  for (int t0 = 0; t0 < S; t0 += kL) {
    __syncthreads();               // the last chunk's readers are done
    load_rows(sX, xb, xrow, t0, S, P);
    load_rows(sB, Bb, static_cast<size_t>(N), t0, S, N);
    load_rows(sC, Cb, static_cast<size_t>(N), t0, S, N);
    if (threadIdx.x < 32) {
      // lane l owns steps 2l and 2l+1; padded steps have dt = 0
      const int lane = threadIdx.x;
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float d0 = t0 + i0 < S ? dtb[static_cast<size_t>(t0 + i0) * H] : 0.f;
      const float d1 = t0 + i1 < S ? dtb[static_cast<size_t>(t0 + i1) * H] : 0.f;
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
      sDt[i0] = d0;
      sDt[i1] = d1;
      sSeg[i0] = expf(c0);
      sSeg[i1] = expf(c1);
      sW[i0] = d0 * expf(end - c0);
      sW[i1] = d1 * expf(end - c1);
      if (lane == 0) *sEnd = expf(end);
    }
    __syncthreads();

    // 1. G[t][s] = C_t . B_s and inter[t][p] = C_t . state[p]:
    //    rows t = 4ty + a, columns s (and p) = tx + 16i
    float g[4][4], acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) g[a][i] = acc[a][i] = 0.f;
#pragma unroll 4
    for (int n = 0; n < kD; n += 4) {
      float4 cv[4], bv[4], sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = ld4(sC + (4 * ty + a) * kLD + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bv[i] = ld4(sB + (tx + 16 * i) * kLD + n);
        sv[i] = ld4(sS + (tx + 16 * i) * kLD + n);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[a][i] = dot4(cv[a], bv[i], g[a][i]);
          acc[a][i] = dot4(cv[a], sv[i], acc[a][i]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * ty + a;
      const float ct = sCum[t];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = tx + 16 * i;
        // mask first: above the diagonal exp(ct - cum[s]) may be inf
        const float m = s <= t ? g[a][i] * expf(ct - sCum[s]) * sDt[s] : 0.f;
        sM[s * kLD + t] = m;
        acc[a][i] *= sSeg[t];
      }
    }
    __syncthreads();

    // 2. y[t][p] = inter + sum_{s<=t} M[t][s] x[s][p]
    for (int s = 0; s < s_end; ++s) {
      const float4 m = ld4(sM + s * kLD + 4 * ty);
      const float ma[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = sX[s * kLD + tx + 16 * i];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][i] = fmaf(ma[a], xv, acc[a][i]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = t0 + 4 * ty + a;
      if (t >= S) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tx + 16 * i;
        if (p < P) store1(yb + static_cast<size_t>(t) * xrow + p, acc[a][i]);
      }
    }

    // 3. state[p][n] = exp(cum[end]) state[p][n] + sum_s w_s x[s][p] B[s][n]:
    //    rows p = 4ty + a, columns n = tx + 16i (each thread owns its
    //    entries; step 1's readers passed the barrier above)
    float ns[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) ns[a][i] = 0.f;
#pragma unroll 4
    for (int s = 0; s < kL; ++s) {
      const float4 xv = ld4(sX + s * kLD + 4 * ty);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float w = sW[s];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float bw = w * sB[s * kLD + tx + 16 * i];
#pragma unroll
        for (int a = 0; a < 4; ++a) ns[a][i] = fmaf(xa[a], bw, ns[a][i]);
      }
    }
    const float e = *sEnd;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* st = sS + (4 * ty + a) * kLD + tx + 16 * i;
        *st = fmaf(e, *st, ns[a][i]);
      }
  }
  __syncthreads();

  float* sfb = sf + static_cast<size_t>(bh) * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += kThreads)
    sfb[idx] = sS[(idx / N) * kLD + idx % N];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* s0, void* y,
                   void* sf, int B, int S, int H, int P, int N,
                   cudaStream_t stream) {
  auto kernel = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sf), S, H, P, N);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  s0 may be null.
// Returns a cudaError_t as int.
extern "C" int ssd(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* s0, void* y,
                   void* sf, int B, int S, int H, int P, int N, int dtype,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kD || N <= 0 || N > kD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, s0, y, sf, B, S, H, P, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, s0, y, sf, B, S, H, P, N,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
