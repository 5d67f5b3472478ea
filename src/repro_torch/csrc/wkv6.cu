// The RWKV6 (WKV) recurrence, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/wkv6.py (wkv6_pallas,
// inner `_kernel`).  r, k, v are [B, S, H, D] in one type (f32 or bf16),
// w [B, S, H, D] in that type or f32 (the RWKV6 layer computes its decay
// in f32), u is [H, D] f32, the state [B, H, D, D] f32 (key-major:
// S[d][e]).
// For each (b, h) and each step t, in f32:
//
//   out_t[e] = sum_d r_t[d] * (S[d][e] + u[d] * k_t[d] * v_t[e])
//            = sum_d r_t[d] * S[d][e] + v_t[e] * sum_d r_t[d] u[d] k_t[d]
//   S[d][e] <- w_t[d] * S[d][e] + k_t[d] * v_t[e]
//
// out is written in r's type; the final state in f32.  No initial state
// (a null pointer) means zeros.
//
// Design.  The Pallas grid carries the [D, D] state in VMEM scratch across
// a sequential axis of time chunks.  Here one block of D threads owns one
// (b, h) and loops over time itself.  Column e of the state only ever
// meets v_t[e] and feeds only out_t[e], so thread e keeps S[:, e] in D
// registers for the whole sequence and computes r_t . S[:, e] serially
// over d: no state traffic to memory beyond the first read and the last
// write.  The bonus sum_d r u k is the same for every e, so it is reduced
// once a step across the block (warp shuffles while the step is staged)
// and not once a column.  The streams are staged through shared memory a
// stretch of kT steps at a time (kT * D = 2048 values of each of r, k, w,
// v, coalesced loads, one barrier pair per stretch); every thread then
// reads r_t, k_t, w_t as broadcasts.
//
// Bound.  At rwkv6-1.6b's serve prefill (B=4, S=512, H=32, D=64, f32) the
// kernel must read four [B,S,H,D] streams (67 MB), u, the initial state
// (2 MB) and write out (17 MB) and the final state (2 MB): 88 MB, 26 us at
// 3.35 TB/s.  Its f32 work is 5 operations per (step, d, e) -- an FMA of
// r . S, the k v product and the decay FMA -- plus 5 per (step, d) for the
// bonus: 5 * B*S*H*D*(D+1) = 1.36 GFLOP, 20 us at 67 TFLOP/s.  So it is
// bound by bytes.  This simple form is latency-bound instead: B*H = 128
// blocks of 64 threads, one chain of S steps each.
//
// Contract.  The kernel launches on the caller's stream, does not
// synchronize and allocates nothing; the caller checks devices, types,
// shapes and contiguity.  D is 8, 16, 32, 64 or 128.  The entry point
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, typename TW, int D>
__global__ void __launch_bounds__(D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ sf, int S, int H) {
  constexpr int kT = 2048 / D;      // steps staged per stretch
  constexpr int kLanes = D < 32 ? D : 32;
  constexpr int kWarps = D / kLanes;
  constexpr unsigned kMask = D < 32 ? (1u << kLanes) - 1u : 0xffffffffu;
  // sb[i][j]: warp j's part of step i's bonus sum_d r u k
  __shared__ float sr[kT][D], sk[kT][D], sw[kT][D], sv[kT][D], sb[kT][kWarps];

  const int e = threadIdx.x;        // the state column this thread owns
  const int bh = blockIdx.x;        // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const size_t step = static_cast<size_t>(H) * D;   // stride of t
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D + e;

  float st[D];
  const float* s0b = s0 == nullptr ? nullptr : s0 + static_cast<size_t>(bh) * D * D;
#pragma unroll
  for (int d = 0; d < D; ++d) st[d] = s0b == nullptr ? 0.f : s0b[d * D + e];
  const float ue = u[h * D + e];

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    __syncthreads();               // the last stretch's readers are done
    for (int i = 0; i < n; ++i) {
      const size_t at = base + static_cast<size_t>(t0 + i) * step;
      const float ri = to_f32(r[at]), ki = to_f32(k[at]);
      sr[i][e] = ri;
      sk[i][e] = ki;
      sw[i][e] = to_f32(w[at]);
      sv[i][e] = to_f32(v[at]);
      float bonus = ri * ue * ki;
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        bonus += __shfl_xor_sync(kMask, bonus, off);
      if (e % kLanes == 0) sb[i][e / kLanes] = bonus;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float vt = sv[i][e];
      float bonus = 0.f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) bonus += sb[i][j];
      float o = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        o = fmaf(sr[i][d], st[d], o);
        st[d] = fmaf(sw[i][d], st[d], sk[i][d] * vt);
      }
      store1(out + base + static_cast<size_t>(t0 + i) * step,
             fmaf(vt, bonus, o));
    }
  }

  float* sfb = sf + static_cast<size_t>(bh) * D * D;
#pragma unroll
  for (int d = 0; d < D; ++d) sfb[d * D + e] = st[d];
}

template <typename T, typename TW, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* out, void* sf, int B,
                   int S, int H, cudaStream_t stream) {
  wkv6_kernel<T, TW, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(sf), S, H);
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
