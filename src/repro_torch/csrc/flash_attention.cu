// Causal or non-causal GQA flash attention, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py
// (flash_attention_hm, inner `_kernel`).  Head-major layouts:
// q [B, H, Sq, D], k/v [B, Hkv, Skv, D], out [B, H, Sq, D] in q's type;
// query head h reads kv head h / (H / Hkv).  For every query row
//
//   out = softmax(q k^T / sqrt(D)) v,   causal: key kpos visible iff
//                                        kpos <= qpos (both from 0)
//
// with the Pallas body's numerics: products and softmax in f32 (inputs
// are widened on load), running max m, sum l and accumulator acc in f32,
// masked scores set to NEG_INF = -1e30, and out = acc / max(l, 1e-30).
// Float inputs are multiplied in plain f32 FMAs, never TF32.
//
// Design.  The Pallas grid walks the kv blocks as a sequential axis with
// m/l/acc in VMEM scratch.  Here one block of 256 threads owns a 64-row
// query tile of one (b, h) and loops over 64-key tiles itself, stopping
// at the causal horizon (the last key tile that starts at or below the
// tile's last row), so nothing is carried between blocks.  The query
// tile and each K/V tile are staged in shared memory as f32 with padded
// rows (D + 4 floats: float4 reads of eight neighbouring rows fall in
// distinct banks).  Thread (ty, tx), ty = 0..15, tx = 0..15, computes the
// 4 x 4 scores of rows 4ty..4ty+3 and keys tx + 16i; a row's max and sum
// are reduced across its 16 threads with shuffles (the 16 threads of one
// row group share a half-warp).  P goes to shared memory transposed, and
// the same thread then accumulates rows 4ty..4ty+3 of P V for columns
// 64c + 4tx .. 64c + 4tx + 3.  Heavy (late) query tiles are launched
// first to shorten the causal tail.  wgmma and TMA are later work.
//
// Bound.  Causal attention at B=2, S=4096, H=32, D=64 (llama3.2-1b's
// prefill) is 4 * B * H * D * S(S+1)/2 = 137.5 GFLOP against 168 MB of
// q/k/v/o: about 2.05 ms at the H100's 67 TFLOP/s of f32 outside the
// tensor cores, against 50 us for the bytes, so it is bound by
// operations.  In bf16 only a tensor-core kernel can approach the
// 989 TFLOP/s bound (0.14 ms); this one still multiplies in f32.
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

namespace {

constexpr int kBQ = 64;           // query rows of a block
constexpr int kBK = 64;           // keys of a kv tile
constexpr int kThreads = 256;     // 16 row groups x 16 key lanes
constexpr int kLP = kBQ + 4;      // padded row stride of P^T
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows r0 .. r0+63 of a [rows, D] matrix into dst[64][D + 4] as f32;
// rows at or past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < 64 * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) x = load4(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int Sq, int Skv, float scale, int causal) {
  constexpr int kLD = D + 4;
  constexpr int kCols = D / 64;   // float4 column groups a thread owns
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBQ][kLD]
  float* sK = sQ + kBQ * kLD;                    // [kBK][kLD]
  float* sV = sK + kBK * kLD;                    // [kBK][kLD]
  float* sP = sV + kBK * kLD;                    // [kBK][kLP], P transposed

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;                     // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heavy tiles first
  const T* qb = q + static_cast<size_t>(bh) * Sq * D;
  const size_t kv_off = static_cast<size_t>(b * Hkv + hk) * Skv * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  load_tile<T, D>(sQ, qb, q0, Sq);

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[a][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();               // the last tile's readers are done
    load_tile<T, D>(sK, kb, k0, Skv);
    load_tile<T, D>(sV, vb, k0, Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[a][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = load4(sQ + (4 * ty + a) * kLD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = load4(sK + (tx + 16 * i) * kLD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[a][i];
          x = fmaf(qv[a].x, kv[i].x, x);
          x = fmaf(qv[a].y, kv[i].y, x);
          x = fmaf(qv[a].z, kv[i].z, x);
          x = fmaf(qv[a].w, kv[i].w, x);
          s[a][i] = x;
        }
    }

    // scale, mask, online softmax (a row's 16 threads share a half-warp)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + 4 * ty + a;
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + tx + 16 * i;
        float x = s[a][i] * scale;
        if (kpos >= Skv || (causal && kpos > qpos)) x = kNegInf;
        s[a][i] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[a][i] - m_new);
        s[a][i] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[a] = l[a] * corr + ps;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[a][c] *= corr;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) sP[(tx + 16 * i) * kLP + 4 * ty + a] = s[a][i];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p = load4(sP + j * kLP + 4 * ty);
      const float pa[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv = load4(sV + j * kLD + 64 * c + 4 * tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][4 * c + 0] = fmaf(pa[a], vv.x, acc[a][4 * c + 0]);
          acc[a][4 * c + 1] = fmaf(pa[a], vv.y, acc[a][4 * c + 1]);
          acc[a][4 * c + 2] = fmaf(pa[a], vv.z, acc[a][4 * c + 2]);
          acc[a][4 * c + 3] = fmaf(pa[a], vv.w, acc[a][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ty + a;
    if (row >= Sq) continue;
    const float lsum = fmaxf(l[a], 1e-30f);
    T* orow = out + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(orow + 64 * c + 4 * tx + e, acc[a][4 * c + e] / lsum);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int Sq, int Skv, int causal,
                   cudaStream_t stream) {
  constexpr int kLD = D + 4;
  constexpr size_t kSmem = sizeof(float) * (3 * 64 * kLD + kBK * kLP);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Sq, Skv,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))), causal);
  return cudaGetLastError();
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
