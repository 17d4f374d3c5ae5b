// Shared device helpers for the fused attention-block kernels.
//
// Every kernel keeps its working tiles in shared memory as float holding
// values already rounded to the element type T, so one code path serves
// float and bfloat16: T only decides where values are rounded (the points
// where the JAX reference casts to its compute dtype) and how global memory
// is read and written. Accumulation and all statistics are float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace srgd {

constexpr float NEG = -1e30f;      // running-max start, as NEG in the TPU kernel
constexpr int THREADS = 256;       // 8 warps per block in every kernel
constexpr int TM = 32;             // rows per tile: 4 per warp
constexpr int KC = 16;             // weight rows staged per step of rows_matmul
constexpr int DH = 32;             // dim_head: one lane per head channel
constexpr int MAXH = 128;          // largest hidden width (4 heads x 32)

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// v rounded to T and widened back: a cast to the compute dtype.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ys[r][:] = round_T(x[row0 + r] / max(||x[row0 + r]||, 1e-12) * g1s) for the
// TM rows of a tile (g1s = g1 * sqrt(c), folded on the host); rows at or past
// nvalid are zero. One warp per row, lanes strided over c.
template <typename T>
__device__ __forceinline__ void load_norm_rows(const T* __restrict__ x, const float* __restrict__ g1s,
                                               float* ys, int nvalid, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TM; r += THREADS / 32) {
    float* yr = ys + r * c;
    float ss = 0.f;
    if (r < nvalid) {
      const T* xr = x + (size_t)r * c;
      for (int j = lane; j < c; j += 32) {
        const float v = to_f32<T>(xr[j]);
        yr[j] = v;
        ss += v * v;
      }
    } else {
      for (int j = lane; j < c; j += 32) yr[j] = 0.f;
    }
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
    __syncwarp();
    for (int j = lane; j < c; j += 32) yr[j] = round_to<T>(yr[j] / nrm * g1s[j]);
  }
}

// acc[i][j] += sum_k a[(warp*4 + i)*lda + k] * w[k*ldw + col0 + lane + 32*j]
// over k < K: a tile's TM rows times a (K, ldw) row-major weight in global
// memory. Columns at or past ldw read as zero. The weight is staged through
// ws (KC x 32*RN floats) KC rows at a time, read as T and widened. Every
// thread of the block must call it; it synchronises on entry and exit, so a
// and ws may be rewritten right after it returns.
template <typename T, int RN>
__device__ __forceinline__ void rows_matmul(float (&acc)[4][RN], const float* a, int lda, int K,
                                            const T* __restrict__ w, int ldw, int col0, float* ws) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int WIDTH = 32 * RN;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    for (int idx = tid; idx < kc * WIDTH; idx += THREADS) {
      const int kk = idx / WIDTH, col = col0 + idx - kk * WIDTH;
      ws[idx] = col < ldw ? to_f32<T>(w[(size_t)(k0 + kk) * ldw + col]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(warp * 4 + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float bv = ws[kk * WIDTH + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

template <int R, int C> __device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.f;
}

}  // namespace srgd
