// Shared device helpers for the attention and linear-attention kernels: the
// float32 instantiations and the kernels that run on the CUDA cores (the
// bfloat16 tensor-core pieces are in mma.cuh).
//
// These kernels keep their working tiles in shared memory as float holding
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
constexpr int LDKV = 2 * MAXH;     // row of a k | v tile in shared memory

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

// ---------------------------------------------------------------------------
// Linear attention: the k-softmax over the sequence and the context product,
// split over blocks. Each block streams its rows tile by tile with an online
// column max and leaves a partial (m, z, ctx); merge_kv_partials combines
// them. Only the head-diagonal 32x32 blocks of ctx are kept: the head mask
// zeroes the rest.
// ---------------------------------------------------------------------------

// Start a block's running statistics: m = NEG, z = 0, ctx accumulator = 0.
__device__ __forceinline__ void kv_stream_init(float* m_run, float* z_run, float (&acc)[16]) {
  for (int j = threadIdx.x; j < MAXH; j += THREADS) {
    m_run[j] = NEG;
    z_run[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
}

// Fold one TM-row tile into the running statistics. kv is TM x LDKV floats in
// shared memory: columns [0, hidden) hold k as float (rows past the end NEG,
// so they never win the max), columns [MAXH, MAXH + hidden) hold v. On
// return the k columns hold exp(k - m) rounded to R. Warp w accumulates head
// w/2, context rows (w%2)*16 + i of that head, column `lane`:
//   ctx[d][e] = ctx[d][e] * alpha[d] + sum_r ek[r][d] * v[r][e]
// Every thread of the block must call it; it synchronises on entry, so the
// caller only writes kv before it.
template <typename R>
__device__ __forceinline__ void kv_stream_tile(float* kv, float* m_run, float* z_run, float* alpha,
                                               float (&acc)[16], int hidden) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __syncthreads();
  // online k-softmax statistics, one thread per hidden column
  if (tid < hidden) {
    float mt = NEG;
    for (int r = 0; r < TM; ++r) mt = fmaxf(mt, kv[r * LDKV + tid]);
    const float mo = m_run[tid];
    const float mn = fmaxf(mo, mt);
    const float al = expf(mo - mn);
    float s = 0.f;
    for (int r = 0; r < TM; ++r) {
      const float e = expf(kv[r * LDKV + tid] - mn);
      s += e;
      kv[r * LDKV + tid] = round_to<R>(e);
    }
    z_run[tid] = z_run[tid] * al + s;
    m_run[tid] = mn;
    alpha[tid] = al;
  }
  __syncthreads();

  const int head = warp >> 1;
  const int dbase = head * DH + (warp & 1) * 16;
  if (head < hidden / DH) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha[dbase + i];
    for (int r = 0; r < TM; ++r) {
      const float ve = kv[r * LDKV + MAXH + head * DH + lane];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(kv[r * LDKV + dbase + i], ve, acc[i]);
    }
  }
}

// Write a block's partial: part_m, part_z (b, nsplit, hidden) and part_ctx
// (b, nsplit, hidden, 32); p = batch * nsplit + split.
__device__ __forceinline__ void kv_stream_store(const float* m_run, const float* z_run,
                                                const float (&acc)[16], float* __restrict__ part_m,
                                                float* __restrict__ part_z,
                                                float* __restrict__ part_ctx, size_t p, int hidden) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int j = tid; j < hidden; j += THREADS) {
    part_m[p * hidden + j] = m_run[j];
    part_z[p * hidden + j] = z_run[j];
  }
  const int head = warp >> 1;
  const int dbase = head * DH + (warp & 1) * 16;
  if (head < hidden / DH) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part_ctx[(p * hidden + dbase + i) * DH + lane] = acc[i];
  }
}

// ctxn[b][d][e] = round_R(sum_s ctx_s[d][e] w_s / sum_s z_s[d] w_s * scale),
// w_s = exp(m_s[d] - m[d]), the splits summed in index order so the result
// does not depend on how the blocks were scheduled. Grid (hidden, b), one
// warp: lane = e.
template <typename R>
__global__ void merge_kv_partials(const float* __restrict__ part_m,
                                  const float* __restrict__ part_z,
                                  const float* __restrict__ part_ctx, float* __restrict__ ctxn,
                                  int hidden, int nsplit, float scale) {
  const int d = blockIdx.x, bi = blockIdx.y, e = threadIdx.x;
  const size_t p0 = (size_t)bi * nsplit;
  float m = NEG;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_m[(p0 + s) * hidden + d]);
  float z = 0.f, cx = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(part_m[(p0 + s) * hidden + d] - m);
    z += part_z[(p0 + s) * hidden + d] * w;
    cx += part_ctx[((p0 + s) * hidden + d) * DH + e] * w;
  }
  ctxn[((size_t)bi * hidden + d) * DH + e] = round_to<R>(cx / z * scale);
}

// Per-head softmax of q over each head's 32 columns, for the 4 rows a warp
// owns: pq[i][j] is row warp*4+i, column j*32 + lane. Shifted by the row max
// over all heads (exact: a row-shared shift). Writes
// qs[row][col] = round_R(e / denom * scale), qs rows MAXH floats apart.
template <typename R>
__device__ __forceinline__ void head_softmax_rows(const float (&pq)[4][4], float* qs, int nh,
                                                  float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nh) mx = fmaxf(mx, pq[i][j]);
    mx = warp_max(mx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e = j < nh ? expf(pq[i][j] - mx) : 0.f;
      const float den = warp_sum(e);
      if (j < nh) qs[(warp * 4 + i) * MAXH + j * DH + lane] = round_to<R>(e / den * scale);
    }
  }
}

// pa[i][j] = sum_d qs[warp*4+i][j*32 + d] * cs[(j*32 + d)*32 + lane]: the
// rows times their heads' context blocks (cs: hidden x 32 floats).
__device__ __forceinline__ void rows_times_context(float (&pa)[4][4], const float* qs,
                                                   const float* cs, int nh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  zero(pa);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < nh) {
      for (int d = 0; d < DH; ++d) {
        const float cv = cs[(j * DH + d) * DH + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[i][j] = fmaf(qs[(warp * 4 + i) * MAXH + j * DH + d], cv, pa[i][j]);
      }
    }
  }
}

}  // namespace srgd
