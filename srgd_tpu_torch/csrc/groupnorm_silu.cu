// GroupNorm + optional FiLM + SiLU for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srgd_tpu/kernels/groupnorm_silu.py
// (fused_groupnorm_silu, bodies _stats_kernel and _scale_shift_silu_kernel):
//   y = GroupNorm(x; groups, eps) * gamma + beta
//   y = y * (film_scale + 1) + film_shift        (when film is given)
//   out = y * sigmoid(y)
// on x (b, rows, c) with the channel as the fast axis, which is what an NCHW
// tensor in channels_last memory is.
//
// Three launches. (1) stats: the TPU kernel adds each row chunk's per-channel
// sum and sum of squares into one output block over a sequential grid; blocks
// here run in no order, so each (chunk, batch) block writes its own partial
// (2, c) and nothing is added atomically. (2) fold: one block per batch
// element adds the partials in chunk order, folds channels into groups
// (mean, E[x^2] - mean^2 in float, as the TPU wrapper does between its two
// calls) and merges the GroupNorm affine and the FiLM into one per-channel
// (scale, shift). The result does not depend on how the blocks were
// scheduled. (3) apply: out = silu(x * scale + shift), one pass.
//
// Bound on this card: memory. x is read twice (once for the statistics, once
// to normalise) and the output written once; there is no product. Loads and
// stores are 16-byte vectors over consecutive channels wherever c allows
// (VEC elements; else one element at a time), so a warp reads whole rows.
#include "common.cuh"

using namespace srgd;

namespace {

template <typename T, int VEC> struct Pack;
template <> struct alignas(16) Pack<float, 4> { float v[4]; };
template <> struct alignas(16) Pack<__nv_bfloat16, 8> { __nv_bfloat16 v[8]; };
template <> struct Pack<float, 1> { float v[1]; };
template <> struct Pack<__nv_bfloat16, 1> { __nv_bfloat16 v[1]; };

// part[b][chunk][0][c] = sum over the chunk's rows of x, [1][c] of x^2.
// The block's threads form a (ty, tx) layout of cols = min(c / VEC, THREADS)
// vector columns by THREADS / cols row lanes; the row lanes' sums meet in
// shared memory (dynamic: 2 * lanes * cols * VEC floats) and are added in
// lane order.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
gn_stats(const T* __restrict__ x, float* __restrict__ part, int rows, int c, int rows_per_chunk,
         int nchunk) {
  extern __shared__ float red[];
  const int cv = c / VEC;
  const int cols = min(cv, THREADS);
  const int lanes = THREADS / cols;
  const int tx = threadIdx.x % cols, ty = threadIdx.x / cols;
  const int chunk = blockIdx.x, bi = blockIdx.y;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(row_begin + rows_per_chunk, rows);
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x + (size_t)bi * rows * c);
  float* out = part + ((size_t)bi * nchunk + chunk) * 2 * c;

  for (int col0 = 0; col0 < cv; col0 += cols) {
    const int col = col0 + tx;
    float s[VEC], ss[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = ss[e] = 0.f;
    if (ty < lanes && col < cv) {
      for (int r = row_begin + ty; r < row_end; r += lanes) {
        const Pack<T, VEC> p = xv[(size_t)r * cv + col];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f32<T>(p.v[e]);
          s[e] += f;
          ss[e] = fmaf(f, f, ss[e]);
        }
      }
    }
    __syncthreads();  // the previous column group's sums are written out
    if (ty < lanes) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        red[(ty * cols + tx) * VEC + e] = s[e];
        red[((lanes + ty) * cols + tx) * VEC + e] = ss[e];
      }
    }
    __syncthreads();
    if (ty == 0 && col < cv) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = 0.f, b2 = 0.f;
        for (int k = 0; k < lanes; ++k) {
          a += red[(k * cols + tx) * VEC + e];
          b2 += red[((lanes + k) * cols + tx) * VEC + e];
        }
        out[col * VEC + e] = a;
        out[c + col * VEC + e] = b2;
      }
    }
  }
}

// ss[b][0][ch] = scale, ss[b][1][ch] = shift with
//   scale = inv_g * gamma, shift = beta - mean_g * scale, then with FiLM
//   scale *= fs + 1, shift = shift * (fs + 1) + fb.
// One block per batch element; dynamic shared memory 2 * c floats.
__global__ void __launch_bounds__(THREADS)
gn_fold(const float* __restrict__ part, const float* __restrict__ gamma,
        const float* __restrict__ beta, const float* __restrict__ film, float* __restrict__ ss,
        int rows, int c, int groups, int nchunk, float eps) {
  extern __shared__ float sums[];  // per-channel sum | sum of squares
  const int bi = blockIdx.x;
  const float* pb = part + (size_t)bi * nchunk * 2 * c;
  for (int j = threadIdx.x; j < 2 * c; j += THREADS) {
    float a = 0.f;
    for (int k = 0; k < nchunk; ++k) a += pb[(size_t)k * 2 * c + j];
    sums[j] = a;
  }
  __syncthreads();
  const int cg = c / groups;
  const float count = (float)rows * (float)cg;
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    const int g0 = ch / cg * cg;
    float gs = 0.f, gss = 0.f;
    for (int j = 0; j < cg; ++j) {
      gs += sums[g0 + j];
      gss += sums[c + g0 + j];
    }
    const float mean = gs / count;
    const float var = gss / count - mean * mean;
    const float inv = 1.0f / sqrtf(var + eps);
    float scale = inv * gamma[ch];
    float shift = beta[ch] - mean * scale;
    if (film != nullptr) {
      const float fs = film[((size_t)bi * 2) * c + ch] + 1.0f;
      const float fb = film[((size_t)bi * 2 + 1) * c + ch];
      scale = scale * fs;
      shift = shift * fs + fb;
    }
    ss[((size_t)bi * 2) * c + ch] = scale;
    ss[((size_t)bi * 2 + 1) * c + ch] = shift;
  }
}

// out = silu(x * scale[b][ch] + shift[b][ch]); grid (blocks, b), each batch
// element a grid-stride loop over its rows * c / VEC vectors.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
gn_apply(const T* __restrict__ x, const float* __restrict__ ss, T* __restrict__ out, int rows,
         int c) {
  const int cv = c / VEC, bi = blockIdx.y;
  const int nvec = rows * cv;
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x + (size_t)bi * rows * c);
  Pack<T, VEC>* ov = reinterpret_cast<Pack<T, VEC>*>(out + (size_t)bi * rows * c);
  const float* sb = ss + (size_t)bi * 2 * c;
  for (int idx = blockIdx.x * THREADS + threadIdx.x; idx < nvec; idx += gridDim.x * THREADS) {
    const int ch = idx % cv * VEC;
    float sc[VEC], sh[VEC];
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(sb + ch + e);
        const float4 d = *reinterpret_cast<const float4*>(sb + c + ch + e);
        sc[e] = a.x, sc[e + 1] = a.y, sc[e + 2] = a.z, sc[e + 3] = a.w;
        sh[e] = d.x, sh[e + 1] = d.y, sh[e + 2] = d.z, sh[e + 3] = d.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sc[e] = sb[ch + e];
        sh[e] = sb[c + ch + e];
      }
    }
    const Pack<T, VEC> p = xv[idx];
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float y = fmaf(to_f32<T>(p.v[e]), sc[e], sh[e]);
      o.v[e] = from_f32<T>(y / (1.0f + expf(-y)));
    }
    ov[idx] = o;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* gamma, const void* beta, const void* film, void* part,
           void* ss, void* out, int b, int rows, int c, int groups, int rows_per_chunk, int nchunk,
           float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = min(c / VEC, THREADS);
  const int lanes = THREADS / cols;
  const size_t smem_stats = sizeof(float) * 2 * lanes * cols * VEC;
  gn_stats<T, VEC><<<dim3(nchunk, b), THREADS, smem_stats, st>>>(
      static_cast<const T*>(x), static_cast<float*>(part), rows, c, rows_per_chunk, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_fold<<<b, THREADS, sizeof(float) * 2 * c, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(film), static_cast<float*>(ss),
      rows, c, groups, nchunk, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // enough blocks for about 16 an SM over the batch, each thread at least one vector
  const int nvec = rows * (c / VEC);
  const int blocks = max(1, min((nvec + THREADS - 1) / THREADS, (132 * 16 + b - 1) / b));
  gn_apply<T, VEC><<<dim3(blocks, b), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ss), static_cast<T*>(out), rows, c);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, rows, c) contiguous in T; gamma, beta: (c,) float; film: null
// or (b, 2, c) float ([:, 0] scale, [:, 1] shift). Scratch (float): part
// (b, nchunk, 2, c), ss (b, 2, c). vectorised != 0 needs c % 4 == 0 (float)
// or c % 8 == 0 (bfloat16) and x, out 16-byte aligned. Requires
// c % groups == 0, c <= 4096, rows * c < 2^31 and
// nchunk * rows_per_chunk >= rows.
extern "C" int srgd_groupnorm_silu_f32(const void* x, const void* gamma, const void* beta,
                                       const void* film, void* part, void* ss, void* out, int b,
                                       int rows, int c, int groups, int rows_per_chunk, int nchunk,
                                       int vectorised, float eps, void* stream) {
  return vectorised ? launch<float, 4>(x, gamma, beta, film, part, ss, out, b, rows, c, groups,
                                       rows_per_chunk, nchunk, eps, stream)
                    : launch<float, 1>(x, gamma, beta, film, part, ss, out, b, rows, c, groups,
                                       rows_per_chunk, nchunk, eps, stream);
}

extern "C" int srgd_groupnorm_silu_bf16(const void* x, const void* gamma, const void* beta,
                                        const void* film, void* part, void* ss, void* out, int b,
                                        int rows, int c, int groups, int rows_per_chunk, int nchunk,
                                        int vectorised, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  return vectorised ? launch<bf16, 8>(x, gamma, beta, film, part, ss, out, b, rows, c, groups,
                                      rows_per_chunk, nchunk, eps, stream)
                    : launch<bf16, 1>(x, gamma, beta, film, part, ss, out, b, rows, c, groups,
                                      rows_per_chunk, nchunk, eps, stream);
}
