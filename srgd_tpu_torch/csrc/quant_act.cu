// The activation quantize in front of every W8A8 convolution, for Hopper:
// the amax and the int8 codes.
//
// Replaces srgd_tpu/nn/quant.py:133 and :153, the activation amax of
// QuantConv (jnp.max(jnp.abs(xf)) over the whole tensor, or over the pixels
// per channel for SmoothQuant's a_c), and :160, its quantize
// (jnp.clip(jnp.round(xf / x_div), -127, 127).astype(int8)). Those are XLA
// ops in the JAX package, not Pallas kernels; in the port they were a chain
// of PyTorch ops (a float32 copy, abs, amax, divide, round, clamp, cast and a
// channels_last copy of the codes).
//
// Both read the activation once, in its channels_last memory (an NHWC
// array of bfloat16 or float32, C fastest), 16 bytes a thread at a time
// where C % 8 == 0: they are bound by bytes (2 bytes read a bf16 value for
// the amax; 2 read and 1 written for the quantize), and do a few operations
// a byte.
//
// srgd_act_amax: a grid reduction. Each block keeps the max of |x| of its
// rows (per channel, in shared memory, or per thread then per block), as the
// bits of the non-negative float (which order as unsigned integers, NaN
// above inf, so a NaN propagates as in torch.amax); a second kernel, one
// block per output value, combines the blocks' partials. A max does not
// depend on its order: the result is exact.
//
// srgd_quantize_act: q = int8(clamp(rint(fdiv(float(x), div[c])), -127,
// 127)), the divisor a scalar or one per channel, in the JAX order: an IEEE
// division rounded to nearest (__fdiv_rn), round half to even (rintf), then
// the clip. The codes are written as contiguous NHWC int8, the layout
// int8_conv reads.
//
// Not fused into int8_conv's prologue: there A reaches shared memory by TMA
// as int8, once per (tap, output tile), so a fused quantize would read the
// bf16 activation (twice the bytes) and divide every value again for each
// of the 9 taps and each 256-channel output tile, and would need wgmma's A
// from registers instead of TMA's swizzled tiles. A dynamic scale needs the
// amax before any tile starts in either design. One pass that writes 1 byte
// a value costs less than that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;   // vectors (or rows) a thread loads before it uses them

__device__ __forceinline__ float bf16_bits_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_bits_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// VW consecutive elements at p as float: VW = 8 reads 16 bytes of bf16 or
// 32 of float32 (p 16-byte aligned), VW = 1 one element.
template <int VW>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[VW]) {
  if constexpr (VW == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_bits_lo(w[i]);
      f[2 * i + 1] = bf16_bits_hi(w[i]);
    }
  } else {
    f[0] = __bfloat162float(*p);
  }
}
template <int VW> __device__ __forceinline__ void load(const float* p, float (&f)[VW]) {
  if constexpr (VW == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
    f[0] = *p;
  }
}

__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(fabsf(v)); }

// Block partials of max|x|: per channel (partials[block][c]) or of the
// whole tensor (partials[block]). x is rows x C, C % VW == 0.
template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
    act_amax_partial(const T* __restrict__ x, long long rows, int C, int per_channel,
                     uint32_t* __restrict__ partials) {
  const int tid = threadIdx.x;
  if (per_channel) {
    extern __shared__ uint32_t smax[];   // C
    for (int c = tid; c < C; c += THREADS) smax[c] = 0;
    __syncthreads();
    // thread (r, j): column group j (VW channels) of rows r, r + rps, ...
    const int groups = C / VW;
    const int lanes = groups < THREADS ? groups : THREADS, rps = THREADS / lanes;
    const int r = tid / lanes, jl = tid - r * lanes;
    if (r < rps) {
      const long long step = (long long)gridDim.x * rps;
      for (int j = jl; j < groups; j += lanes) {
        uint32_t m[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) m[e] = 0;
        for (long long row0 = (long long)blockIdx.x * rps + r; row0 < rows; row0 += U * step) {
          float f[U][VW];   // U rows' loads in flight before any is used
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (row0 + u * step < rows)
              load<VW>(x + (row0 + u * step) * C + (long long)j * VW, f[u]);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (row0 + u * step < rows)
#pragma unroll
              for (int e = 0; e < VW; ++e) m[e] = max(m[e], abs_bits(f[u][e]));
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) atomicMax(&smax[j * VW + e], m[e]);
      }
    }
    __syncthreads();
    for (int c = tid; c < C; c += THREADS) partials[(long long)blockIdx.x * C + c] = smax[c];
  } else {
    __shared__ uint32_t warps[THREADS / 32];
    const long long nvec = rows * C / VW, stride = (long long)gridDim.x * THREADS;
    uint32_t m = 0;
    for (long long v0 = (long long)blockIdx.x * THREADS + tid; v0 < nvec; v0 += U * stride) {
      float f[U][VW];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + u * stride < nvec) load<VW>(x + (v0 + u * stride) * VW, f[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + u * stride < nvec)
#pragma unroll
          for (int e = 0; e < VW; ++e) m = max(m, abs_bits(f[u][e]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tid & 31) == 0) warps[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < THREADS / 32; ++w) m = max(m, warps[w]);
      partials[blockIdx.x] = m;
    }
  }
}

// out[c] = the max of partials[0 .. nparts - 1][c]: block c, its threads
// strided over the partials, then a warp and a block max.
__global__ void __launch_bounds__(THREADS)
    act_amax_final(const uint32_t* __restrict__ partials, int nparts, int width,
                   float* __restrict__ out) {
  __shared__ uint32_t warps[THREADS / 32];
  const int c = blockIdx.x, tid = threadIdx.x;
  uint32_t m = 0;
  for (int p = tid; p < nparts; p += THREADS) m = max(m, partials[(long long)p * width + c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) warps[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, warps[w]);
    out[c] = __uint_as_float(m);
  }
}

__device__ __forceinline__ int8_t code(float v, float d) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, d)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// q[i] = code(x[i], div[i % C] or div[0]) over nvec vectors of VW elements.
template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
    quantize_act_kernel(const T* __restrict__ x, const float* __restrict__ div, int per_channel,
                        int8_t* __restrict__ q, long long nvec, int C) {
  const long long stride = (long long)gridDim.x * THREADS;
  const int groups = C / VW;                      // vectors per pixel
  const int step = static_cast<int>(stride % groups);
  long long v0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  int j = static_cast<int>(v0 % groups);          // the first vector's column group
  const float d0 = div[0];
  for (; v0 < nvec; v0 += U * stride) {
    float f[U][VW];   // U vectors' loads in flight before any is used
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v0 + u * stride < nvec) load<VW>(x + (v0 + u * stride) * VW, f[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long v = v0 + u * stride;
      if (v < nvec) {
        int8_t out[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) out[e] = code(f[u][e], per_channel ? div[j * VW + e] : d0);
        if constexpr (VW == 8) {
          uint2 packed;
          packed.x = (uint32_t)(uint8_t)out[0] | (uint32_t)(uint8_t)out[1] << 8 |
                     (uint32_t)(uint8_t)out[2] << 16 | (uint32_t)(uint8_t)out[3] << 24;
          packed.y = (uint32_t)(uint8_t)out[4] | (uint32_t)(uint8_t)out[5] << 8 |
                     (uint32_t)(uint8_t)out[6] << 16 | (uint32_t)(uint8_t)out[7] << 24;
          *reinterpret_cast<uint2*>(q + v * VW) = packed;
        } else {
          q[v] = out[0];
        }
      }
      j += step;
      if (j >= groups) j -= groups;
    }
  }
}

int grid_for(long long work, int cap) {
  const long long g = (work + THREADS - 1) / THREADS;
  return static_cast<int>(g < 1 ? 1 : (g < cap ? g : cap));
}

template <typename T, int VW>
int amax(const void* x, void* partials, void* out, int rows, int C, int per_channel, int nparts,
         cudaStream_t s) {
  const size_t smem = per_channel ? (size_t)C * 4 : 0;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  act_amax_partial<T, VW><<<nparts, THREADS, smem, s>>>(
      static_cast<const T*>(x), rows, C, per_channel, static_cast<uint32_t*>(partials));
  const int width = per_channel ? C : 1;
  act_amax_final<<<width, THREADS, 0, s>>>(static_cast<const uint32_t*>(partials), nparts,
                                           width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VW>
int quantize(const void* x, const void* div, void* q, int rows, int C, int per_channel,
             int blocks, cudaStream_t s) {
  const long long nvec = (long long)rows * C / VW;
  quantize_act_kernel<T, VW><<<grid_for(nvec, blocks), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(div), per_channel,
      static_cast<int8_t*>(q), nvec, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: rows x C (an NHWC activation, C fastest), bfloat16 (is_bf16 1) or
// float32; vec: C % 8 == 0 and x 16-byte aligned. partials: nparts x C
// (per_channel) or nparts uint32 of scratch; out: C or 1 float32.
extern "C" int srgd_act_amax(const void* x, void* partials, void* out, int rows, int C,
                             int per_channel, int is_bf16, int vec, int nparts, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? amax<__nv_bfloat16, 8>(x, partials, out, rows, C, per_channel, nparts, s)
               : amax<__nv_bfloat16, 1>(x, partials, out, rows, C, per_channel, nparts, s);
  return vec ? amax<float, 8>(x, partials, out, rows, C, per_channel, nparts, s)
             : amax<float, 1>(x, partials, out, rows, C, per_channel, nparts, s);
}

// q: rows x C int8; div: C (per_channel) or 1 float32; vec as above, with q
// 8-byte aligned; at most `blocks` blocks, each looping over its vectors.
extern "C" int srgd_quantize_act(const void* x, const void* div, void* q, int rows, int C,
                                 int per_channel, int is_bf16, int vec, int blocks,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? quantize<__nv_bfloat16, 8>(x, div, q, rows, C, per_channel, blocks, s)
               : quantize<__nv_bfloat16, 1>(x, div, q, rows, C, per_channel, blocks, s);
  return vec ? quantize<float, 8>(x, div, q, rows, C, per_channel, blocks, s)
             : quantize<float, 1>(x, div, q, rows, C, per_channel, blocks, s);
}
