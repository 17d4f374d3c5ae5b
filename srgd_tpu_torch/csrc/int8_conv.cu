// W8A8 convolution for Hopper (sm_90a): s8 x s8 -> s32 on the tensor cores,
// as an implicit GEMM, with the dequantize epilogue fused.
//
// Replaces srgd_tpu/nn/quant.py:165-173, QuantConv's
// lax.conv_general_dilated(xq, wq, preferred_element_type=int32) and its
// epilogue y = acc * (s_x * s_w) + bias. That is an XLA op in the JAX
// package, not a Pallas kernel; PyTorch has no s8 x s8 -> s32 convolution on
// CUDA, so it is written here by hand.
//
//   out[m][o] = round_T(fadd(fmul(float(acc[m][o]), scale[o]), bias[o]))
//   acc[m][o] = sum_{ky, kx, c} xq[b][y + ky - pad][x + kx - pad][c] * wq[o][ky][kx][c]
//
// with m = (b, y, x) an output pixel, stride 1 and "same" padding
// (pad = (ks - 1) / 2); taps outside the image read as zero. The products
// and sums are exact integers (|acc| <= 127^2 * 9 * 1536 < 2^31 at the
// widest conv of the net), the epilogue is two IEEE float operations
// rounded to nearest, written with __fmul_rn and __fadd_rn so that nvcc does
// not contract them into an FMA, and the cast to bf16 rounds to nearest
// even: the result equals PyTorch's acc.float() * scale + bias, cast, bit for
// bit. out_kind 2 writes the raw int32 accumulators instead.
//
// As a GEMM: M = B*H*W output pixels, N = Cout, K = ks*ks*Cin, A[m][k] the
// im2col row of pixel m (k = (ky*ks + kx)*Cin + c, the order of wq's
// (Cout, ks, ks, Cin) layout) and B[k][o] = wq[o][k]. A is never
// materialised: each block gathers its 128 x 64-byte slices of A straight
// from the NHWC activation.
//
// Bound on this card: operations at the 3x3 convs of the net's path
// (2*M*N*K at the 1,979 TOP/s int8 peak against reading A's source and wq
// and writing the output once), bytes at the 1x1 convs with a 128-channel
// input. What this first version does about it: tiles of 128 pixels x 128
// output channels x 64 bytes of K, double-buffered through 16-byte cp.async
// copies (zero-filled at the halo and past every tail), eight warps each
// holding a 64 x 32 int32 accumulator in registers and issuing
// mma.sync.m16n8k32 s8 products, whose A and B fragments are 32-bit loads
// from rows padded to 80 bytes (free of bank conflicts). wgmma, TMA and a
// fused activation-quantize prologue are later work.
//
// Ragged widths (Cin not a multiple of 16, or unaligned bases) take the same
// tiles through a byte-wise gather instead of cp.async: the tests' tiny
// widths and every masked tail run the one kernel.
#include <cstdint>

#include "mma.cuh"

namespace {

using srgd::bf16;

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 128;        // output channels per block
constexpr int BK = 64;         // bytes (int8 values) of K per stage
constexpr int SROW = BK + 16;  // shared row stride: 80 bytes, conflict-free fragment loads
constexpr int NTHREADS = 256;  // 8 warps: 2 along M (64 rows) x 4 along N (32 columns)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename OutT> __device__ __forceinline__ OutT finish(int acc, float scale, float bias,
                                                                bool has_bias);
template <> __device__ __forceinline__ float finish<float>(int acc, float scale, float bias,
                                                           bool has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}
template <> __device__ __forceinline__ bf16 finish<bf16>(int acc, float scale, float bias,
                                                         bool has_bias) {
  return __float2bfloat16_rn(finish<float>(acc, scale, bias, has_bias));
}
template <> __device__ __forceinline__ int finish<int>(int acc, float, float, bool) { return acc; }

// One block: output pixels m0 .. m0 + 127 x channels n0 .. n0 + 127.
// VEC: Cin % 16 == 0 and 16-byte aligned bases, so every 16-byte piece of an
// A or B row lies inside one tap and one weight row and moves by cp.async.
template <bool VEC, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     OutT* __restrict__ out, int B, int H, int W, int Cin, int Cout, int ks,
                     int pad) {
  __shared__ __align__(16) int8_t As[2][BM * SROW];
  __shared__ __align__(16) int8_t Bs[2][BN * SROW];

  const int M = B * H * W, K = ks * ks * Cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  // Each thread copies two 16-byte pieces of A and two of B per stage:
  // piece idx = tid + i * 256 is row idx / 4, bytes 16 * (idx % 4) of the
  // 64-byte stage. Its two A rows (output pixels) are decoded once.
  int pb[2], py[2], px[2];
  bool pok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ((tid + i * NTHREADS) >> 2);
    pok[i] = m < M;
    const int mm = pok[i] ? m : 0;
    pb[i] = mm / (H * W);
    const int rem = mm - pb[i] * H * W;
    py[i] = rem / W;
    px[i] = rem - py[i] * W;
  }

  // The activation byte at k of pixel (b, y, x): its address, or nullptr in
  // the halo or past K.
  auto a_src = [&](int i, int k) -> const int8_t* {
    if (!pok[i] || k >= K) return nullptr;
    const int tap = k / Cin, c = k - tap * Cin;
    const int ky = tap / ks, kx = tap - ky * ks;
    const int iy = py[i] + ky - pad, ix = px[i] + kx - pad;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return nullptr;
    return x + (((size_t)pb[i] * H + iy) * W + ix) * Cin + c;
  };

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * NTHREADS, r = idx >> 2, c16 = (idx & 3) * 16;
      int8_t* adst = &As[stage][r * SROW + c16];
      int8_t* bdst = &Bs[stage][r * SROW + c16];
      const int kc = k0 + c16, n = n0 + r;
      if constexpr (VEC) {
        const int8_t* asrc = a_src(i, kc);
        srgd::cp_async16(adst, asrc ? asrc : x, asrc != nullptr);
        const bool bok = n < Cout && kc < K;
        srgd::cp_async16(bdst, bok ? w + (size_t)n * K + kc : w, bok);
      } else {
#pragma unroll 4
        for (int e = 0; e < 16; ++e) {
          const int8_t* asrc = a_src(i, kc + e);
          adst[e] = asrc ? *asrc : int8_t(0);
          bdst[e] = (n < Cout && kc + e < K) ? w[(size_t)n * K + kc + e] : int8_t(0);
        }
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // m16n8k32 fragments (g = lane / 4, t = lane % 4), 4 bytes each:
  //   A: a0 = (row g, k 4t..4t+3), a1 = (row g+8, same k), a2, a3 = the same at k + 16
  //   B: b0 = (k 4t..4t+3, column g), b1 = the same at k + 16; B's tile is stored
  //      [n][k], so these are 4 contiguous bytes of one weight row
  //   C: c0, c1 = (row g, columns 2t, 2t+1), c2, c3 = (row g+8, the same columns)
  auto compute = [&](int stage) {
    const int8_t* as = As[stage] + (wm * 64) * SROW;
    const int8_t* bs = Bs[stage] + (wn * 32) * SROW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = as + (mi * 16 + g) * SROW + kk + 4 * t;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * SROW);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = bs + (ni * 8 + g) * SROW + kk + 4 * t;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  };

  const int KT = (K + BK - 1) / BK;
  load(0, 0);
  srgd::cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load((kt + 1) & 1, (kt + 1) * BK);
    srgd::cp_async_commit();
    srgd::cp_async_wait<1>();
    __syncthreads();
    compute(kt & 1);
    __syncthreads();
  }

  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + ni * 8 + 2 * t + e;
      if (n >= Cout) continue;
      const float s = scale ? scale[n] : 1.f;
      const float bv = has_bias ? bias[n] : 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
          if (m < M) out[(size_t)m * Cout + n] = finish<OutT>(acc[mi][ni][2 * h + e], s, bv, has_bias);
        }
      }
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out, int B,
           int H, int W, int Cin, int Cout, int ks, int pad, int vec, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<OutT*>(out);
  if (vec)
    int8_conv_kernel<true, OutT>
        <<<grid, NTHREADS, 0, stream>>>(xs, ws, sc, bi, o, B, H, W, Cin, Cout, ks, pad);
  else
    int8_conv_kernel<false, OutT>
        <<<grid, NTHREADS, 0, stream>>>(xs, ws, sc, bi, o, B, H, W, Cin, Cout, ks, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, Cin) int8, w: (Cout, ks, ks, Cin) int8, scale and bias: (Cout)
// float32 or null, out: (B, H, W, Cout); out_kind 0 float32, 1 bfloat16,
// 2 the int32 accumulators (scale and bias ignored). vec: Cin % 16 == 0 and
// x, w 16-byte aligned.
extern "C" int srgd_int8_conv(const void* x, const void* w, const void* scale, const void* bias,
                              void* out, int B, int H, int W, int Cin, int Cout, int ks, int pad,
                              int out_kind, int vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      return launch<float>(x, w, scale, bias, out, B, H, W, Cin, Cout, ks, pad, vec, s);
    case 1:
      return launch<bf16>(x, w, scale, bias, out, B, H, W, Cin, Cout, ks, pad, vec, s);
    case 2:
      return launch<int>(x, w, nullptr, nullptr, out, B, H, W, Cin, Cout, ks, pad, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
