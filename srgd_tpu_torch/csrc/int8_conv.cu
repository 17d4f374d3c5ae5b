// W8A8 convolution for Hopper (sm_90a): s8 x s8 -> s32 on the tensor cores,
// as an implicit GEMM, with the dequantize epilogue fused. Two kernels of one
// function, which the wrapper (kernels/int8_conv.py) picks by shape.
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
// materialised. Bound on this card: operations at the 3x3 convs of the net
// (2*M*N*K at the 1,979 TOP/s int8 peak against reading A's source and wq
// and writing the output once), bytes at its 1x1 convs.
//
// int8_conv_wgmma (Cin % 16 == 0, 16-byte aligned bases, ks 1 or 3: every
// conv of the net). A persistent grid of one 384-thread block per SM walks
// the output tiles of 128 pixels x 256 channels. Warpgroup 0 is the producer:
// it gives up its registers (setmaxnreg) and one thread keeps a ring of four
// 48 KB shared-memory stages filled by TMA, one stage per (tap, 128 channels)
// step of K. Warpgroups 1 and 2 are the consumers, 64 pixels each: per stage
// four wgmma m64n256k32 s8 products with both operands from shared memory,
// the s32 sums in 128 registers a thread, one wgmma group kept in flight
// while the previous stage is handed back; then the epilogue straight from
// the registers, its scales and biases staged in shared memory while the
// products ran, while the producer already loads the next tile's stages.
// The activation side of A uses TMA's tiled mode, not its im2col mode: a
// tile is whole image rows (rows * bw = 128 pixels when W divides 128, or
// 128 pixels of one row when W >= 128), so tap (ky, kx) of the tile is one
// 4-D box {128 channels, bw, rows, 1} of the NHWC activation at (c0, x0 + kx
// - pad, y0 + ky - pad, b). Coordinates past the image, and channels past
// Cin, are outside the tensor and TMA writes them as zero: that is the halo,
// with no gather code. B is a 3-D box {128 channels, 1 tap, 256 outputs} of
// wq. Both land in the 128-byte swizzle that wgmma reads K-major.
//
// int8_conv_kernel (the first version, kept for what the other does not
// take: Cin not a multiple of 16, unaligned bases, other kernel sizes):
// tiles of 128 pixels x 128 output channels x 64 bytes of K, double-buffered
// through 16-byte cp.async copies (zero-filled at the halo and past every
// tail), eight warps each holding a 64 x 32 int32 accumulator in registers
// and issuing mma.sync.m16n8k32 s8 products, whose A and B fragments are
// 32-bit loads from rows padded to 80 bytes (free of bank conflicts). Ragged
// widths take the same tiles through a byte-wise gather instead of cp.async.
#include <cuda.h>

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


// ---------------------------------------------------------------------------
// int8_conv_wgmma: warp-specialised, persistent, TMA ring, wgmma s8
// ---------------------------------------------------------------------------

namespace hop {

constexpr int BM = 128;                      // output pixels per tile (two consumers x 64)
constexpr int BN = 256;                      // output channels per tile (the wgmma N)
constexpr int BK = 128;                      // bytes of K per stage: one swizzle row
constexpr int STAGES = 4;                    // the ring
constexpr int A_BYTES = BM * BK;             // 16 KB
constexpr int B_BYTES = BN * BK;             // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_BYTES = 2 * BN * 8;          // (scale, bias) of a tile's columns, x2
constexpr int SMEM = STAGES * STAGE_BYTES + EPI_BYTES + 2 * STAGES * 8 + 1024;  // + barriers
constexpr int THREADS = 384;                 // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;

// The tile walk, from the host. A tile is image b, rows y0 .. y0 + rows - 1,
// columns x0 .. x0 + bw - 1 (rows * bw <= 128 pixels) and output channels
// n0 .. n0 + 255; tiles are numbered pixel tile fastest, so the blocks in
// flight share one slice of wq.
struct Geo {
  int H, W, Cout, ks, pad, bw, rows, tiles_x, tiles_y, tiles_m, tiles, cblocks;
};

__device__ __forceinline__ void decode(const Geo& g, int tile, int& b, int& y0, int& x0,
                                       int& n0) {
  const int nt = tile / g.tiles_m, mt = tile - nt * g.tiles_m;
  const int per_image = g.tiles_y * g.tiles_x;
  b = mt / per_image;
  const int r = mt - b * per_image, ty = r / g.tiles_x;
  y0 = ty * g.rows;
  x0 = (r - ty * g.tiles_x) * g.bw;
  n0 = nt * BN;
}

template <typename OutT> __device__ __forceinline__ void store2(OutT* p, OutT a, OutT b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<bf16>(bf16* p, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}
template <> __device__ __forceinline__ void store2<int>(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_wgmma(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
                    const float* __restrict__ bias, OutT* __restrict__ out, const Geo g) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled stages need 1024-byte aligned shared addresses
  uint8_t* smem = smem_raw + ((1024 - (srgd::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* As = smem;
  uint8_t* Bs = smem + STAGES * A_BYTES;
  float2* epi = reinterpret_cast<float2*>(smem + STAGES * STAGE_BYTES);   // [2][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES + EPI_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int taps = g.ks * g.ks, KT = taps * g.cblocks;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      srgd::mbar_init(&full[s], 1);                 // the producer's arrive + TMA bytes
      srgd::mbar_init(&empty[s], CONSUMER_WARPS);   // one arrive per consumer warp
    }
    srgd::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer ---------------------------------------------------------
    srgd::setmaxnreg_dec<40>();
    if (tid == 0) {
      const uint32_t bytes = BK * g.bw * g.rows + B_BYTES;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
        int b, y0, x0, n0;
        decode(g, tile, b, y0, x0, n0);
        for (int tap = 0; tap < taps; ++tap) {
          const int ky = tap / g.ks, kx = tap - ky * g.ks;
          for (int cb = 0; cb < g.cblocks; ++cb) {
            srgd::mbar_wait(&empty[stage], phase ^ 1);
            srgd::mbar_arrive_expect_tx(&full[stage], bytes);
            srgd::tma_load_4d(As + stage * A_BYTES, &xmap, &full[stage], cb * BK,
                              x0 + kx - g.pad, y0 + ky - g.pad, b);
            srgd::tma_load_3d(Bs + stage * B_BYTES, &wmap, &full[stage], cb * BK, tap, n0);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // -- consumers: warpgroup cw computes tile rows 64 cw .. 64 cw + 63 ----
    srgd::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int lane = tid & 31, wl = (tid >> 5) & 3, gq = lane >> 2, t = lane & 3;
    const bool has_bias = bias != nullptr;
    const bool pairs = (g.Cout & 1) == 0;
    int stage = 0;
    uint32_t phase = 0;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    for (int tile = blockIdx.x, it = 0; tile < g.tiles; tile += gridDim.x, ++it) {
      int b, y0, x0, n0;
      decode(g, tile, b, y0, x0, n0);
      // the tile's (scale, bias), one column a consumer thread, read while
      // the products run; two buffers, so the other warpgroup may still read
      // the last tile's
      float2* sb = epi + (it & 1) * BN;
      {
        const int n = n0 + tid - 128;
        float2 v = make_float2(1.f, 0.f);
        if (n < g.Cout) {
          if (scale) v.x = scale[n];
          if (has_bias) v.y = bias[n];
        }
        sb[tid - 128] = v;
      }
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        srgd::mbar_wait(&full[stage], phase);
        srgd::wgmma_fence();
        const uint64_t da = srgd::desc_sw128(As + stage * A_BYTES + cw * 64 * BK);
        const uint64_t db = srgd::desc_sw128(Bs + stage * B_BYTES);
#pragma unroll
        for (int k = 0; k < BK / 32; ++k)   // k32 steps: 32 bytes = 2 in the address field
          srgd::wgmma_s8_n256(acc, da + 2 * k, db + 2 * k, kt > 0 || k > 0);
        srgd::wgmma_commit();
        if (kt > 0) {   // the previous stage's products are done: hand it back
          srgd::wgmma_wait_n<1>();
          if (lane == 0) srgd::mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      srgd::wgmma_wait_n<0>();
      if (lane == 0) srgd::mbar_arrive(&empty[prev]);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");   // both consumers: sb written

      // epilogue: this thread's rows r0, r0 + 8 and columns 8 nb + 2t, + 1
      long long mrow[2];
      bool rok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * 64 + wl * 16 + gq + 8 * h;
        const int yy = y0 + r / g.bw, xx = x0 + r % g.bw;
        rok[h] = r < g.bw * g.rows && yy < g.H && xx < g.W;
        mrow[h] = ((long long)b * g.H + yy) * g.W + xx;
      }
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int n = n0 + nb * 8 + 2 * t;
        if (n >= g.Cout) continue;
        const bool two = n + 1 < g.Cout;
        const float2 c0 = sb[nb * 8 + 2 * t], c1 = sb[nb * 8 + 2 * t + 1];
        const float s0 = c0.x, s1 = c1.x, b0 = c0.y, b1 = c1.y;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!rok[h]) continue;
          OutT* o = out + mrow[h] * g.Cout + n;
          const OutT v0 = finish<OutT>(acc[nb * 4 + 2 * h], s0, b0, has_bias);
          if (two) {
            const OutT v1 = finish<OutT>(acc[nb * 4 + 2 * h + 1], s1, b1, has_bias);
            if (pairs) {
              store2<OutT>(o, v0, v1);
            } else {
              o[0] = v0;
              o[1] = v1;
            }
          } else {
            o[0] = v0;
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point: the
// library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of int8 bytes: dims innermost first, strides in bytes of
// dims 1 .. rank - 1, box in elements, 128-byte swizzle, zero fill outside.
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
int launch(const void* x, const void* w, const float* scale, const float* bias, OutT* out, int B,
           int H, int W, int Cin, int Cout, int ks, int pad, cudaStream_t stream) {
  Geo g;
  g.H = H;
  g.W = W;
  g.Cout = Cout;
  g.ks = ks;
  g.pad = pad;
  g.bw = W >= BM ? BM : W;
  g.rows = W >= BM ? 1 : (BM / W < H ? BM / W : H);
  g.tiles_x = (W + g.bw - 1) / g.bw;
  g.tiles_y = (H + g.rows - 1) / g.rows;
  g.tiles_m = B * g.tiles_y * g.tiles_x;
  const long long tiles = (long long)g.tiles_m * ((Cout + BN - 1) / BN);
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  g.cblocks = (Cin + BK - 1) / BK;

  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)Cin, (cuuint64_t)W * Cin, (cuuint64_t)H * W * Cin};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)g.bw, (cuuint32_t)g.rows, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)Cin, (cuuint64_t)ks * ks, (cuuint64_t)Cout};
  const cuuint64_t wstrides[2] = {(cuuint64_t)Cin, (cuuint64_t)ks * ks * Cin};
  const cuuint32_t wbox[3] = {BK, 1, BN};
  if (!encode(&xmap, x, 4, xdims, xstrides, xbox) || !encode(&wmap, w, 3, wdims, wstrides, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(int8_conv_wgmma<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = g.tiles < srgd::sm_count() ? g.tiles : srgd::sm_count();
  int8_conv_wgmma<OutT><<<grid, THREADS, SMEM, stream>>>(xmap, wmap, scale, bias, out, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop

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

// The Hopper kernel: the same operands and out_kind. Takes Cin % 16 == 0
// (TMA strides are multiples of 16 bytes), x and w 16-byte aligned and ks 1
// or 3; anything else returns cudaErrorInvalidValue without a launch.
extern "C" int srgd_int8_conv_wgmma(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int B, int H, int W, int Cin,
                                    int Cout, int ks, int pad, int out_kind, void* stream) {
  if (Cin % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || (ks != 1 && ks != 3) || pad != ks / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  switch (out_kind) {
    case 0:
      return hop::launch<float>(x, w, sc, bi, static_cast<float*>(out), B, H, W, Cin, Cout, ks,
                                pad, s);
    case 1:
      return hop::launch<bf16>(x, w, sc, bi, static_cast<bf16*>(out), B, H, W, Cin, Cout, ks,
                               pad, s);
    case 2:
      return hop::launch<int>(x, w, nullptr, nullptr, static_cast<int*>(out), B, H, W, Cin, Cout,
                              ks, pad, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
