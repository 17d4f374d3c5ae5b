// Fused whole-block linear attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srgd_tpu/kernels/linattn_block.py
// (fused_linattn_block, body _kernel): RMSNorm -> q/k/v 1x1 projections ->
// k-softmax over the sequence -> head-masked context -> per-head q-softmax
// -> q . context -> to_out 1x1 + bias -> output RMSNorm, with x read and the
// output written once per phase and nothing in between touching device
// memory except the small per-split partials.
//
// The TPU kernel carries m, z and ctx across a sequential grid in VMEM.
// Blocks here run in parallel and in no order, so phase A is split over the
// sequence: each block streams its rows with the same online-max update and
// writes partials (m, z of hidden; the head-diagonal 32x32 blocks of ctx,
// the only ones the mask keeps). A merge kernel rescales the partials by
// exp(m_i - m), normalises once and rounds the context to T (common.cuh's,
// shared with linear_attention.cu). Phase B owns whole rows, because the
// output RMSNorm reduces over all c <= 512 columns.
//
// Rounding points follow _xla_linattn_block: y, v, the normalised q and
// context, and q . context are rounded to T before their products. The one
// point that cannot match is exp(k - m), which is rounded before its
// division by z because z is only known after the merge.
//
// Bound on this card: bytes (x read twice, the output written once), once
// the products run on the tensor cores; 77 GFLOP at (8, 65536, 128).
//
// bfloat16 (phase_a_mma, phase_b_mma): the projections and the context
// product are wgmma m64n64k16 (mma.cuh), one 64-row tile to a step, two
// warpgroups to a block; only q . context, 32 x 32 a head, is mma.sync. What
// the design does about the old version's limits:
//  - Weights are resident: for c <= 256 a block copies wk | wv (phase A) or
//    wq and wout (phase B) into shared memory once with cp.async, in the
//    chunked MN-major layout that a wgmma descriptor reads, and then walks
//    many row tiles (phase A over its split, phase B as a persistent block
//    striding over the batch's tiles). At c = 512 they do not fit beside the
//    tiles and stream through a two-stage cp.async ring (ring_step) whose
//    chunks form one endless sequence, so a load is always in flight.
//  - x comes in as 16-byte loads, one warp to eight rows, and the loads of
//    the next tile are started into registers before this tile's products, so
//    they are in flight under them; the rows are normalised in float and
//    written to shared memory as bf16 in the K-major chunked layout.
//  - Phase A computes k and v transposed: M = 64 columns of wk or wv (two
//    heads, one warpgroup), N = the tile's 64 rows. A k column's 64 rows
//    then lie in the 16 accumulator values of each thread of one quad: its
//    max and sum are register operations and two shuffles, and exp(k - m)
//    rounded to bf16 is, without leaving the registers, the A operand of
//    ctx += ek^T v, whose B operand is v^T from shared memory. The product
//    covers both heads of the warpgroup (64 x 64) and the two off-diagonal
//    32 x 32 blocks are discarded: half of a small product, for one
//    instruction shape.
//  - Phase B: a warp owns 16 rows and two heads of q (the accumulator layout
//    of its warpgroup's wgmma). The per-head softmax is taken on the
//    accumulator (a head's 32 columns lie in one quad), qn rounded to bf16 is
//    the A operand of qn x ctx straight from registers, and the result goes
//    through shared memory once so that to_out can split its N = c columns
//    over the two warpgroups: 64 rows x 256 float accumulators a warpgroup at
//    c = 512 fit in registers. The rows' sums of squares for the output
//    RMSNorm are added through shared memory (chosen over a float copy of the
//    row in shared memory, 128 KB at c = 512, which would leave no room for
//    the weights), and the bf16 tile is staged in shared memory so that it
//    leaves in 16-byte stores.
//  - A tile's steps (load, normalise, products, softmax, store) depend on each
//    other through barriers, so one block of 8 warps leaves the SM waiting
//    much of the time. For c <= 128, where most rows are, two blocks share an
//    SM (blocks_per_sm): the registers are held to 128 a thread.
// What bounds it now: at c <= 256 the steps around the products (loading and
// normalising x, the softmaxes, the stores), not the products; at c = 512
// the weights, 256 KB streamed from the L2 for every 64 KB tile of x.
//
// float32 (phase_a, phase_b): the exact path, float FMAs on the CUDA cores
// with 32-row float tiles and weights staged 16 rows at a time.
#include "common.cuh"
#include "mma.cuh"

using namespace srgd;

namespace {

constexpr float SCALE = 0.17677669529663687f;  // dim_head ** -0.5

// Shared floats of phase A: y tile, staged weights, k | v tile, m, z, alpha.
__host__ __device__ constexpr int phase_a_floats(int c) {
  return TM * c + KC * 32 * 4 + TM * 2 * MAXH + 3 * MAXH;
}

// Shared floats of phase B: y tile, staged weights, q tile, context.
__host__ __device__ constexpr int phase_b_floats(int c) {
  return TM * c + KC * 32 * 16 + TM * MAXH + MAXH * DH;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
phase_a(const T* __restrict__ x, const float* __restrict__ g1s, const T* __restrict__ wk,
        const T* __restrict__ wv, float* __restrict__ part_m, float* __restrict__ part_z,
        float* __restrict__ part_ctx, int n, int c, int hidden, int rows_per_split, int nsplit) {
  extern __shared__ float smem[];
  float* ys = smem;                    // TM x c
  float* ws = ys + TM * c;             // KC x 128
  float* kv = ws + KC * 32 * 4;        // TM x 2*MAXH: k (float) | v (rounded to T)
  float* m_run = kv + TM * 2 * MAXH;   // hidden
  float* z_run = m_run + MAXH;         // hidden
  float* alpha = z_run + MAXH;         // hidden

  const int split = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, n);
  const T* xb = x + (size_t)bi * n * c;

  float acc[16];
  kv_stream_init(m_run, z_run, acc);

  for (int r0 = row_begin; r0 < row_end; r0 += TM) {
    const int nvalid = min(TM, row_end - r0);
    __syncthreads();  // the previous tile is done with ys and kv
    load_norm_rows<T>(xb + (size_t)r0 * c, g1s, ys, nvalid, c);

    float pk[4][4], pv[4][4];
    zero(pk);
    zero(pv);
    rows_matmul<T, 4>(pk, ys, c, c, wk, hidden, 0, ws);
    rows_matmul<T, 4>(pv, ys, c, c, wv, hidden, 0, ws);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = lane + 32 * j;
        kv[r * LDKV + col] = r < nvalid ? pk[i][j] : NEG;  // masked rows never win the max
        kv[r * LDKV + MAXH + col] = round_to<T>(pv[i][j]);
      }
    }
    kv_stream_tile<T>(kv, m_run, z_run, alpha, acc, hidden);
  }
  kv_stream_store(m_run, z_run, acc, part_m, part_z, part_ctx, (size_t)bi * nsplit + split, hidden);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
phase_b(const T* __restrict__ x, const float* __restrict__ g1s, const T* __restrict__ wq,
        const T* __restrict__ wout, const float* __restrict__ bout, const float* __restrict__ g2s,
        const float* __restrict__ ctxn, T* __restrict__ out, int n, int c, int hidden) {
  extern __shared__ float smem[];
  float* ys = smem;                 // TM x c
  float* ws = ys + TM * c;          // KC x 512
  float* qs = ws + KC * 32 * 16;    // TM x MAXH
  float* cs = qs + TM * MAXH;       // hidden x 32: this batch's context blocks

  const int bi = blockIdx.y, r0 = blockIdx.x * TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nh = hidden / DH;
  const int nvalid = min(TM, n - r0);

  for (int j = tid; j < hidden * DH; j += THREADS) cs[j] = ctxn[(size_t)bi * hidden * DH + j];
  load_norm_rows<T>(x + ((size_t)bi * n + r0) * c, g1s, ys, nvalid, c);

  // q = y @ wq; thread (warp, lane) holds rows warp*4+i, column lane of head j
  float pq[4][4];
  zero(pq);
  rows_matmul<T, 4>(pq, ys, c, c, wq, hidden, 0, ws);
  // per-head softmax over the head's 32 columns, / denom * scale, rounded
  head_softmax_rows<T>(pq, qs, nh, SCALE);
  __syncthreads();

  // attn[r][j*32 + e] = sum_d qn[r][j*32 + d] * ctxn[j*32 + d][e]
  float pa[4][4];
  rows_times_context(pa, qs, cs, nh);
  __syncthreads();  // all reads of qs are done
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) qs[(warp * 4 + i) * MAXH + j * DH + lane] = round_to<T>(pa[i][j]);

  // o = attn @ wout + bout, then the output RMSNorm over the row's c columns
  float po[4][16];
  zero(po);
  rows_matmul<T, 16>(po, qs, MAXH, hidden, wout, c, 0, ws);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = lane + 32 * j;
      if (col < c) {
        po[i][j] += bout[col];
        ss += po[i][j] * po[i][j];
      }
    }
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
    if (r < nvalid) {
      T* orow = out + ((size_t)bi * n + r0 + r) * c;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = lane + 32 * j;
        if (col < c) orow[col] = from_f32<T>(po[i][j] / nrm * g2s[col]);
      }
    }
  }
}

// ---- bfloat16: tensor cores ----------------------------------------------

constexpr int TMR = 64;                        // rows per tile: one wgmma M (or N)
constexpr int TS = chunk_stride(TMR);          // chunk stride of a 64-line K-major tile
constexpr int LDC = DH + PAD;                  // row of the context (ldmatrix operand)
constexpr int KCH = 256;                       // k-rows of wk | wv or wq in one streamed chunk
constexpr int KCH_O = 64;                      // k-rows of wout in one streamed chunk

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Blocks of either phase that one SM holds at once: two for c <= 128 (16
// lanes to a row), where the shared memory of two fits and the compiler is
// held to 128 registers, so that one block's products run under the other's
// loads, softmax and barriers; one for wider c.
__host__ __device__ constexpr int blocks_per_sm(int lpr) { return lpr == 16 ? 2 : 1; }

// 8-column chunks of wout that phase B's shared tile holds: the second
// warpgroup's columns start at half = c / 2 rounded up to 16 and it
// multiplies whole blocks of 64.
__host__ __device__ constexpr int out_half(int c) { return (c / 2 + 15) / 16 * 16; }
__host__ __device__ constexpr int out_chunks(int c) {
  return out_half(c) / 8 + (out_half(c) + 63) / 64 * 8;
}

// Shared elements of phase A: y tile, v^T tiles of both warpgroups, weights
// (resident: all of wk | wv; else two chunks of KCH rows of one half).
__host__ __device__ constexpr size_t phase_a_mma_bytes(int c, bool resident) {
  return sizeof(bf16) * ((c / 8) * TS + 2 * 8 * TS +
                         (resident ? 32 * chunk_stride(c) : 2 * 16 * chunk_stride(KCH)));
}

// Shared bytes of phase B: y tile, attention tile, context, the rows' sums of
// squares (two halves), weights (resident: wq and wout; else two chunks of
// the larger ring).
__host__ __device__ constexpr size_t phase_b_mma_bytes(int c, bool resident) {
  return sizeof(bf16) * ((c / 8) * TS + 16 * TS + MAXH * LDC +
                         (resident ? 16 * chunk_stride(c) + out_chunks(c) * chunk_stride(MAXH)
                                   : 2 * cmax(16 * chunk_stride(KCH),
                                              out_chunks(c) * chunk_stride(KCH_O)))) +
         sizeof(float) * 2 * TMR;
}

// Start the 16-byte loads of a 64-row tile of x into registers. Warp w takes
// rows 8w .. 8w + 7, LPR lanes to a row (16 for c <= 128, so that two rows
// keep all 32 lanes busy, else 32), lane l of a row the chunks l + LPR ch.
// Rows at or past nvalid and chunks past c are zero.
template <int CH, int LPR>
__device__ __forceinline__ void rows_load(uint4 (&xr)[LPR / 4][CH], const bf16* __restrict__ x,
                                          int nvalid, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < LPR / 4; ++p)
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int row = warp * 8 + p * (32 / LPR) + lane / LPR;
      const int col = (lane % LPR + LPR * ch) * 8;
      xr[p][ch] = row < nvalid && col < c
                      ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * c + col))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
}

// y[row][:] = bf16(x[row] * (1 / max(||x[row]||, 1e-12)) * g1s) for the rows
// that rows_load loaded, into the K-major tile ys; g holds this lane's
// columns of g1s.
template <int CH, int LPR>
__device__ __forceinline__ void rows_norm_store(const uint4 (&xr)[LPR / 4][CH],
                                                const float (&g)[CH][8], bf16* ys, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < LPR / 4; ++p) {
    float f[CH][8];
    float ss = 0.f;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const uint32_t w[4] = {xr[p][ch].x, xr[p][ch].y, xr[p][ch].z, xr[p][ch].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[ch][2 * i] = bf16_lo(w[i]);
        f[ch][2 * i + 1] = bf16_hi(w[i]);
        ss += f[ch][2 * i] * f[ch][2 * i] + f[ch][2 * i + 1] * f[ch][2 * i + 1];
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = 1.f / fmaxf(sqrtf(ss), 1e-12f);
    const int row = warp * 8 + p * (32 / LPR) + lane / LPR;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int chunk = lane % LPR + LPR * ch;
      if (chunk * 8 < c) {
        uint4 y;
        y.x = pack_bf16(f[ch][0] * inv * g[ch][0], f[ch][1] * inv * g[ch][1]);
        y.y = pack_bf16(f[ch][2] * inv * g[ch][2], f[ch][3] * inv * g[ch][3]);
        y.z = pack_bf16(f[ch][4] * inv * g[ch][4], f[ch][5] * inv * g[ch][5]);
        y.w = pack_bf16(f[ch][6] * inv * g[ch][6], f[ch][7] * inv * g[ch][7]);
        *reinterpret_cast<uint4*>(ys + chunk * TS + row * 8) = y;
      }
    }
  }
}

template <int CH, int LPR>
__device__ __forceinline__ void load_gain(float (&g)[CH][8], const float* __restrict__ g1s, int c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = (lane % LPR + LPR * ch) * 8 + i;
      g[ch][i] = col < c ? g1s[col] : 0.f;
    }
}

// A weight that does not fit in shared memory (c > 256) streams through a
// ring of two stages in chunks: rows k0 .. k0 + klen of the dense global
// matrix w (rows wcols long), 8 nchunks columns from chunk nch0, as an
// MN-major tile with chunk stride chunk_stride(klen).
struct Chunk {
  const bf16* w;
  int wcols, k0, klen, nch0, nchunks;
};

__device__ __forceinline__ void chunk_load(bf16* stage, const Chunk& ch) {
  copy_mn_async<THREADS>(stage, chunk_stride(ch.klen), ch.w, ch.wcols, ch.k0, ch.klen, ch.nch0,
                         ch.nchunks);
  cp_async_commit();
}

// One step of the ring: chunk cur is in flight into stage it % 2 (the last
// committed group); start next into the other stage, wait for cur, let
// mul(tile, chunk stride) start the wgmmas that read it and wait for them.
// The chunks of a kernel form one endless sequence, each step naming its
// successor, so that a load is always in flight under the products, across
// the products of a tile and from tile to tile. Every thread of the block
// must call it; it synchronises, and the accumulators are complete when it
// returns.
template <typename Mul>
__device__ __forceinline__ void ring_step(bf16* wbuf, int stage, int& it, const Chunk& cur,
                                          const Chunk& next, Mul mul) {
  chunk_load(wbuf + ((it + 1) & 1) * stage, next);
  cp_async_wait<1>();
  proxy_fence();
  __syncthreads();
  wgmma_fence();
  mul(wbuf + (it & 1) * stage, chunk_stride(cur.klen));
  wgmma_commit();
  wgmma_wait();
  __syncthreads();
  ++it;
}

// wkv: (c, 256) bf16, wk in columns [0, hidden), wv in [128, 128 + hidden),
// zero elsewhere. Warpgroup w owns heads 2w and 2w + 1: it computes their
// 64 columns of k and of v transposed (M = columns, N = the tile's 64 rows),
// so that a k column's max and sum over the rows lie in one quad, exp(k - m)
// rounded to bf16 is the register A operand of ctx += ek^T v, and v^T goes
// through shared memory as that product's K-major B operand. The product
// covers both heads' 64 x 64; the two off-diagonal 32 x 32 are discarded.
template <int CH, int LPR>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(LPR))
phase_a_mma(const bf16* __restrict__ x, const float* __restrict__ g1s,
            const bf16* __restrict__ wkv, float* __restrict__ part_m, float* __restrict__ part_z,
            float* __restrict__ part_ctx, int n, int c, int hidden, int rows_per_split,
            int nsplit, int resident) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // K-major 64 rows x c
  bf16* vts = ys + (c / 8) * TS;                 // per warpgroup: K-major 64 e x 64 rows
  bf16* ws = vts + 2 * 8 * TS;                   // MN-major c x 256, or the ring
  const int wcs = chunk_stride(c);               // chunk stride of the resident weights

  const int split = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wm = warp & 3;       // warpgroup; 16 columns of its 64
  bf16* vt = vts + wg * 8 * TS;
  const int d0 = wg * 64 + wm * 16 + g;          // this thread's k columns: d0, d0 + 8
  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, n);
  const bf16* xb = x + (size_t)bi * n * c;

  if (resident) {
    copy_mn_async<THREADS>(ws, wcs, wkv, 2 * MAXH, 0, c, 0, 32);
    cp_async_commit();
  }

  float g1[CH][8];
  load_gain<CH, LPR>(g1, g1s, c);
  float m_run[2] = {NEG, NEG}, z_run[2] = {0.f, 0.f};  // z over this thread's rows only
  // ctx rows d0 (j < 2) and d0 + 8, columns e = nb * 8 + 2t + (j & 1) of the
  // warpgroup's 64
  float ctx[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ctx[i][j] = 0.f;

  // acc = (64 columns of wk | wv from column m0)^T y^T over all of c; when
  // streaming, the pass's last chunk names the first of the pass that
  // follows, over the columns from next_m0
  int it = 0;
  const int stage = 16 * chunk_stride(KCH);
  auto half_chunk = [&](int m0, int k0) {
    return Chunk{wkv, 2 * MAXH, k0, min(KCH, c - k0), m0 / 8, 16};
  };
  auto project = [&](float (&acc)[8][4], int m0, int next_m0) {
    if (resident) {
      const int mch = m0 / 8 + wg * 8;
      wgmma_fence();
      for (int k0 = 0; k0 < c; k0 += 16)
        wgmma_ss<1, 0>(acc, desc_mn_major(ws + mch * wcs + k0 * 8, wcs),
                       desc_k_major(ys + (k0 / 8) * TS, TS), k0 > 0);
      wgmma_commit();
      wgmma_wait();
      return;
    }
    for (int k0 = 0; k0 < c; k0 += KCH)
      ring_step(ws, stage, it, half_chunk(m0, k0),
                k0 + KCH < c ? half_chunk(m0, k0 + KCH) : half_chunk(next_m0, 0),
                [&](const bf16* tile, int cs) {
                  for (int kk = 0; kk < min(KCH, c - k0); kk += 16)
                    wgmma_ss<1, 0>(acc, desc_mn_major(tile + wg * 8 * cs + kk * 8, cs),
                                   desc_k_major(ys + ((k0 + kk) / 8) * TS, TS), k0 + kk > 0);
                });
  };
  if (!resident) chunk_load(ws, half_chunk(MAXH, 0));

  uint4 xr[LPR / 4][CH];
  rows_load<CH, LPR>(xr, xb + (size_t)row_begin * c, min(TMR, row_end - row_begin), c);

  for (int r0 = row_begin; r0 < row_end; r0 += TMR) {
    const int nvalid = min(TMR, row_end - r0);
    rows_norm_store<CH, LPR>(xr, g1, ys, c);
    if (r0 + TMR < row_end)
      rows_load<CH, LPR>(xr, xb + (size_t)(r0 + TMR) * c, min(TMR, row_end - r0 - TMR), c);
    if (resident) cp_async_wait<0>();  // the weights, before the first tile
    proxy_fence();
    __syncthreads();

    // v^T, rounded to bf16, into this warpgroup's tile: element (e, row) at
    // chunk row / 8, line e
    float acc[8][4];
    project(acc, MAXH, 0);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint32_t*>(vt + nb * TS + (wm * 16 + g + hf * 8) * 8 + 2 * t) =
            pack_bf16(acc[nb][2 * hf], acc[nb][2 * hf + 1]);

    // k^T and its online column statistics: a column's 64 rows lie in the
    // 16 values of each thread of one quad
    project(acc, 0, MAXH);
    __syncthreads();  // both warpgroups have read y
    float al[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mt = NEG;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          float& val = acc[nb][2 * hf + par];
          if (nb * 8 + 2 * t + par >= nvalid) val = NEG;  // never wins the max
          mt = fmaxf(mt, val);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m_run[hf], mt);
      al[hf] = __expf(m_run[hf] - mn);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          float& val = acc[nb][2 * hf + par];
          val = __expf(val - mn);
          sum += val;
        }
      z_run[hf] = z_run[hf] * al[hf] + sum;
      m_run[hf] = mn;
    }

    // ctx[d][e] = ctx[d][e] * alpha[d] + sum_r ek[r][d] v[r][e]
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) ctx[nb][j] *= al[j >> 1];
    proxy_fence();
    warpgroup_sync(wg);  // this warpgroup's v^T is written
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TMR / 16; ++ks) {
      uint32_t a[4];
      frag_from_acc(a, acc[2 * ks], acc[2 * ks + 1]);
      wgmma_rs<0>(ctx, a, desc_k_major(vt + 2 * ks * TS, TS), true);
    }
    wgmma_commit();
    wgmma_wait();
  }

  cp_async_wait<0>();  // the chunk that a further tile would have used

  // the partial, in kv_stream_store's format: of the warpgroup's 64 x 64 only
  // the blocks where row and column belong to the same head
  const size_t p = (size_t)bi * nsplit + split;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int d = d0 + hf * 8;
    float z = z_run[hf];
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    if (d < hidden) {
      if (t == 0) {
        part_m[p * hidden + d] = m_run[hf];
        part_z[p * hidden + d] = z;
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        if ((nb >> 2) == (wm >> 1))
          *reinterpret_cast<float2*>(part_ctx + (p * hidden + d) * DH + (nb & 3) * 8 + 2 * t) =
              make_float2(ctx[nb][2 * hf], ctx[nb][2 * hf + 1]);
    }
  }
}

// wq: (c, 128) bf16 and wout: (128, c) bf16, zero past hidden. A block
// strides over the 64-row tiles of one batch entry. Warpgroup w computes
// heads 2w and 2w + 1 of q (64 columns) and, of the output, NB64 blocks of
// 64 columns from column w * half.
template <int CH, int LPR, int NB64>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(LPR))
phase_b_mma(const bf16* __restrict__ x, const float* __restrict__ g1s,
            const bf16* __restrict__ wq, const bf16* __restrict__ wout,
            const float* __restrict__ bout, const float* __restrict__ g2s,
            const float* __restrict__ ctxn, bf16* __restrict__ out, int n, int c, int hidden,
            int resident) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);          // K-major 64 rows x c
  bf16* at = ys + (c / 8) * TS;                          // K-major 64 rows x 128: q . context
  bf16* cs = at + 16 * TS;                               // MAXH x LDC: this batch's context
  float* ssq = reinterpret_cast<float*>(cs + MAXH * LDC);  // 2 x TMR
  bf16* ws = reinterpret_cast<bf16*>(ssq + 2 * TMR);     // wq | wout, or the ring
  const int qcs = chunk_stride(c), ocs = chunk_stride(MAXH);
  bf16* wq_s = ws;                                       // MN-major c x 128
  bf16* wo_s = ws + 16 * qcs;                            // MN-major 128 x (8 out_chunks)

  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm .. of the tile; warpgroup
  const int ntiles = (n + TMR - 1) / TMR;
  const int ocol0 = wn * out_half(c), ncols = max(0, min(out_half(c), c - ocol0));
  const bf16* xb = x + (size_t)bi * n * c;

  // when streaming: q's chunks of KCH rows, then wout's of KCH_O, tile after tile
  int it = 0;
  const int stage = cmax(16 * chunk_stride(KCH), out_chunks(c) * chunk_stride(KCH_O));
  auto q_chunk = [&](int k0) { return Chunk{wq, MAXH, k0, min(KCH, c - k0), 0, 16}; };
  auto o_chunk = [&](int k0) { return Chunk{wout, c, k0, KCH_O, 0, c / 8}; };
  if (resident) {
    copy_mn_async<THREADS>(wq_s, qcs, wq, MAXH, 0, c, 0, 16);
    copy_mn_async<THREADS>(wo_s, ocs, wout, c, 0, MAXH, 0, c / 8);
    cp_async_commit();
  } else {
    chunk_load(ws, q_chunk(0));
  }
  for (int idx = threadIdx.x; idx < MAXH * DH; idx += THREADS) {
    const int d = idx / DH, e = idx - d * DH;
    cs[d * LDC + e] =
        __float2bfloat16(d < hidden ? ctxn[((size_t)bi * hidden + d) * DH + e] : 0.f);
  }

  float g1[CH][8];
  load_gain<CH, LPR>(g1, g1s, c);
  uint4 xr[LPR / 4][CH];
  rows_load<CH, LPR>(xr, xb + (size_t)blockIdx.x * TMR * c, min(TMR, n - (int)blockIdx.x * TMR),
                     c);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * TMR, nvalid = min(TMR, n - r0);
    rows_norm_store<CH, LPR>(xr, g1, ys, c);
    const int next = tile + gridDim.x;
    if (next < ntiles)
      rows_load<CH, LPR>(xr, xb + (size_t)next * TMR * c, min(TMR, n - next * TMR), c);
    if (resident) cp_async_wait<0>();  // the weights, before the first tile
    proxy_fence();
    __syncthreads();

    // q = y wq: the tile's 64 rows, this warpgroup's 64 columns (two heads);
    // this warp holds rows 16 wm ..
    float q[8][4];
    if (resident) {
      wgmma_fence();
      for (int k0 = 0; k0 < c; k0 += 16)
        wgmma_ss<0, 1>(q, desc_k_major(ys + (k0 / 8) * TS, TS),
                       desc_mn_major(wq_s + wn * 8 * qcs + k0 * 8, qcs), k0 > 0);
      wgmma_commit();
      wgmma_wait();
    } else {
      for (int k0 = 0; k0 < c; k0 += KCH)
        ring_step(ws, stage, it, q_chunk(k0), k0 + KCH < c ? q_chunk(k0 + KCH) : o_chunk(0),
                  [&](const bf16* tile_w, int wcs) {
                    for (int kk = 0; kk < min(KCH, c - k0); kk += 16)
                      wgmma_ss<0, 1>(q, desc_k_major(ys + ((k0 + kk) / 8) * TS, TS),
                                     desc_mn_major(tile_w + wn * 8 * wcs + kk * 8, wcs),
                                     k0 + kk > 0);
                  });
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int head = wn * 2 + hh;
      // softmax over the head's 32 columns of rows g (hf = 0) and g + 8: they
      // lie in this quad's registers
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = NEG;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mx = fmaxf(mx, fmaxf(q[4 * hh + nb][2 * hf], q[4 * hh + nb][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float den = 0.f;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            float& val = q[4 * hh + nb][2 * hf + par];
            val = __expf(val - mx);
            den += val;
          }
        den += __shfl_xor_sync(0xffffffffu, den, 1);
        den += __shfl_xor_sync(0xffffffffu, den, 2);
        const float inv = 1.f / den;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            float& val = q[4 * hh + nb][2 * hf + par];
            val = val * inv * SCALE;
          }
      }
      // attn = qn ctx of this head (K = N = 32: mma.sync), qn rounded to bf16
      // in registers
      float av[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) av[i][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4];
        frag_from_acc(a, q[4 * hh + 2 * ks], q[4 * hh + 2 * ks + 1]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, cs + (head * DH + ks * 16 + bt_row(lane)) * LDC + p * 16 +
                                    bt_col(lane));
          mma_bf16(av[2 * p], a, bb[0], bb[1]);
          mma_bf16(av[2 * p + 1], a, bb[2], bb[3]);
        }
      }
      // rounded to bf16 into the K-major tile: column head * 32 + nb * 8 + 2t
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(at + (head * 4 + nb) * TS + (wm * 16 + g + hf * 8) * 8 +
                                       2 * t) = pack_bf16(av[nb][2 * hf], av[nb][2 * hf + 1]);
    }
    proxy_fence();
    __syncthreads();

    // o = attn wout + bout: the tile's 64 rows, this warpgroup's columns in
    // blocks of 64 (those past its share are skipped, the last may run past
    // it and is masked when read)
    float o[NB64][8][4];
    if (resident) {
      wgmma_fence();
#pragma unroll
      for (int jb = 0; jb < NB64; ++jb)
        if (jb * 64 < ncols)
          for (int k0 = 0; k0 < MAXH; k0 += 16)
            wgmma_ss<0, 1>(o[jb], desc_k_major(at + (k0 / 8) * TS, TS),
                           desc_mn_major(wo_s + (ocol0 / 8 + jb * 8) * ocs + k0 * 8, ocs),
                           k0 > 0);
      wgmma_commit();
      wgmma_wait();
    } else {
      for (int k0 = 0; k0 < MAXH; k0 += KCH_O)
        ring_step(ws, stage, it, o_chunk(k0),
                  k0 + KCH_O < MAXH ? o_chunk(k0 + KCH_O) : q_chunk(0),
                  [&](const bf16* tile_w, int wcs) {
#pragma unroll
                    for (int jb = 0; jb < NB64; ++jb)
                      if (jb * 64 < ncols)
                        for (int kk = 0; kk < KCH_O; kk += 16)
                          wgmma_ss<0, 1>(
                              o[jb], desc_k_major(at + ((k0 + kk) / 8) * TS, TS),
                              desc_mn_major(tile_w + (ocol0 / 8 + jb * 8) * wcs + kk * 8, wcs),
                              k0 + kk > 0);
                  });
    }

    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int jb = 0; jb < NB64; ++jb)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        if (jb * 64 + nb * 8 < ncols) {
          const float2 bv =
              *reinterpret_cast<const float2*>(bout + ocol0 + jb * 64 + nb * 8 + 2 * t);
          float(&v)[4] = o[jb][nb];
          v[0] += bv.x;
          v[1] += bv.y;
          v[2] += bv.x;
          v[3] += bv.y;
          ss[0] += v[0] * v[0] + v[1] * v[1];
          ss[1] += v[2] * v[2] + v[3] * v[3];
        }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      ss[hf] += __shfl_xor_sync(0xffffffffu, ss[hf], 1);
      ss[hf] += __shfl_xor_sync(0xffffffffu, ss[hf], 2);
      if (t == 0) ssq[wn * TMR + wm * 16 + g + hf * 8] = ss[hf];
    }
    __syncthreads();

    // the output RMSNorm over the whole row, both halves' sums of squares;
    // the bf16 tile goes through ys (free since the q product) so that the
    // block writes it to device memory 16 bytes a lane, whole rows at a time
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wm * 16 + g + hf * 8;
      const float inv = 1.f / fmaxf(sqrtf(ssq[row] + ssq[TMR + row]), 1e-12f);
#pragma unroll
      for (int jb = 0; jb < NB64; ++jb)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          if (jb * 64 + nb * 8 < ncols) {
            const int col = ocol0 + jb * 64 + nb * 8 + 2 * t;
            const float2 gv = *reinterpret_cast<const float2*>(g2s + col);
            *reinterpret_cast<uint32_t*>(ys + (col >> 3) * TS + row * 8 + 2 * t) = pack_bf16(
                o[jb][nb][2 * hf] * inv * gv.x, o[jb][nb][2 * hf + 1] * inv * gv.y);
          }
    }
    __syncthreads();
    const int per_row = c >> 3;
    bf16* ob = out + ((size_t)bi * n + r0) * c;
    for (int idx = threadIdx.x; idx < nvalid * per_row; idx += THREADS) {
      const int r = idx / per_row, ch = idx - r * per_row;
      *reinterpret_cast<uint4*>(ob + (size_t)r * c + ch * 8) =
          *reinterpret_cast<const uint4*>(ys + ch * TS + r * 8);
    }
    __syncthreads();  // ys is rewritten at the top of the next tile
  }
  cp_async_wait<0>();  // the chunk that a further tile would have used
}

template <int CH, int LPR, int NB64>
int launch_mma(const bf16* x, const float* g1s, const bf16* wq, const bf16* wkv, const bf16* wout,
               const float* bout, const float* g2s, bf16* out, float* part_m, float* part_z,
               float* part_ctx, float* ctxn, int b, int n, int c, int hidden, int rows_per_split,
               int nsplit, cudaStream_t st) {
  const int resident = c <= 256;
  const size_t smem_a = phase_a_mma_bytes(c, resident), smem_b = phase_b_mma_bytes(c, resident);
  // Function attributes are set once per instantiation and device, for the
  // widest c it serves (CH * LPR * 8).
  static int prepared = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaError_t err = cudaSuccess;
  if (prepared != dev) {
    constexpr int CMAX = CH * LPR * 8;
    constexpr bool RES = CMAX <= 256;
    err = cudaFuncSetAttribute(phase_a_mma<CH, LPR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)phase_a_mma_bytes(CMAX, RES));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(phase_b_mma<CH, LPR, NB64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)phase_b_mma_bytes(CMAX, RES));
    if (err != cudaSuccess) return err;
    // all of the SM's memory as shared memory, or the second block does not fit
    cudaFuncSetAttribute(phase_a_mma<CH, LPR>, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(phase_b_mma<CH, LPR, NB64>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    prepared = dev;
  }

  phase_a_mma<CH, LPR><<<dim3(nsplit, b), THREADS, smem_a, st>>>(
      x, g1s, wkv, part_m, part_z, part_ctx, n, c, hidden, rows_per_split, nsplit, resident);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kv_partials<bf16><<<dim3(hidden, b), DH, 0, st>>>(part_m, part_z, part_ctx, ctxn, hidden,
                                                         nsplit, 1.0f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // persistent: as many blocks as are resident at once (two an SM for
  // c <= 128, else one), whole blocks per batch entry so that no SM waits for
  // a second, partial wave
  const int tiles = (n + TMR - 1) / TMR;
  const int blocks = max(1, min(tiles, blocks_per_sm(LPR) * sm_count() / b));
  phase_b_mma<CH, LPR, NB64><<<dim3(blocks, b), THREADS, smem_b, st>>>(
      x, g1s, wq, wout, bout, g2s, ctxn, out, n, c, hidden, resident);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* g1s, const void* wq, const void* wk, const void* wv,
           const void* wout, const void* bout, const void* g2s, void* out, void* part_m,
           void* part_z, void* part_ctx, void* ctxn, int b, int n, int c, int hidden,
           int rows_per_split, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_a = sizeof(float) * phase_a_floats(c);
  const size_t smem_b = sizeof(float) * phase_b_floats(c);
  cudaError_t err = cudaFuncSetAttribute(phase_a<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(phase_b<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;

  phase_a<T><<<dim3(nsplit, b), THREADS, smem_a, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g1s), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<float*>(part_m), static_cast<float*>(part_z),
      static_cast<float*>(part_ctx), n, c, hidden, rows_per_split, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kv_partials<T><<<dim3(hidden, b), DH, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_z),
      static_cast<const float*>(part_ctx), static_cast<float*>(ctxn), hidden, nsplit, 1.0f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  phase_b<T><<<dim3((n + TM - 1) / TM, b), THREADS, smem_b, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g1s), static_cast<const T*>(wq),
      static_cast<const T*>(wout), static_cast<const float*>(bout),
      static_cast<const float*>(g2s), static_cast<const float*>(ctxn), static_cast<T*>(out), n,
      c, hidden);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, n, c) in T; g1s, g2s: gains * sqrt(c), bout: (c,), all float;
// wq, wk, wv: (c, hidden), wout: (hidden, c) in T. Scratch (float):
// part_m, part_z (b, nsplit, hidden), part_ctx (b, nsplit, hidden, 32),
// ctxn (b, hidden, 32). Requires hidden % 32 == 0, hidden <= 128, c <= 512,
// rows_per_split % 32 == 0 and nsplit * rows_per_split >= n.
extern "C" int srgd_linattn_block_f32(const void* x, const void* g1s, const void* wq,
                                      const void* wk, const void* wv, const void* wout,
                                      const void* bout, const void* g2s, void* out, void* part_m,
                                      void* part_z, void* part_ctx, void* ctxn, int b, int n,
                                      int c, int hidden, int rows_per_split, int nsplit,
                                      void* stream) {
  return launch<float>(x, g1s, wq, wk, wv, wout, bout, g2s, out, part_m, part_z, part_ctx, ctxn,
                       b, n, c, hidden, rows_per_split, nsplit, stream);
}

// The bfloat16 entry takes the weights packed by the wrapper: wq (c, 128),
// wkv (c, 256) = wk | wv at columns 0 and 128, wout (128, c), zero past
// hidden. Requires c % 16 == 0, rows_per_split % 64 == 0 and 16-byte aligned
// x.
extern "C" int srgd_linattn_block_bf16(const void* x, const void* g1s, const void* wq,
                                       const void* wkv, const void* wout, const void* bout,
                                       const void* g2s, void* out, void* part_m, void* part_z,
                                       void* part_ctx, void* ctxn, int b, int n, int c,
                                       int hidden, int rows_per_split, int nsplit, void* stream) {
  auto go = c <= 128 ? launch_mma<1, 16, 1>
                      : c <= 256 ? launch_mma<1, 32, 2> : launch_mma<2, 32, 4>;
  return go(static_cast<const bf16*>(x), static_cast<const float*>(g1s),
            static_cast<const bf16*>(wq), static_cast<const bf16*>(wkv),
            static_cast<const bf16*>(wout), static_cast<const float*>(bout),
            static_cast<const float*>(g2s), static_cast<bf16*>(out), static_cast<float*>(part_m),
            static_cast<float*>(part_z), static_cast<float*>(part_ctx),
            static_cast<float*>(ctxn), b, n, c, hidden, rows_per_split, nsplit,
            static_cast<cudaStream_t>(stream));
}

extern "C" const char* srgd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
