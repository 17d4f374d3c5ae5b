// Fused whole-block full attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srgd_tpu/kernels/attn_block.py
// (fused_attn_block, body _kernel): RMSNorm -> qkv 1x1 projection -> per
// head softmax(q k^T * dim_head^-0.5) v -> to_out 1x1 + bias.
//
// The TPU kernel holds one batch element's whole (n, n) float similarity
// matrix in VMEM (4 MB at n = 1024, from the shape), far over a block's
// shared memory, so the block runs here as launches with the online softmax
// over key tiles: no score ever reaches device memory.
//
// Bound on this card: operations. At (8, 1024, 1024) in bfloat16 the
// function does 12.9 GFLOP (the two projections 6.4 and 2.1, the attention
// products 4.3) against 34.6 MB of x, output and weights (from the shapes),
// about 370 operations a byte, over the card's ridge. Within the attention
// core, d = 32 gives one exponential for every 64 multiply-adds, so the
// exponentials, not the tensor cores, set the pace of that part
// (attention.cu's note).
//
// bfloat16 (qkv_proj_mma, attn_block_flash, out_proj_mma): three launches on
// the tensor cores, the rounding points those of _xla_attn_block.
//  1. RMSNorm + qkv projection: a block normalises one 64-row tile of x in
//     float (a warp a row), writes y rounded to bf16 into shared memory in
//     the K-major chunked layout of a wgmma operand, and
//     multiplies it by all of wqkv (c, 384) with wgmma m64n64k16, one
//     warpgroup 192 columns. The x tile comes in as one group of 16-byte
//     cp.async copies and is normalised once, in place; at b = 8 the 128
//     row tiles are one wave on 132 SMs (three 128-column groups as blocks
//     of their own normalised each tile three times and, at c = 1024, ran
//     in three waves of one block an SM). The weight (768 KB at c = 1024)
//     streams through a three-stage cp.async ring of 32-row chunks, two in
//     flight under each chunk's products, each block starting on another
//     chunk so that the blocks do not all ask the L2 for the same lines at
//     once. qkv (b, n, 384) is rounded to bf16 and leaves through a staged
//     tile in 16-byte stores: 6.3 MB of scratch that stays in the L2.
//  What bounds it now: the qkv weight stream. Every block reads all of the
//  weight, 100 MB of L2 reads a call at c = 1024; sharing each chunk among
//  the blocks of a cluster (TMA multicast) is the next step.
//  2. Attention: flash.cuh's loop (attention.cu's flash_mma) on strided views
//     of the scratch, the same way Attention(use_pallas) calls the attention
//     kernel: q, k, v at column offsets 0, 128, 256, row stride 384. Scores
//     are float, the scale applied to the float product, p rounded to bf16
//     before its division by l, o rounded to bf16 into (b, n, hidden).
//  3. to_out + bias: the same tile product as step 1 with o as the operand
//     (its 64 x hidden tile copied in with cp.async) and wout (hidden, c) in
//     128-column groups of 64-row chunks, a block each, four blocks an SM;
//     the bias is added to the float accumulator.
// Step 3 is not fused into step 2: a flash block owns one head of 128 query
// rows, and to_out needs all four heads of a row.
//
// float32 (qkv_proj, attend): the exact path, float FMAs on the CUDA cores:
// (1) RMSNorm + qkv projection, writing qkv (b, n, 3*hidden) once; (2) per
// (query tile of 32 rows, batch element) all heads with an online softmax
// over key tiles of 64, then P.V and to_out + bias.
#include "common.cuh"
#include "flash.cuh"
#include "mma.cuh"

using namespace srgd;

namespace {

constexpr float SCALE = 0.17677669529663687f;  // dim_head ** -0.5
constexpr int TK = 64;                         // keys per tile
constexpr int LDK = TK + 1;                    // padded row of transposed keys / scores

__host__ __device__ constexpr int qkv_floats(int c) { return TM * c + KC * 32 * 4; }

// query tile, transposed keys (reused to stage to_out), values, scores, m, l, alpha
__host__ __device__ constexpr int attend_floats() {
  return TM * MAXH + MAXH * LDK + TK * MAXH + 4 * TM * LDK + 3 * 4 * TM;
}
static_assert(KC * 32 * 16 <= MAXH * LDK, "to_out staging must fit in the key tile");

template <typename T>
__global__ void __launch_bounds__(THREADS)
qkv_proj(const T* __restrict__ x, const float* __restrict__ g1s, const T* __restrict__ wqkv,
         T* __restrict__ qkv, int n, int c, int hidden) {
  extern __shared__ float smem[];
  float* ys = smem;         // TM x c
  float* ws = ys + TM * c;  // KC x 128

  const int bi = blockIdx.y, r0 = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvalid = min(TM, n - r0);
  const int h3 = 3 * hidden;

  load_norm_rows<T>(x + ((size_t)bi * n + r0) * c, g1s, ys, nvalid, c);
  for (int col0 = 0; col0 < h3; col0 += 128) {
    float acc[4][4];
    zero(acc);
    rows_matmul<T, 4>(acc, ys, c, c, wqkv, h3, col0, ws);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      if (r >= nvalid) continue;
      T* row = qkv + ((size_t)bi * n + r0 + r) * h3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + lane + 32 * j;
        if (col < h3) row[col] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attend(const T* __restrict__ qkv, const T* __restrict__ wout, const float* __restrict__ bout,
       T* __restrict__ out, int n, int c, int hidden) {
  extern __shared__ float smem[];
  float* qs = smem;                  // TM x MAXH
  float* kT = qs + TM * MAXH;        // MAXH x LDK: the key tile, transposed
  float* vs = kT + MAXH * LDK;       // TK x MAXH
  float* ss = vs + TK * MAXH;        // (head, row) x LDK scores, then probabilities
  float* m_run = ss + 4 * TM * LDK;  // (head, row)
  float* l_run = m_run + 4 * TM;
  float* alpha = l_run + 4 * TM;
  float* ws = kT;                    // to_out staging once the keys are done

  const int bi = blockIdx.y, r0 = blockIdx.x * TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nh = hidden / DH, h3 = 3 * hidden;
  const int nvalid = min(TM, n - r0);
  const T* base = qkv + (size_t)bi * n * h3;

  for (int idx = tid; idx < TM * MAXH; idx += THREADS) {
    const int r = idx / MAXH, col = idx - r * MAXH;
    qs[idx] = (r < nvalid && col < hidden) ? to_f32<T>(base[(size_t)(r0 + r) * h3 + col]) : 0.f;
  }
  for (int idx = tid; idx < 4 * TM; idx += THREADS) {
    m_run[idx] = NEG;
    l_run[idx] = 0.f;
  }

  // thread (warp, lane) accumulates rows warp*4+i, column lane of head h
  float o[4][4];
  zero(o);
  for (int k0 = 0; k0 < n; k0 += TK) {
    const int kvalid = min(TK, n - k0);
    __syncthreads();  // the previous key tile is consumed
    for (int idx = tid; idx < TK * MAXH; idx += THREADS) {
      const int j = idx / MAXH, col = idx - j * MAXH;
      const bool ok = j < kvalid && col < hidden;
      const T* row = base + (size_t)(k0 + j) * h3;
      kT[col * LDK + j] = ok ? to_f32<T>(row[hidden + col]) : 0.f;
      vs[idx] = ok ? to_f32<T>(row[2 * hidden + col]) : 0.f;
    }
    __syncthreads();

    for (int h = 0; h < nh; ++h) {
      float s[4][2];
      zero(s);
      for (int d = 0; d < DH; ++d) {
        const float k0v = kT[(h * DH + d) * LDK + lane];
        const float k1v = kT[(h * DH + d) * LDK + lane + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float q = qs[(warp * 4 + i) * MAXH + h * DH + d];
          s[i][0] = fmaf(q, k0v, s[i][0]);
          s[i][1] = fmaf(q, k1v, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = lane + 32 * jj;
          ss[(h * TM + warp * 4 + i) * LDK + j] = j < kvalid ? s[i][jj] * SCALE : NEG;
        }
    }
    __syncthreads();

    // online softmax, one thread per (head, query row)
    if (tid < nh * TM) {
      float* row = ss + tid * LDK;
      float mt = NEG;
      for (int j = 0; j < TK; ++j) mt = fmaxf(mt, row[j]);
      const float mo = m_run[tid];
      const float mn = fmaxf(mo, mt);
      const float al = expf(mo - mn);
      float sum = 0.f;
      for (int j = 0; j < TK; ++j) {
        const float e = expf(row[j] - mn);
        sum += e;
        row[j] = round_to<T>(e);
      }
      l_run[tid] = l_run[tid] * al + sum;
      m_run[tid] = mn;
      alpha[tid] = al;
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (h >= nh) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i][h] *= alpha[h * TM + warp * 4 + i];
      for (int j = 0; j < kvalid; ++j) {
        const float vv = vs[j * MAXH + h * DH + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[i][h] = fmaf(ss[(h * TM + warp * 4 + i) * LDK + j], vv, o[i][h]);
      }
    }
  }
  __syncthreads();  // every read of qs is done

#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (h >= nh) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      qs[r * MAXH + h * DH + lane] = round_to<T>(o[i][h] / l_run[h * TM + r]);
    }
  }

  for (int col0 = 0; col0 < c; col0 += 32 * 16) {
    float po[4][16];
    zero(po);
    rows_matmul<T, 16>(po, qs, MAXH, hidden, wout, c, col0, ws);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      if (r >= nvalid) continue;
      T* orow = out + ((size_t)bi * n + r0 + r) * c;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col0 + lane + 32 * j;
        if (col < c) orow[col] = from_f32<T>(po[i][j] + bout[col]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* g1s, const void* wqkv, const void* wout, const void* bout,
           void* qkv, void* out, int b, int n, int c, int hidden, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_p = sizeof(float) * qkv_floats(c);
  const size_t smem_a = sizeof(float) * attend_floats();
  cudaError_t err = cudaFuncSetAttribute(qkv_proj<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_p);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attend<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;

  const dim3 grid((n + TM - 1) / TM, b);
  qkv_proj<T><<<grid, THREADS, smem_p, st>>>(static_cast<const T*>(x),
                                             static_cast<const float*>(g1s),
                                             static_cast<const T*>(wqkv), static_cast<T*>(qkv),
                                             n, c, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attend<T><<<grid, THREADS, smem_a, st>>>(static_cast<const T*>(qkv),
                                           static_cast<const T*>(wout),
                                           static_cast<const float*>(bout), static_cast<T*>(out),
                                           n, c, hidden);
  return cudaGetLastError();
}

// ---- bfloat16: tensor cores ----------------------------------------------

constexpr int TMR = 64;                  // rows per tile: one wgmma M
constexpr int TS = chunk_stride(TMR);    // chunk stride of a 64-line K-major tile
constexpr int STAGES = 3;                // ring stages: two chunks in flight

// The tile product's geometry: a warpgroup multiplies NW blocks of 64
// columns, two warpgroups a block (COLS columns); the weight streams in
// chunks of KCH rows (wider blocks take shallower chunks, so that three
// stages fit beside the row tile).
template <int NW> struct Geo {
  static constexpr int COLS = 128 * NW;
  static constexpr int KCH = NW == 1 ? 64 : 32;
  static constexpr int WCS = chunk_stride(KCH);    // chunk stride of a ring stage
  static constexpr int WSTAGE = (COLS / 8) * WCS;  // elements of a ring stage
};

// Shared bytes of a tile product over depth k: the K-major row tile (at
// least COLS wide, since it also stages the output tile) and the ring (no
// more stages than chunks).
template <int NW> __host__ __device__ constexpr size_t proj_bytes(int k) {
  using G = Geo<NW>;
  const int nk = (k + G::KCH - 1) / G::KCH;
  return sizeof(bf16) * ((size_t)((k > G::COLS ? k : G::COLS) / 8) * TS +
                         (size_t)(nk < STAGES ? nk : STAGES) * G::WSTAGE);
}

// A block's weight slice: rows of w (ldw columns), the block's ncols <= COLS
// columns (a multiple of 8) from col0, depth K % 16 == 0; the columns of a
// last, partial 64-column block past ncols are computed and not stored. The
// ring walks its chunks from chunk kc0 (modulo their number) round to the
// one before it, so that blocks running at once start on different chunks
// and do not all ask the L2 for the same lines.
struct Weights {
  const bf16* w;
  int ldw, K, col0, ncols, kc0;
};

template <int NW> __device__ __forceinline__ int chunks(const Weights& wt) {
  return (wt.K + Geo<NW>::KCH - 1) / Geo<NW>::KCH;
}

// Start the copy of the ring's i-th chunk, k-chunk (kc0 + i) % chunks, into
// stage i % STAGES (MN-major) and commit it; past the last chunk commit an
// empty group, so that every thread's group count stays the ring's.
template <int NW>
__device__ __forceinline__ void load_w_chunk(bf16* ring, const Weights& wt, int i) {
  using G = Geo<NW>;
  const int nk = chunks<NW>(wt);
  if (i < nk) {
    const int kc = (wt.kc0 + i) % nk;
    copy_mn_async<THREADS>(ring + (i % STAGES) * G::WSTAGE, G::WCS, wt.w, wt.ldw, kc * G::KCH,
                           min(G::KCH, wt.K - kc * G::KCH), wt.col0 / 8, wt.ncols / 8);
  }
  cp_async_commit();
}

// The ring's first STAGES - 1 chunks, each its own group.
template <int NW> __device__ __forceinline__ void ring_prologue(bf16* ring, const Weights& wt) {
#pragma unroll
  for (int kc = 0; kc < STAGES - 1; ++kc) load_w_chunk<NW>(ring, wt, kc);
}

// out[r][col0 + j] = bf16(sum_k a[r][k] w[k][col0 + j] (+ bias[col0 + j]))
// for the tile's nvalid rows and the block's columns. a is the tile, K-major
// in shared memory (ys); the caller has committed its copies as one group
// before ring_prologue, or written it with ordinary stores after. Each chunk
// is multiplied while the next two are in flight. Every thread of the block
// must call it.
template <int NW>
__device__ __forceinline__ void tile_times_weights(bf16* ys, bf16* ring, const Weights& wt,
                                                   const float* __restrict__ bias,
                                                   bf16* __restrict__ out, int ldo, int nvalid) {
  using G = Geo<NW>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wm = warp & 3;  // warpgroup; rows 16 wm ..
  const int nk = chunks<NW>(wt);
  // the warpgroup's column blocks j: columns (wg * NW + j) * 64 ..
  auto active = [&](int j) { return (wg * NW + j) * 64 < wt.ncols; };

  float acc[NW][8][4];
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();  // chunk i (and the caller's tile) have landed
    proxy_fence();
    __syncthreads();  // for every thread; and chunk i - 1's stage is free
    load_w_chunk<NW>(ring, wt, i + STAGES - 1);
    const int kc = (wt.kc0 + i) % nk;
    const bf16* st = ring + (i % STAGES) * G::WSTAGE;
    const int klen = min(G::KCH, wt.K - kc * G::KCH);
    wgmma_fence();
    for (int kk = 0; kk < klen; kk += 16) {
      const uint64_t da = desc_k_major(ys + ((kc * G::KCH + kk) / 8) * TS, TS);
#pragma unroll
      for (int j = 0; j < NW; ++j)
        if (active(j))
          wgmma_ss<0, 1>(acc[j], da,
                         desc_mn_major(st + (wg * NW + j) * 8 * G::WCS + kk * 8, G::WCS),
                         i + kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
  }
  cp_async_wait<0>();
  __syncthreads();  // both warpgroups are done reading ys

  // the tile, rounded to bf16, staged in ys (chunk col / 8, line row) so
  // that it leaves in 16-byte stores, whole rows at a time
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (!active(j)) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = (wg * NW + j) * 64 + nb * 8 + 2 * t;
      float2 bv = make_float2(0.f, 0.f);
      if (bias != nullptr && col < wt.ncols)
        bv = *reinterpret_cast<const float2*>(bias + wt.col0 + col);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint32_t*>(ys + (col >> 3) * TS + (wm * 16 + g + hf * 8) * 8 +
                                     (col & 7)) =
            pack_bf16(acc[j][nb][2 * hf] + bv.x, acc[j][nb][2 * hf + 1] + bv.y);
    }
  }
  __syncthreads();
  const int nch = wt.ncols / 8;
  for (int idx = threadIdx.x; idx < nvalid * nch; idx += THREADS) {
    const int r = idx / nch, ch = idx - r * nch;
    *reinterpret_cast<uint4*>(out + (size_t)r * ldo + wt.col0 + ch * 8) =
        *reinterpret_cast<const uint4*>(ys + ch * TS + r * 8);
  }
}

// Start the copy of rows 0 .. 64 of a (., width) bf16 matrix src (row
// stride width) into the K-major tile ys; rows at or past nvalid are
// zero-filled.
__device__ __forceinline__ void load_tile(bf16* ys, const bf16* __restrict__ src, int width,
                                          int nvalid) {
  const int cpr = width / 8;
  for (int idx = threadIdx.x; idx < TMR * cpr; idx += THREADS) {
    const int r = idx / cpr, ch = idx - r * cpr;
    const bool ok = r < nvalid;
    cp_async16(ys + ch * TS + r * 8, src + (size_t)(ok ? r : 0) * width + ch * 8, ok);
  }
}

constexpr int QKV_NW = 3;  // the qkv projection: all 384 columns in one block
constexpr int OUT_NW = 1;  // to_out: 128 columns of c a block

// Grid (row tiles, b). wqkv: (c, 384) with q, k, v at columns 0, 128, 256
// (the wrapper zero-pads them past hidden); qkv: (b, n, 384).
__global__ void __launch_bounds__(THREADS)
qkv_proj_mma(const bf16* __restrict__ x, const float* __restrict__ g1s,
             const bf16* __restrict__ wqkv, bf16* __restrict__ qkv, int n, int c) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);       // K-major 64 rows x c
  bf16* ring = ys + (max(c, 3 * MAXH) / 8) * TS;       // STAGES weight chunks

  const int r0 = blockIdx.x * TMR, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvalid = min(TMR, n - r0);
  const int nch = c / 8;
  const Weights wt{wqkv, 3 * MAXH, c, 0, 3 * MAXH, (int)blockIdx.x};

  // the raw x tile in one group, in flight with the first weight chunks
  load_tile(ys, x + ((size_t)bi * n + r0) * c, c, nvalid);
  cp_async_commit();
  ring_prologue<QKV_NW>(ring, wt);
  cp_async_wait<STAGES - 1>();  // the x tile
  __syncthreads();

  // y = bf16(x / max(||x||, 1e-12) * g1s) in place, a warp a row
  for (int r = warp; r < TMR; r += THREADS / 32) {
    float ss = 0.f;
    for (int ch = lane; ch < nch; ch += 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(ys + ch * TS + r * 8);
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ss += bf16_lo(w4[i]) * bf16_lo(w4[i]) + bf16_hi(w4[i]) * bf16_hi(w4[i]);
    }
    const float inv = 1.f / fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
    for (int ch = lane; ch < nch; ch += 32) {
      uint4* p = reinterpret_cast<uint4*>(ys + ch * TS + r * 8);
      const uint4 v = *p;
      const float4 ga = *reinterpret_cast<const float4*>(g1s + ch * 8);
      const float4 gb = *reinterpret_cast<const float4*>(g1s + ch * 8 + 4);
      uint4 y;
      y.x = pack_bf16(bf16_lo(v.x) * inv * ga.x, bf16_hi(v.x) * inv * ga.y);
      y.y = pack_bf16(bf16_lo(v.y) * inv * ga.z, bf16_hi(v.y) * inv * ga.w);
      y.z = pack_bf16(bf16_lo(v.z) * inv * gb.x, bf16_hi(v.z) * inv * gb.y);
      y.w = pack_bf16(bf16_lo(v.w) * inv * gb.z, bf16_hi(v.w) * inv * gb.w);
      *p = y;
    }
  }

  tile_times_weights<QKV_NW>(ys, ring, wt, nullptr, qkv + ((size_t)bi * n + r0) * (3 * MAXH),
                             3 * MAXH, nvalid);
}

// q, k, v: the views of qkv (b, n, 384) at columns 0, 128, 256; o: (b, n,
// hidden). Its own name, so that a profile charges it to attn_block.
__global__ void __launch_bounds__(FLASH_THREADS)
attn_block_flash(const bf16* __restrict__ qkv, bf16* __restrict__ o, int heads, int n) {
  const long long h3 = 3 * MAXH, hidden = heads * DH;
  const Strides sqkv{n * h3, DH, h3}, so{n * hidden, DH, hidden};
  flash_mma_block(qkv, qkv + MAXH, qkv + 2 * MAXH, o, sqkv, sqkv, sqkv, so, heads, n);
}

// Grid (column groups of c, row tiles, b). o: (b, n, hidden); wout:
// (hidden, c); out: (b, n, c).
__global__ void __launch_bounds__(THREADS)
out_proj_mma(const bf16* __restrict__ o, const bf16* __restrict__ wout,
             const float* __restrict__ bout, bf16* __restrict__ out, int n, int c, int hidden) {
  constexpr int COLS = Geo<OUT_NW>::COLS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);     // K-major 64 rows x hidden
  bf16* ring = ys + (COLS / 8) * TS;

  const int col0 = blockIdx.x * COLS, r0 = blockIdx.y * TMR, bi = blockIdx.z;
  const int nvalid = min(TMR, n - r0);
  const Weights wt{wout, c, hidden, col0, min(COLS, c - col0), (int)blockIdx.y};

  load_tile(ys, o + ((size_t)bi * n + r0) * hidden, hidden, nvalid);
  cp_async_commit();
  ring_prologue<OUT_NW>(ring, wt);
  tile_times_weights<OUT_NW>(ys, ring, wt, bout, out + ((size_t)bi * n + r0) * c, c, nvalid);
}

int launch_mma(const bf16* x, const float* g1s, const bf16* wqkv, const bf16* wout,
               const float* bout, bf16* qkv, bf16* o, bf16* out, int b, int n, int c, int hidden,
               cudaStream_t st) {
  // the attributes are set once per device, for the widest c (1024)
  static int prepared = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaError_t err = cudaSuccess;
  if (prepared != dev) {
    err = cudaFuncSetAttribute(qkv_proj_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)proj_bytes<QKV_NW>(1024));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(out_proj_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)proj_bytes<OUT_NW>(MAXH));
    if (err != cudaSuccess) return err;
    // all of the SM's memory as shared memory, so that four to_out blocks fit
    cudaFuncSetAttribute(out_proj_mma, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    prepared = dev;
  }
  const int tiles = (n + TMR - 1) / TMR;
  qkv_proj_mma<<<dim3(tiles, b), THREADS, proj_bytes<QKV_NW>(c), st>>>(x, g1s, wqkv, qkv, n, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int heads = hidden / DH;
  attn_block_flash<<<flash_grid(b, heads, n), FLASH_THREADS, 0, st>>>(qkv, o, heads, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int COLS = Geo<OUT_NW>::COLS;
  out_proj_mma<<<dim3((c + COLS - 1) / COLS, tiles, b), THREADS, proj_bytes<OUT_NW>(hidden),
                 st>>>(o, wout, bout, out, n, c, hidden);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, n, c) in T; g1s: gain * sqrt(c) and bout: (c,), float;
// wqkv: (c, 3*hidden), wout: (hidden, c) in T; qkv: (b, n, 3*hidden) scratch
// in T. Requires hidden % 32 == 0, hidden <= 128 and c <= 1024.
extern "C" int srgd_attn_block_f32(const void* x, const void* g1s, const void* wqkv,
                                   const void* wout, const void* bout, void* qkv, void* out, int b,
                                   int n, int c, int hidden, void* stream) {
  return launch<float>(x, g1s, wqkv, wout, bout, qkv, out, b, n, c, hidden, stream);
}

// The bfloat16 entry takes wqkv packed by the wrapper as (c, 384), q, k, v
// at columns 0, 128, 256, zero past hidden; scratch qkv (b, n, 384) and
// o (b, n, hidden). Requires c % 16 == 0, c <= 1024, hidden % 32 == 0,
// hidden <= 128 and 16-byte aligned x, wqkv, wout, g1s, bout.
extern "C" int srgd_attn_block_bf16(const void* x, const void* g1s, const void* wqkv,
                                    const void* wout, const void* bout, void* qkv, void* o,
                                    void* out, int b, int n, int c, int hidden, void* stream) {
  return launch_mma(static_cast<const bf16*>(x), static_cast<const float*>(g1s),
                    static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wout),
                    static_cast<const float*>(bout), static_cast<bf16*>(qkv),
                    static_cast<bf16*>(o), static_cast<bf16*>(out), b, n, c, hidden,
                    static_cast<cudaStream_t>(stream));
}
