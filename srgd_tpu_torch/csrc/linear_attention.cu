// Linear-attention core for Hopper (sm_90a), from separate or packed q, k, v.
//
// Replaces the Pallas TPU kernels of srgd_tpu/kernels/linear_attention.py:
// fused_linear_attention (bodies _kv_kernel, _out_kernel) and
// fused_linear_attention_qkv (their packed twins). Per batch element, with
// heads packed in the channel dim (c = head*32 + d):
//   ctx[d][e] = sum_n softmax_n(k)[n][d] * v[n][e]      (within each head)
//   out[n][e] = sum_d softmax_d(q)[n][d] * 32^-0.5 * ctx[d][e]
//
// One device implementation serves both entries: q, k and v are three base
// pointers sharing a row stride, so the packed form (row stride 3C, bases
// qkv, qkv + C, qkv + 2C) and the separate form (row stride C) run the same
// code and nothing is sliced or copied; the two entries agree bit for bit.
//
// The TPU kernel carries the running column max of k, the column sums and
// the context across a sequential grid in scratch memory. Blocks here run in
// parallel and in no order, so the sequence is split over blocks (pass A):
// each streams its rows with the online-max update and writes a partial (m,
// z and the head-diagonal 32x32 blocks of ctx); merge_kv_partials
// (common.cuh, shared with linattn_block.cu) rescales them by exp(m_i - m) in
// index order, divides by the column sums and folds the 32^-0.5. The TPU
// kernel computes the full (C, C) product and masks the cross-head terms
// afterwards; they are never computed here. Pass C owns whole rows.
//
// Bound on this card: bytes. The function reads q, k, v and writes out once,
// 4 * b*n*C elements, against 4 * b*n*C*32 flops of head-diagonal products,
// 16 flops a byte in bf16: far under the card's ridge.
//
// bfloat16 (kv_partials_mma, out_rows_mma): the products on the tensor cores
// (mma.sync m16n8k16; a 32 x 32 head block is under wgmma's 64-row M).
//  - Pass A: 64-row tiles of k and v come in through a three-stage ring of
//    16-byte cp.async copies, zero-filled past the split's end, so the tiles
//    after this one load under its work. The column statistics use all 256
//    threads: a thread owns two neighbouring columns over 16 rows, the four
//    row quarters' maxima meet in shared memory, and masked rows never win
//    the max. exp(k - m) is rounded to bf16 in place in the tile; each warp
//    then adds ek^T v for 16 rows of one head's 32 x 32 context block (A =
//    ek^T through ldmatrix.trans, B = v through the transposed load: 16 mma a
//    warp a tile), its float accumulator held in registers across the tiles
//    and rescaled by alpha. Two blocks share an SM.
//  - Pass C: a persistent block walks 128-row tiles of q (row stride ld),
//    double-buffered by 16-byte cp.async copies; a warp owns 16 rows. Its q
//    rows come out of shared memory as mma A fragments (ldmatrix), the
//    per-head softmax runs in those registers, shifted by the row max over
//    all heads (exact: a shift shared by the row), qn is rounded to bf16 in
//    place as the A operand, and the head's normalised context (bf16, loaded
//    into shared memory once per block) is the B operand. The output tile is
//    staged over the warp's own q rows and leaves in 16-byte stores.
//  - Rounding: the TPU kernel keeps every intermediate in float. This path
//    rounds three of them to bf16: exp(k - m), before its division by z (as
//    linattn_block does, z being known only after the merge); the
//    normalised context; and qn. Expected divergences inside the bf16
//    tolerance (ROADMAP Queue 3).
//
// float32 (kv_partials, out_rows): the exact path, float FMAs on the CUDA
// cores with 32-row tiles; k, v and q are widened to float on load, every
// intermediate stays float, and only the output is cast.
#include "common.cuh"
#include "mma.cuh"

using namespace srgd;

namespace {

constexpr float SCALE = 0.17677669529663687f;  // dim_head ** -0.5

// Pass A shared floats: k | v tile, m, z, alpha.
constexpr int KV_FLOATS = TM * LDKV + 3 * MAXH;
// Pass C shared floats: q tile, context.
constexpr int OUT_FLOATS = TM * MAXH + MAXH * DH;

template <typename T>
__global__ void __launch_bounds__(THREADS)
kv_partials(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ part_m,
            float* __restrict__ part_z, float* __restrict__ part_ctx, int n, int ld, int hidden,
            int rows_per_split, int nsplit) {
  __shared__ float smem[KV_FLOATS];
  float* kv = smem;                   // TM x LDKV: k | v as float
  float* m_run = kv + TM * LDKV;      // hidden
  float* z_run = m_run + MAXH;        // hidden
  float* alpha = z_run + MAXH;        // hidden

  const int split = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, n);
  const size_t base = (size_t)bi * n * ld;

  float acc[16];
  kv_stream_init(m_run, z_run, acc);

  for (int r0 = row_begin; r0 < row_end; r0 += TM) {
    const int nvalid = min(TM, row_end - r0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < TM * MAXH; idx += THREADS) {
      const int r = idx / MAXH, col = idx - r * MAXH;
      const bool ok = r < nvalid && col < hidden;
      const size_t off = base + (size_t)(r0 + r) * ld + col;
      kv[r * LDKV + col] = ok ? to_f32<T>(k[off]) : NEG;  // masked rows never win the max
      kv[r * LDKV + MAXH + col] = ok ? to_f32<T>(v[off]) : 0.f;
    }
    kv_stream_tile<float>(kv, m_run, z_run, alpha, acc, hidden);
  }
  kv_stream_store(m_run, z_run, acc, part_m, part_z, part_ctx, (size_t)bi * nsplit + split, hidden);
}

// out[r] = softmax_head(q[r]) @ cn for the TM rows of a tile; cn is this
// batch element's (hidden, 32) normalised context with the scale folded in.
template <typename T>
__global__ void __launch_bounds__(THREADS)
out_rows(const T* __restrict__ q, const float* __restrict__ cn, T* __restrict__ out, int n, int ld,
         int hidden) {
  __shared__ float smem[OUT_FLOATS];
  float* qs = smem;              // TM x MAXH
  float* cs = qs + TM * MAXH;    // hidden x 32

  const int bi = blockIdx.y, r0 = blockIdx.x * TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nh = hidden / DH;
  const int nvalid = min(TM, n - r0);

  for (int j = tid; j < hidden * DH; j += THREADS) cs[j] = cn[(size_t)bi * hidden * DH + j];

  // thread (warp, lane) holds rows warp*4+i, column lane of head j
  float pq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    const T* qr = q + (size_t)bi * n * ld + (size_t)(r0 + r) * ld;
#pragma unroll
    for (int j = 0; j < 4; ++j) pq[i][j] = (r < nvalid && j < nh) ? to_f32<T>(qr[j * DH + lane]) : 0.f;
  }
  head_softmax_rows<float>(pq, qs, nh, 1.0f);
  __syncthreads();

  float pa[4][4];
  rows_times_context(pa, qs, cs, nh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    if (r >= nvalid) continue;
    T* orow = out + ((size_t)bi * n + r0 + r) * hidden;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nh) orow[j * DH + lane] = from_f32<T>(pa[i][j]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* part_m, void* part_z,
           void* part_ctx, void* cn, int b, int n, int ld, int hidden, int rows_per_split,
           int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kv_partials<T><<<dim3(nsplit, b), THREADS, 0, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<float*>(part_m),
      static_cast<float*>(part_z), static_cast<float*>(part_ctx), n, ld, hidden, rows_per_split,
      nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kv_partials<float><<<dim3(hidden, b), DH, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_z),
      static_cast<const float*>(part_ctx), static_cast<float*>(cn), hidden, nsplit, SCALE);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  out_rows<T><<<dim3((n + TM - 1) / TM, b), THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const float*>(cn), static_cast<T*>(out), n, ld, hidden);
  return cudaGetLastError();
}

// ---- bfloat16: tensor cores ----------------------------------------------

constexpr int LTR = 64;                    // rows of a pass-A tile
constexpr int LSTAGES = 3;                 // k | v tiles in flight
constexpr int LDT = MAXH + PAD;            // padded row of a k, v or q tile
constexpr int LTILE = LTR * LDT;           // elements of one k or v tile
constexpr int QTR = (THREADS / 32) * 16;   // rows of a pass-C tile: 16 a warp
constexpr int LDC = DH + PAD;              // padded row of the context

// ring of k | v tiles, the row quarters' maxima or sums, alpha
constexpr size_t kv_mma_bytes() {
  return sizeof(bf16) * LSTAGES * 2 * LTILE + sizeof(float) * 5 * MAXH;
}
// two q tiles, the context
constexpr size_t out_mma_bytes() { return sizeof(bf16) * (2 * QTR * LDT + MAXH * LDC); }

// Start the copy of rows r0 .. r0 + rows of a (., hidden) operand src with
// row stride ld into a padded tile; rows at or past row_end are zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int ld, int r0,
                                          int rows, int row_end, int hidden) {
  const int cpr = hidden / 8;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += THREADS) {
    const int r = idx / cpr, ch = idx - r * cpr;
    const bool ok = r0 + r < row_end;
    cp_async16(dst + r * LDT + ch * 8, src + (size_t)(ok ? r0 + r : 0) * ld + ch * 8, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
kv_partials_mma(const bf16* __restrict__ k, const bf16* __restrict__ v,
                float* __restrict__ part_m, float* __restrict__ part_z,
                float* __restrict__ part_ctx, int n, int ld, int hidden, int rows_per_split,
                int nsplit) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                     // stage: k tile | v tile
  float* red = reinterpret_cast<float*>(ring + LSTAGES * 2 * LTILE);  // 4 x MAXH
  float* alpha = red + 4 * MAXH;                                      // MAXH

  const int split = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, n);
  const int ntiles = (row_end - row_begin + LTR - 1) / LTR;
  const bf16* kb = k + (size_t)bi * n * ld;
  const bf16* vb = v + (size_t)bi * n * ld;

  auto load = [&](int it) {
    bf16* stage = ring + (it % LSTAGES) * 2 * LTILE;
    load_rows(stage, kb, ld, row_begin + it * LTR, LTR, row_end, hidden);
    load_rows(stage + LTILE, vb, ld, row_begin + it * LTR, LTR, row_end, hidden);
  };
  load(0);
  cp_async_commit();
  if (ntiles > 1) load(1);
  cp_async_commit();

  // statistics: thread (qr, cp) owns columns col, col + 1 over rows 16 qr ..
  const int qr = tid >> 6, col = 2 * (tid & 63);
  const bool scol = col < hidden;
  float m_run[2] = {NEG, NEG}, z_run[2] = {0.f, 0.f};  // z over this thread's rows only
  // context: warp w owns rows d0 .. d0 + 15 of head w / 2, in the C layout
  // of mma.m16n8k16 (block nb: columns e = nb * 8 ..)
  const int head = warp >> 1, d0 = head * DH + (warp & 1) * 16;
  const bool mrow = head < hidden / DH;
  float ctx[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j) ctx[nb][j] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<LSTAGES - 2>();  // tile it has landed
    __syncthreads();               // for every thread; and tile it - 1 is consumed
    if (it + LSTAGES - 1 < ntiles) load(it + LSTAGES - 1);
    cp_async_commit();
    bf16* kt = ring + (it % LSTAGES) * 2 * LTILE;
    const bf16* vt = kt + LTILE;
    const int nvalid = min(LTR, row_end - row_begin - it * LTR);

    if (scol) {
      float mt[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = qr * 16 + i;
        if (r < nvalid) {  // masked rows never win the max
          const uint32_t w = *reinterpret_cast<const uint32_t*>(kt + r * LDT + col);
          mt[0] = fmaxf(mt[0], bf16_lo(w));
          mt[1] = fmaxf(mt[1], bf16_hi(w));
        }
      }
      *reinterpret_cast<float2*>(red + qr * MAXH + col) = make_float2(mt[0], mt[1]);
    }
    __syncthreads();
    if (scol) {
      float mn[2], al[2], s[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float mt = fmaxf(fmaxf(red[col + j], red[MAXH + col + j]),
                               fmaxf(red[2 * MAXH + col + j], red[3 * MAXH + col + j]));
        mn[j] = fmaxf(m_run[j], mt);
        al[j] = __expf(m_run[j] - mn[j]);
        m_run[j] = mn[j];
      }
      // exp(k - m), rounded to bf16 in place; masked rows are 0
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = qr * 16 + i;
        uint32_t* p = reinterpret_cast<uint32_t*>(kt + r * LDT + col);
        float e0 = 0.f, e1 = 0.f;
        if (r < nvalid) {
          const uint32_t w = *p;
          e0 = __expf(bf16_lo(w) - mn[0]);
          e1 = __expf(bf16_hi(w) - mn[1]);
        }
        s[0] += e0;
        s[1] += e1;
        *p = pack_bf16(e0, e1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) z_run[j] = z_run[j] * al[j] + s[j];
      if (qr == 0) *reinterpret_cast<float2*>(alpha + col) = make_float2(al[0], al[1]);
    }
    __syncthreads();

    // ctx[d][e] = ctx[d][e] * alpha[d] + sum_r ek[r][d] v[r][e]
    if (mrow) {
      const float a_lo = alpha[d0 + g], a_hi = alpha[d0 + g + 8];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        ctx[nb][0] *= a_lo;
        ctx[nb][1] *= a_lo;
        ctx[nb][2] *= a_hi;
        ctx[nb][3] *= a_hi;
      }
#pragma unroll
      for (int ks = 0; ks < LTR / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, kt + (ks * 16 + bn_row(lane)) * LDT + d0 + bn_col(lane));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vt + (ks * 16 + bt_row(lane)) * LDT + head * DH + p * 16 +
                                    bt_col(lane));
          mma_bf16(ctx[2 * p], a, bb[0], bb[1]);
          mma_bf16(ctx[2 * p + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the partial in kv_stream_store's format; z summed over the row quarters
  // in a fixed order
  const size_t p = (size_t)bi * nsplit + split;
  if (scol) *reinterpret_cast<float2*>(red + qr * MAXH + col) = make_float2(z_run[0], z_run[1]);
  __syncthreads();
  if (scol && qr == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      part_m[p * hidden + col + j] = m_run[j];
      part_z[p * hidden + col + j] = ((red[col + j] + red[MAXH + col + j]) +
                                      red[2 * MAXH + col + j]) +
                                     red[3 * MAXH + col + j];
    }
  }
  if (mrow) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(part_ctx + (p * hidden + d0 + g + hf * 8) * DH + nb * 8 +
                                   2 * t) = make_float2(ctx[nb][2 * hf], ctx[nb][2 * hf + 1]);
  }
}

// out[r] = softmax_head(q[r]) @ cn; cn: this batch element's (hidden, 32)
// normalised context, scale folded in, rounded to bf16 by the merge. A block
// strides over the 128-row tiles of one batch element.
__global__ void __launch_bounds__(THREADS, 2)
out_rows_mma(const bf16* __restrict__ q, const float* __restrict__ cn, bf16* __restrict__ out,
             int n, int ld, int hidden) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // two q tiles, QTR x LDT
  bf16* cs = ring + 2 * QTR * LDT;                 // MAXH x LDC: the context

  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = hidden / DH, cpr = hidden / 8;
  const int ntiles = (n + QTR - 1) / QTR;
  const bf16* qb = q + (size_t)bi * n * ld;
  bf16* ob = out + (size_t)bi * n * hidden;

  if ((int)blockIdx.x < ntiles) load_rows(ring, qb, ld, blockIdx.x * QTR, QTR, n, hidden);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < hidden * DH; idx += THREADS) {
    const int d = idx / DH, e = idx - d * DH;
    cs[d * LDC + e] = __float2bfloat16(cn[((size_t)bi * hidden + d) * DH + e]);
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    cp_async_wait<0>();  // tile it has landed
    __syncthreads();     // for every thread; and tile it - 1's stage is free
    const int next = tile + gridDim.x;
    if (next < ntiles)
      load_rows(ring + ((it + 1) & 1) * QTR * LDT, qb, ld, next * QTR, QTR, n, hidden);
    cp_async_commit();
    bf16* qw = ring + (it & 1) * QTR * LDT + warp * 16 * LDT;  // this warp's 16 rows

    // q as the A fragments of its 16-column blocks: rows g (registers 0, 2)
    // and g + 8 (registers 1, 3)
    uint32_t qa[MAXH / 16][4];
#pragma unroll
    for (int kb = 0; kb < MAXH / 16; ++kb)
      if (kb < 2 * nh) ldmatrix_x4(qa[kb], qw + (lane & 15) * LDT + kb * 16 + ((lane >> 4) << 3));
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int kb = 0; kb < MAXH / 16; ++kb)
      if (kb < 2 * nh)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx[j & 1] = fmaxf(mx[j & 1], fmaxf(bf16_lo(qa[kb][j]), bf16_hi(qa[kb][j])));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    }

#pragma unroll
    for (int h = 0; h < MAXH / DH; ++h) {
      if (h >= nh) continue;
      // the head's softmax over its 32 columns, which lie in this quad
      float e[2][4][2], den[2] = {0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e[ks][j][0] = __expf(bf16_lo(qa[2 * h + ks][j]) - mx[j & 1]);
          e[ks][j][1] = __expf(bf16_hi(qa[2 * h + ks][j]) - mx[j & 1]);
          den[j & 1] += e[ks][j][0] + e[ks][j][1];
        }
      float inv[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        den[hf] += __shfl_xor_sync(0xffffffffu, den[hf], 1);
        den[hf] += __shfl_xor_sync(0xffffffffu, den[hf], 2);
        inv[hf] = 1.f / den[hf];
      }
      // out = qn cn, qn rounded to bf16 as the A operand
      float acc[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nb][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[j] = pack_bf16(e[ks][j][0] * inv[j & 1], e[ks][j][1] * inv[j & 1]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, cs + (h * DH + ks * 16 + bt_row(lane)) * LDC + p * 16 +
                                    bt_col(lane));
          mma_bf16(acc[2 * p], a, bb[0], bb[1]);
          mma_bf16(acc[2 * p + 1], a, bb[2], bb[3]);
        }
      }
      // staged over this warp's q rows, which it no longer reads
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(qw + (g + hf * 8) * LDT + h * DH + nb * 8 + 2 * t) =
              pack_bf16(acc[nb][2 * hf], acc[nb][2 * hf + 1]);
    }
    __syncwarp();
    const int r0 = tile * QTR + warp * 16;
    for (int idx = lane; idx < 16 * cpr; idx += 32) {
      const int r = idx / cpr, ch = idx - r * cpr;
      if (r0 + r < n)
        *reinterpret_cast<uint4*>(ob + (size_t)(r0 + r) * hidden + ch * 8) =
            *reinterpret_cast<const uint4*>(qw + r * LDT + ch * 8);
    }
  }
  cp_async_wait<0>();
}

int launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* part_m,
               float* part_z, float* part_ctx, float* cn, int b, int n, int ld, int hidden,
               int rows_per_split, int nsplit, cudaStream_t st) {
  static int prepared = -1;  // the attributes are set once per device
  int dev = 0;
  cudaGetDevice(&dev);
  cudaError_t err = cudaSuccess;
  if (prepared != dev) {
    err = cudaFuncSetAttribute(kv_partials_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kv_mma_bytes());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(out_rows_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out_mma_bytes());
    if (err != cudaSuccess) return err;
    // all of the SM's memory as shared memory, or the second block does not fit
    cudaFuncSetAttribute(kv_partials_mma, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(out_rows_mma, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    prepared = dev;
  }
  kv_partials_mma<<<dim3(nsplit, b), THREADS, kv_mma_bytes(), st>>>(
      k, v, part_m, part_z, part_ctx, n, ld, hidden, rows_per_split, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kv_partials<bf16><<<dim3(hidden, b), DH, 0, st>>>(part_m, part_z, part_ctx, cn, hidden,
                                                         nsplit, SCALE);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // persistent: two blocks an SM, whole blocks per batch entry
  const int tiles = (n + QTR - 1) / QTR;
  const int blocks = max(1, min(tiles, 2 * sm_count() / b));
  out_rows_mma<<<dim3(blocks, b), THREADS, out_mma_bytes(), st>>>(q, cn, out, n, ld, hidden);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: base pointers of (b, n, hidden) operands in T whose rows are ld
// elements apart and whose batch elements n * ld apart (packed qkv: ld =
// 3 * hidden and k = q + hidden, v = q + 2 * hidden); out: (b, n, hidden)
// contiguous in T. Scratch (float): part_m, part_z (b, nsplit, hidden),
// part_ctx (b, nsplit, hidden, 32), cn (b, hidden, 32). Requires
// hidden % 32 == 0, hidden <= 128, rows_per_split % 32 == 0 and
// nsplit * rows_per_split >= n.
extern "C" int srgd_linear_attention_f32(const void* q, const void* k, const void* v, void* out,
                                         void* part_m, void* part_z, void* part_ctx, void* cn,
                                         int b, int n, int ld, int hidden, int rows_per_split,
                                         int nsplit, void* stream) {
  return launch<float>(q, k, v, out, part_m, part_z, part_ctx, cn, b, n, ld, hidden,
                       rows_per_split, nsplit, stream);
}

// The bfloat16 entry also needs rows_per_split % 64 == 0, 16-byte aligned
// q, k, v and out, and ld % 8 == 0.
extern "C" int srgd_linear_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                          void* part_m, void* part_z, void* part_ctx, void* cn,
                                          int b, int n, int ld, int hidden, int rows_per_split,
                                          int nsplit, void* stream) {
  return launch_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out),
                    static_cast<float*>(part_m), static_cast<float*>(part_z),
                    static_cast<float*>(part_ctx), static_cast<float*>(cn), b, n, ld, hidden,
                    rows_per_split, nsplit, static_cast<cudaStream_t>(stream));
}
