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
// exp(m_i - m), normalises once and rounds the context to T (the stream and
// the merge are common.cuh's, shared with linear_attention.cu). Phase B owns
// whole rows, because the output RMSNorm reduces over all c <= 512 columns:
// each warp holds 4 full rows, so both row reductions are warp reductions.
//
// Rounding points follow _xla_linattn_block: y, v, the normalised q and
// context, and q . context are rounded to T before their products. The one
// point that cannot match is exp(k - m), which is rounded before its
// division by z because z is only known after the merge.
#include "common.cuh"

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

extern "C" int srgd_linattn_block_bf16(const void* x, const void* g1s, const void* wq,
                                       const void* wk, const void* wv, const void* wout,
                                       const void* bout, const void* g2s, void* out, void* part_m,
                                       void* part_z, void* part_ctx, void* ctxn, int b, int n,
                                       int c, int hidden, int rows_per_split, int nsplit,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, g1s, wq, wk, wv, wout, bout, g2s, out, part_m, part_z,
                               part_ctx, ctxn, b, n, c, hidden, rows_per_split, nsplit, stream);
}

extern "C" const char* srgd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
