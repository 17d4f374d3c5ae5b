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
// code and nothing is sliced or copied.
//
// The TPU kernel carries the running column max of k, the column sums and
// the context across a sequential grid in scratch memory. Blocks here run in
// parallel and in no order, so the sequence is split over blocks: each streams
// its rows with the online-max update and writes a partial (m, z and the
// head-diagonal 32x32 blocks of ctx); merge_kv_partials rescales them by
// exp(m_i - m) in index order, divides by the column sums and folds the
// 32^-0.5. The TPU kernel computes the full (C, C) product and masks the
// cross-head terms afterwards; they are never computed here. The stream and
// the merge are common.cuh's, shared with linattn_block.cu. The output pass
// owns whole rows: one warp holds 4 rows, so the row max and the per-head
// sums are warp reductions.
//
// Rounding follows the TPU kernel: k, v and q are widened to float on load,
// every intermediate stays float (exp(k - m), ctx, the normalised context,
// the q softmax), and only the output is cast to T.
//
// Bound on this card: memory. The function reads q, k, v and writes out
// once, 4 * b*n*C elements, against 4 * b*n*C*32 flops of head-diagonal
// products, about 64 flops per element moved: under the card's ridge. This
// version runs the products as float FMAs on the CUDA cores.
#include "common.cuh"

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

extern "C" int srgd_linear_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                          void* part_m, void* part_z, void* part_ctx, void* cn,
                                          int b, int n, int ld, int hidden, int rows_per_split,
                                          int nsplit, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, part_m, part_z, part_ctx, cn, b, n, ld, hidden,
                               rows_per_split, nsplit, stream);
}
