// Fused whole-block full attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srgd_tpu/kernels/attn_block.py
// (fused_attn_block, body _kernel): RMSNorm -> qkv 1x1 projection -> per
// head softmax(q k^T * dim_head^-0.5) v -> to_out 1x1 + bias.
//
// The TPU kernel holds one batch element's whole (n, n) float similarity
// matrix in VMEM (4 MB at n = 1024, from the shape), far over a block's
// shared memory. Here it is two launches: (1) RMSNorm + qkv projection, writing qkv (b, n, 384)
// once in T; (2) per (query tile of 32 rows, batch element): all heads with
// an online softmax over key tiles of 64, then P.V and to_out + bias, so no
// score ever reaches device memory. Softmax statistics are float; q, k, v,
// the probabilities and the attention output are rounded to T before their
// products, as _xla_attn_block rounds them (the probabilities before their
// division by the row sum, which the online softmax applies at the end).
#include "common.cuh"

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

}  // namespace

// x, out: (b, n, c) in T; g1s: gain * sqrt(c) and bout: (c,), float;
// wqkv: (c, 3*hidden), wout: (hidden, c) in T; qkv: (b, n, 3*hidden) scratch
// in T. Requires hidden % 32 == 0, hidden <= 128 and c <= 1024.
extern "C" int srgd_attn_block_f32(const void* x, const void* g1s, const void* wqkv,
                                   const void* wout, const void* bout, void* qkv, void* out, int b,
                                   int n, int c, int hidden, void* stream) {
  return launch<float>(x, g1s, wqkv, wout, bout, qkv, out, b, n, c, hidden, stream);
}

extern "C" int srgd_attn_block_bf16(const void* x, const void* g1s, const void* wqkv,
                                    const void* wout, const void* bout, void* qkv, void* out,
                                    int b, int n, int c, int hidden, void* stream) {
  return launch<__nv_bfloat16>(x, g1s, wqkv, wout, bout, qkv, out, b, n, c, hidden, stream);
}
