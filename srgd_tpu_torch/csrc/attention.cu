// Softmax attention softmax(q k^T * d^-0.5) v for Hopper (sm_90a), d = 32.
//
// Replaces the Pallas TPU kernel srgd_tpu/kernels/attention.py
// (fused_attention, body _flash_kernel): q, k, v (b, heads, n, 32) -> the
// same shape, with an online softmax over key tiles so the (n, n) scores
// never reach device memory.
//
// One block per (batch * head, tile of 64 queries) streams 64-key tiles of K
// and V through shared memory. Thread (ty, tx) of a 16 x 16 layout holds a
// 4 x 4 block of the tile's scores in registers (queries ty*4+i, keys
// tx*4+j), so a row's max and sum are reductions over the 16 lanes of a
// half-warp. The probabilities go through shared memory once for P.V, where
// the same thread accumulates queries ty*4+i, channels tx*2 and tx*2+1. Q and
// K are kept transposed in shared memory so that every inner-loop read is a
// 16-byte vector that the half-warp reads without bank conflicts.
//
// Operands are addressed by strides (batch, head, row; the channel stride is
// 1), so q, k and v may be the transposed views of one (b, n, 3, heads, 32)
// projection, and the output is written with its own strides.
//
// Rounding follows the TPU kernel: q is scaled in float before the product,
// the probabilities are not rounded before P.V, accumulation is float and
// the division by the row sum comes last; only the output is cast to T.
//
// Bound on this card: operations. At (8, 4, 1024, 32) in bfloat16 the four
// tensors are 8.4 MB but the two products are 4.3 GFLOP (from the shapes).
// This version runs them as float FMAs on the CUDA cores.
#include "common.cuh"

using namespace srgd;

namespace {

constexpr float SCALE = 0.17677669529663687f;  // 32 ** -0.5
constexpr int TQ = 64;                         // queries per block
constexpr int TK = 64;                         // keys per tile
constexpr int LDT = TK + 4;                    // padded row of the transposed tiles and of P

struct Strides {
  long long b, h, n;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
      Strides sq, Strides sk, Strides sv, Strides so, int heads, int n) {
  __shared__ __align__(16) float qT[DH * LDT];  // [d][query], scaled
  __shared__ __align__(16) float kT[DH * LDT];  // [d][key]
  __shared__ __align__(16) float vs[TK * DH];   // [key][d]
  __shared__ __align__(16) float ps[TQ * LDT];  // [query][key]

  const int bh = blockIdx.y, bi = bh / heads, hi = bh - bi * heads;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + bi * sq.b + hi * sq.h;
  const T* kb = k + bi * sk.b + hi * sk.h;
  const T* vb = v + bi * sv.b + hi * sv.h;

  for (int idx = tid; idx < TQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx - r * DH;
    qT[d * LDT + r] = q0 + r < n ? to_f32<T>(qb[(q0 + r) * sq.n + d]) * SCALE : 0.f;
  }

  float m[4], l[4], acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < TK * DH; idx += THREADS) {
      const int j = idx / DH, d = idx - j * DH;
      const bool ok = k0 + j < n;
      kT[d * LDT + j] = ok ? to_f32<T>(kb[(k0 + j) * sk.n + d]) : 0.f;
      vs[idx] = ok ? to_f32<T>(vb[(k0 + j) * sv.n + d]) : 0.f;
    }
    __syncthreads();

    // s[i][j] = q[ty*4+i] . k[tx*4+j]
    float s[4][4];
    zero(s);
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qT + d * LDT + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(kT + d * LDT + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // online softmax per query row, reduced over the half-warp's 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx * 4 + j >= n) s[i][j] = NEG;  // keys past the end
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(m[i], mt);
      const float al = expf(m[i] - mn);
      float sum = 0.f;
      float4 p;
      p.x = expf(s[i][0] - mn);
      p.y = expf(s[i][1] - mn);
      p.z = expf(s[i][2] - mn);
      p.w = expf(s[i][3] - mn);
      sum = (p.x + p.y) + (p.z + p.w);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * LDT + tx * 4) = p;
      l[i] = l[i] * al + sum;
      m[i] = mn;
      acc[i][0] *= al;
      acc[i][1] *= al;
    }
    __syncthreads();

    // acc[i][e] += sum_j p[ty*4+i][j] * v[j][tx*2+e]
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      const float2 vv = *reinterpret_cast<const float2*>(vs + j * DH + tx * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = ps[(ty * 4 + i) * LDT + j];
        acc[i][0] = fmaf(pv, vv.x, acc[i][0]);
        acc[i][1] = fmaf(pv, vv.y, acc[i][1]);
      }
    }
  }

  T* ob = o + bi * so.b + hi * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= n) continue;
    ob[r * so.n + tx * 2] = from_f32<T>(acc[i][0] / l[i]);
    ob[r * so.n + tx * 2 + 1] = from_f32<T>(acc[i][1] / l[i]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const int* st, int b, int heads,
           int n, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  flash<T><<<dim3((n + TQ - 1) / TQ, b * heads), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, heads, n);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (b, heads, n, 32) in T with channel stride 1 and the element
// strides (batch, head, row) sqb ... son of each operand.
extern "C" int srgd_attention_f32(const void* q, const void* k, const void* v, void* o, int b,
                                  int heads, int n, int sqb, int sqh, int sqn, int skb, int skh,
                                  int skn, int svb, int svh, int svn, int sob, int soh, int son,
                                  void* stream) {
  const int st[12] = {sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son};
  return launch<float>(q, k, v, o, st, b, heads, n, stream);
}

extern "C" int srgd_attention_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                   int heads, int n, int sqb, int sqh, int sqn, int skb, int skh,
                                   int skn, int svb, int svh, int svn, int sob, int soh, int son,
                                   void* stream) {
  const int st[12] = {sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son};
  return launch<__nv_bfloat16>(q, k, v, o, st, b, heads, n, stream);
}
