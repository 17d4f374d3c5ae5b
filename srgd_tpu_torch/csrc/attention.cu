// Softmax attention softmax(q k^T * d^-0.5) v for Hopper (sm_90a), d = 32.
//
// Replaces the Pallas TPU kernel srgd_tpu/kernels/attention.py
// (fused_attention, body _flash_kernel): q, k, v (b, heads, n, 32) -> the
// same shape, with an online softmax over key tiles so the (n, n) scores
// never reach device memory.
//
// Operands are addressed by strides (batch, head, row; the channel stride is
// 1), so q, k and v may be the transposed views of one (b, n, 3, heads, 32)
// projection, and the output is written with its own strides.
//
// Bound on this card: operations. At (8, 4, 1024, 32) in bfloat16 the four
// tensors are 8.4 MB but the two products are 4.3 GFLOP (from the shapes),
// and with d = 32 there is one exponential for every 64 multiply-adds, so the
// softmax, not the tensor cores, sets the pace of a good kernel.
//
// bfloat16 (flash_mma): the tensor cores, in the shape of FlashAttention-2.
// A block of 8 warps owns 128 queries of one (batch, head); each warp
// holds its 16 query rows as mma.sync A fragments in registers for the
// whole key loop. K and V tiles of 64 keys stay bf16 and come in through a
// three-stage ring of 16-byte cp.async copies, so the tile after next loads
// while this one is multiplied; rows are padded to 80 bytes, which keeps the
// ldmatrix loads free of bank conflicts. S = Q K^T is 16 mma.m16n8k16 a tile,
// the row max and sum are shuffles inside the quad that shares a row, the
// probabilities are rounded to bf16 in registers and reused as the A
// operand of P V (V read with ldmatrix.trans), and the scale and log2(e) are
// one multiply-add on the float scores ahead of ex2. Accumulators, m and l are
// float and the division by l comes last.
//
// Two rounding points differ from the TPU kernel, which widens everything to
// float: q is not scaled before the product (the bf16 q is an exact operand
// and the scale is applied to the float score), and p is rounded to bf16
// before P V (its row sum l is taken from the float p). Both are expected
// divergences inside the bf16 tolerance, not faults.
//
// float32 (flash): the exact path, float FMAs on the CUDA cores. One block
// per (batch * head, tile of 64 queries) streams 64-key tiles through shared
// memory; thread (ty, tx) of a 16 x 16 layout holds a 4 x 4 block of scores,
// q is scaled in float before the product and p is not rounded, as on the
// TPU.
#include "common.cuh"
#include "mma.cuh"

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

// ---- bfloat16: tensor cores ----------------------------------------------

constexpr int STAGES = 3;                      // K / V tiles in flight
constexpr int MMA_WARPS = 8;                   // warps per block, 16 queries each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int LDS = DH + PAD;                  // padded row of a K or V tile
constexpr float SCALE_LOG2E = SCALE * 1.4426950408889634f;

// Start the copy of keys k0 .. k0 + TK of K and V into one ring stage; rows
// past n are zero-filled.
__device__ __forceinline__ void load_kv_tile(bf16* ks, bf16* vs, const bf16* __restrict__ kb,
                                             const bf16* __restrict__ vb, long long skn,
                                             long long svn, int k0, int n) {
  constexpr int CHUNKS = TK * (DH / 8);  // 16-byte chunks of one tile
  for (int idx = threadIdx.x; idx < 2 * CHUNKS; idx += MMA_THREADS) {
    const int which = idx / CHUNKS, rem = idx - which * CHUNKS;
    const int j = rem >> 2, ch = rem & 3;
    const bool ok = k0 + j < n;
    const long long row = ok ? k0 + j : 0;
    if (which == 0)
      cp_async16(ks + j * LDS + ch * 8, kb + row * skn + ch * 8, ok);
    else
      cp_async16(vs + j * LDS + ch * 8, vb + row * svn + ch * 8, ok);
  }
}

__global__ void __launch_bounds__(MMA_THREADS)
flash_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          bf16* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int heads, int n) {
  __shared__ __align__(16) bf16 ks[STAGES][TK * LDS];  // [key][d]
  __shared__ __align__(16) bf16 vs[STAGES][TK * LDS];  // [key][d]

  const int bh = blockIdx.y, bi = bh / heads, hi = bh - bi * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* qb = q + bi * sq.b + hi * sq.h;
  const bf16* kb = k + bi * sk.b + hi * sk.h;
  const bf16* vb = v + bi * sv.b + hi * sv.h;
  const int ntiles = (n + TK - 1) / TK;

  load_kv_tile(ks[0], vs[0], kb, vb, sk.n, sv.n, 0, n);
  cp_async_commit();
  if (ntiles > 1) load_kv_tile(ks[1], vs[1], kb, vb, sk.n, sv.n, TK, n);
  cp_async_commit();

  // this warp's 16 query rows as the A fragments of both k-steps
  const int r_lo = blockIdx.x * (MMA_WARPS * 16) + warp * 16 + g, r_hi = r_lo + 8;
  uint32_t qa[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = s * 16 + 2 * t;
    const bf16* lo = qb + (long long)r_lo * sq.n + c;
    const bf16* hp = qb + (long long)r_hi * sq.n + c;
    qa[s][0] = r_lo < n ? *reinterpret_cast<const uint32_t*>(lo) : 0u;
    qa[s][1] = r_hi < n ? *reinterpret_cast<const uint32_t*>(hp) : 0u;
    qa[s][2] = r_lo < n ? *reinterpret_cast<const uint32_t*>(lo + 8) : 0u;
    qa[s][3] = r_hi < n ? *reinterpret_cast<const uint32_t*>(hp + 8) : 0u;
  }

  // rows r_lo (index 0) and r_hi (index 1); m is the max of the raw scores
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nb][j] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();  // tile it has landed (tile it + 1 may be in flight)
    __syncthreads();     // for every thread; and tile it - 1 is consumed
    if (it + 2 < ntiles)
      load_kv_tile(ks[(it + 2) % STAGES], vs[(it + 2) % STAGES], kb, vb, sk.n, sv.n,
                       (it + 2) * TK, n);
    cp_async_commit();
    const bf16* kt = ks[it % STAGES];
    const bf16* vt = vs[it % STAGES];

    // s = q k^T: 16 rows x 64 keys, block nb holds keys nb*8 + 2t..2t+1
    float s[TK / 8][4];
#pragma unroll
    for (int nb = 0; nb < TK / 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nb][j] = 0.f;
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int p = 0; p < TK / 16; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (p * 16 + bn_row(lane)) * LDS + st * 16 + bn_col(lane));
        mma_bf16(s[2 * p], qa[st], b[0], b[1]);
        mma_bf16(s[2 * p + 1], qa[st], b[2], b[3]);
      }

    const int k0 = it * TK;
    const bool ragged = k0 + TK > n;
    // the scale and log2(e) ride on the multiply-add that subtracts the max:
    // p = 2^(s * SCALE_LOG2E - m * SCALE_LOG2E), m the raw row max
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int nb = 0; nb < TK / 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ragged && k0 + nb * 8 + 2 * t + (j & 1) >= n) s[nb][j] = NEG;
        mt[j >> 1] = fmaxf(mt[j >> 1], s[nb][j]);
      }
    float al[2], ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float mn = fmaxf(m[h], mt[h]);
      al[h] = fast_exp2((m[h] - mn) * SCALE_LOG2E);
      m[h] = mn;
      ms[h] = mn * SCALE_LOG2E;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < TK / 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[nb][j] = fast_exp2(fmaf(s[nb][j], SCALE_LOG2E, -ms[j >> 1]));
        sum[j >> 1] += s[nb][j];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * al[h] + sum[h];  // this thread's columns only
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nb][j] *= al[j >> 1];

    // acc += p v, p rounded to bf16 in registers
#pragma unroll
    for (int st = 0; st < TK / 16; ++st) {
      uint32_t pa[4];
      frag_from_acc(pa, s[2 * st], s[2 * st + 1]);
#pragma unroll
      for (int p = 0; p < DH / 16; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (st * 16 + bt_row(lane)) * LDS + p * 16 + bt_col(lane));
        mma_bf16(acc[2 * p], pa, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  bf16* ob = o + bi * so.b + hi * so.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = h == 0 ? r_lo : r_hi;
    if (r >= n) continue;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
      *reinterpret_cast<uint32_t*>(ob + (long long)r * so.n + nb * 8 + 2 * t) =
          pack_bf16(acc[nb][2 * h] / l[h], acc[nb][2 * h + 1] / l[h]);
  }
}

int launch_mma(const void* q, const void* k, const void* v, void* o, const int* st, int b,
               int heads, int n, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  constexpr int ROWS = MMA_WARPS * 16;
  flash_mma<<<dim3((n + ROWS - 1) / ROWS, b * heads), MMA_THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, sk, sv, so, heads, n);
  return cudaGetLastError();
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

// The bfloat16 entry also needs 16-byte aligned base pointers and row strides
// that are multiples of 8 elements (q: of 2).
extern "C" int srgd_attention_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                   int heads, int n, int sqb, int sqh, int sqn, int skb, int skh,
                                   int skn, int svb, int svh, int svn, int sob, int soh, int son,
                                   void* stream) {
  const int st[12] = {sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son};
  return launch_mma(q, k, v, o, st, b, heads, n, stream);
}
