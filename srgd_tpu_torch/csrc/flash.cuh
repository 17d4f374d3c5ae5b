// The bfloat16 flash-attention loop on the tensor cores, d = 32, shared by
// attention.cu (kernel flash_mma) and attn_block.cu (kernel attn_block_flash,
// which runs it on strided views of its qkv scratch). Each file wraps it in a
// __global__ of its own name, so that a profile charges the time to the
// kernel that launched it.
//
// The shape is FlashAttention-2's: a block of 8 warps owns 128 queries of
// one (batch, head); each warp holds its 16 query rows as mma.sync A
// fragments in registers for the whole key loop. K and V tiles of 64 keys
// stay bf16 and come in through a three-stage ring of 16-byte cp.async copies,
// so the tile after next loads while this one is multiplied; rows are padded
// to 80 bytes, which keeps the ldmatrix loads free of bank conflicts.
// S = Q K^T is 16 mma.m16n8k16 a tile, the row max and sum are shuffles
// inside the quad that shares a row, the probabilities are rounded to bf16 in
// registers and reused as the A operand of P V (V read with ldmatrix.trans),
// and the scale and log2(e) are one multiply-add on the float scores ahead of
// ex2. Accumulators, m and l are float and the division by l comes last.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace srgd {

// Element strides of a (batch, head, row, 32) operand; the channel stride is 1.
struct Strides {
  long long b, h, n;
};

constexpr int FLASH_TK = 64;                       // keys per tile
constexpr int FLASH_STAGES = 3;                    // K / V tiles in flight
constexpr int FLASH_WARPS = 8;                     // warps per block, 16 queries each
constexpr int FLASH_THREADS = FLASH_WARPS * 32;
constexpr int FLASH_ROWS = FLASH_WARPS * 16;       // queries per block
constexpr int FLASH_LDS = DH + PAD;                // padded row of a K or V tile
constexpr float FLASH_SCALE_LOG2E = 0.17677669529663687f * 1.4426950408889634f;

// Start the copy of keys k0 .. k0 + FLASH_TK of K and V into one ring stage;
// rows past n are zero-filled.
__device__ __forceinline__ void flash_load_kv_tile(bf16* ks, bf16* vs, const bf16* __restrict__ kb,
                                                   const bf16* __restrict__ vb, long long skn,
                                                   long long svn, int k0, int n) {
  constexpr int CHUNKS = FLASH_TK * (DH / 8);  // 16-byte chunks of one tile
  for (int idx = threadIdx.x; idx < 2 * CHUNKS; idx += FLASH_THREADS) {
    const int which = idx / CHUNKS, rem = idx - which * CHUNKS;
    const int j = rem >> 2, ch = rem & 3;
    const bool ok = k0 + j < n;
    const long long row = ok ? k0 + j : 0;
    if (which == 0)
      cp_async16(ks + j * FLASH_LDS + ch * 8, kb + row * skn + ch * 8, ok);
    else
      cp_async16(vs + j * FLASH_LDS + ch * 8, vb + row * svn + ch * 8, ok);
  }
}

// The block (blockIdx.x: 128 queries, blockIdx.y: batch * heads + head) of
// o = softmax(q k^T * 32^-0.5) v. Needs 16-byte aligned k and v bases, row
// strides of k and v that are multiples of 8 elements and of q of 2; o is
// written in 4-byte pairs.
__device__ __forceinline__ void flash_mma_block(const bf16* __restrict__ q,
                                                const bf16* __restrict__ k,
                                                const bf16* __restrict__ v, bf16* __restrict__ o,
                                                Strides sq, Strides sk, Strides sv, Strides so,
                                                int heads, int n) {
  __shared__ __align__(16) bf16 ks[FLASH_STAGES][FLASH_TK * FLASH_LDS];  // [key][d]
  __shared__ __align__(16) bf16 vs[FLASH_STAGES][FLASH_TK * FLASH_LDS];  // [key][d]

  const int bh = blockIdx.y, bi = bh / heads, hi = bh - bi * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* qb = q + bi * sq.b + hi * sq.h;
  const bf16* kb = k + bi * sk.b + hi * sk.h;
  const bf16* vb = v + bi * sv.b + hi * sv.h;
  const int ntiles = (n + FLASH_TK - 1) / FLASH_TK;

  flash_load_kv_tile(ks[0], vs[0], kb, vb, sk.n, sv.n, 0, n);
  cp_async_commit();
  if (ntiles > 1) flash_load_kv_tile(ks[1], vs[1], kb, vb, sk.n, sv.n, FLASH_TK, n);
  cp_async_commit();

  // this warp's 16 query rows as the A fragments of both k-steps
  const int r_lo = blockIdx.x * FLASH_ROWS + warp * 16 + g, r_hi = r_lo + 8;
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
      flash_load_kv_tile(ks[(it + 2) % FLASH_STAGES], vs[(it + 2) % FLASH_STAGES], kb, vb, sk.n,
                         sv.n, (it + 2) * FLASH_TK, n);
    cp_async_commit();
    const bf16* kt = ks[it % FLASH_STAGES];
    const bf16* vt = vs[it % FLASH_STAGES];

    // s = q k^T: 16 rows x 64 keys, block nb holds keys nb*8 + 2t..2t+1
    float s[FLASH_TK / 8][4];
#pragma unroll
    for (int nb = 0; nb < FLASH_TK / 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nb][j] = 0.f;
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int p = 0; p < FLASH_TK / 16; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (p * 16 + bn_row(lane)) * FLASH_LDS + st * 16 + bn_col(lane));
        mma_bf16(s[2 * p], qa[st], b[0], b[1]);
        mma_bf16(s[2 * p + 1], qa[st], b[2], b[3]);
      }

    const int k0 = it * FLASH_TK;
    const bool ragged = k0 + FLASH_TK > n;
    // the scale and log2(e) ride on the multiply-add that subtracts the max:
    // p = 2^(s * SCALE_LOG2E - m * SCALE_LOG2E), m the raw row max
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int nb = 0; nb < FLASH_TK / 8; ++nb)
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
      al[h] = fast_exp2((m[h] - mn) * FLASH_SCALE_LOG2E);
      m[h] = mn;
      ms[h] = mn * FLASH_SCALE_LOG2E;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < FLASH_TK / 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[nb][j] = fast_exp2(fmaf(s[nb][j], FLASH_SCALE_LOG2E, -ms[j >> 1]));
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
    for (int st = 0; st < FLASH_TK / 16; ++st) {
      uint32_t pa[4];
      frag_from_acc(pa, s[2 * st], s[2 * st + 1]);
#pragma unroll
      for (int p = 0; p < DH / 16; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (st * 16 + bt_row(lane)) * FLASH_LDS + p * 16 + bt_col(lane));
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

// Grid of flash_mma_block for b batch entries and `heads` heads.
inline dim3 flash_grid(int b, int heads, int n) {
  return dim3((n + FLASH_ROWS - 1) / FLASH_ROWS, b * heads);
}

}  // namespace srgd
