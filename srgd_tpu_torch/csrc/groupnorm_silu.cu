// GroupNorm + optional FiLM + SiLU for Hopper (sm_90a), in one launch.
//
// Replaces the Pallas TPU kernel srgd_tpu/kernels/groupnorm_silu.py
// (fused_groupnorm_silu, bodies _stats_kernel and _scale_shift_silu_kernel):
//   y = GroupNorm(x; groups, eps) * gamma + beta
//   y = y * (film_scale + 1) + film_shift        (when film is given)
//   out = y * sigmoid(y)
// on x (b, rows, c) with the channel as the fast axis, which is what an NCHW
// tensor in channels_last memory is.
//
// Bound on this card: memory. The function reads x once and writes the
// output once; there is no product. The TPU kernel runs two passes over x
// (statistics, then normalise) with an O(b c) fold between them. Here both
// passes and the fold are one launch, and x comes from device memory once
// wherever the samples in flight fit in the 50 MB L2:
//
// - Work items. Each sample's rows are cut into `ntile` tiles of `tile_rows`
//   rows; every tile is a statistics item and an apply item. Persistent
//   blocks, two an SM, take items by ticket from one atomic counter, in one
//   fixed global order (item_of): the apply tiles run `lead` tiles behind the
//   statistics tiles, in turns with them. `lead` is at least a sample's tiles
//   (so a sample's statistics precede its apply) and, where a sample allows,
//   no more than half the L2 holds, so a sample's apply reads its x from the
//   L2, and the blocks are busy with later statistics while a sample folds.
// - No deadlock, no cooperative launch. Every statistics ticket of a sample
//   is smaller than every apply ticket of it, statistics items never wait,
//   and a block holds only its current item and the next ticket it drew
//   (which is larger). The smallest ticket not yet done is therefore always
//   a block's current item and can finish: an apply item waits only on
//   smaller tickets. That holds whether or not the grid is co-resident
//   (behind the previous conv). A broken order would hang: a waiting block
//   traps after SPIN_LIMIT polls instead.
// - Deterministic. A statistics item writes its own partial (2, groups):
//   per-channel sums over its rows (rows in a fixed order per thread, the
//   row lanes added in lane order), then each group's channels added in a
//   fixed order. The block that retires a sample's last statistics tile (a
//   per-sample arrival counter, an acq_rel atomic) adds the partials in tile
//   order into the group mean and 1 / sqrt(E[x^2] - mean^2 + eps) in float,
//   merges them with the GroupNorm affine and the FiLM into one (scale,
//   shift) per channel and publishes that with a release store of the call's
//   generation number into the sample's flag. No floating-point atomics: the
//   result does not depend on the schedule, and the fold reads 2 groups
//   floats a tile, so it is short.
// - No second launch. The counters live in a small per-stream state buffer:
//   the folding block zeroes its arrival counter, the last block to leave
//   zeroes the ticket and exit counters, and flags hold a generation number
//   that the wrapper bumps every call, so they need no reset.
// - Caching hints: statistics loads carry an L2 evict_last policy, apply
//   loads (x's last use) and output stores stream (.cs), so the output does
//   not push x out of the L2. Loads are 16-byte vectors over consecutive
//   channels wherever c allows (VEC elements; else one element at a time),
//   UNROLL rows of them in flight per thread. The data go to registers;
//   staging tiles in shared memory by bulk copies (a three-stage ring, one
//   block an SM) measured slower: a block waiting on a flag idles its SM.
#include "common.cuh"

#include <cstdint>
#include <cstring>

using namespace srgd;

namespace {

constexpr int UNROLL = 8;             // 16-byte loads in flight per thread
constexpr int FOLD_LOADS = 16;        // partial loads in flight per thread of the fold
constexpr int SPIN_LIMIT = 1 << 26;   // polls of a flag before the kernel traps

template <typename T, int VEC> struct Pack;
template <> struct alignas(16) Pack<float, 4> { float v[4]; };
template <> struct alignas(16) Pack<__nv_bfloat16, 8> { __nv_bfloat16 v[8]; };
template <> struct Pack<float, 1> { float v[1]; };
template <> struct Pack<__nv_bfloat16, 1> { __nv_bfloat16 v[1]; };

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// x for the statistics: kept in the L2 for the apply that follows.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_keep(const Pack<T, VEC>* p, uint64_t policy) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    uint4 v;
    asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p), "l"(policy));
    Pack<T, VEC> r;
    memcpy(&r, &v, 16);
    return r;
  } else {
    return *p;
  }
}

// x for the apply: its last use.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_last(const Pack<T, VEC>* p) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    Pack<T, VEC> r;
    memcpy(&r, &v, 16);
    return r;
  } else {
    return *p;
  }
}

// The output: streamed, so it does not push x out of the L2.
template <typename T, int VEC>
__device__ __forceinline__ void store_stream(Pack<T, VEC>* p, const Pack<T, VEC>& o) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    uint4 v;
    memcpy(&v, &o, 16);
    __stcs(reinterpret_cast<uint4*>(p), v);
  } else {
    *p = o;
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The work item of ticket t: apply (0 statistics, 1 apply), sample, tile.
// Statistics tiles S_i and apply tiles A_i are numbered over all samples
// (i = sample * ntile + tile). The order: S_0 .. S_{lead-1}, then A_0,
// S_lead, A_1, S_{lead+1}, ... in turns until the S_i run out, then the
// remaining A_i. A_i comes after S_{lead+i-1}, so with lead >= ntile every
// statistics tile of a sample precedes its first apply tile. The same order
// as srgd_tpu_torch/kernels/groupnorm_silu.py:_item, which the CPU tests
// check.
__device__ __forceinline__ void item_of(int t, int b, int ntile, int lead, int& apply, int& s,
                                        int& tile) {
  const int ns = b * ntile;
  int i;
  if (t < lead) {
    apply = 0, i = t;
  } else {
    const int j = t - lead, m = ns - lead;
    if (j < 2 * m) {
      apply = j & 1 ? 0 : 1;
      i = apply ? j / 2 : lead + j / 2;
    } else {
      apply = 1, i = j - m;
    }
  }
  s = i / ntile, tile = i - s * ntile;
}

// One statistics tile: out[0][g] = sum over rows [r0, r1) of the sample
// (xs) and the channels of group g of x, out[1][g] of x^2. The block's
// threads form a (ty, tx) layout of cols = min(c / VEC, THREADS) vector
// columns by lanes = THREADS / cols row lanes, each lane UNROLL rows apart
// in flight; the lanes' per-channel sums meet in red (2 * lanes * cols * VEC
// floats) and are added in lane order into chsum (2 c floats); then one warp
// a value adds a group's channels (lanes strided over them, a fixed
// butterfly across the warp).
template <typename T, int VEC>
__device__ __forceinline__ void stats_tile(const Pack<T, VEC>* __restrict__ xs,
                                           float* __restrict__ out, float* red, float* chsum,
                                           int r0, int r1, int c, int groups, uint64_t policy) {
  const int cv = c / VEC;
  const int cols = min(cv, THREADS);
  const int lanes = THREADS / cols;
  const int tx = threadIdx.x % cols, ty = threadIdx.x / cols;
  for (int col0 = 0; col0 < cv; col0 += cols) {
    const int col = col0 + tx;
    float s[VEC], ss[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = ss[e] = 0.f;
    if (ty < lanes && col < cv) {
      int r = r0 + ty;
      for (; r + (UNROLL - 1) * lanes < r1; r += UNROLL * lanes) {
        Pack<T, VEC> p[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          p[u] = load_keep(xs + (size_t)(r + u * lanes) * cv + col, policy);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float f = to_f32<T>(p[u].v[e]);
            s[e] += f;
            ss[e] = fmaf(f, f, ss[e]);
          }
      }
      for (; r < r1; r += lanes) {
        const Pack<T, VEC> p = load_keep(xs + (size_t)r * cv + col, policy);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f32<T>(p.v[e]);
          s[e] += f;
          ss[e] = fmaf(f, f, ss[e]);
        }
      }
    }
    if (lanes == 1) {  // one row lane: the thread's sums are the channel's
      if (col < cv) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          chsum[col * VEC + e] = s[e];
          chsum[c + col * VEC + e] = ss[e];
        }
      }
      continue;
    }
    __syncthreads();  // the previous column group's sums are read out
    if (ty < lanes) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        red[(ty * cols + tx) * VEC + e] = s[e];
        red[((lanes + ty) * cols + tx) * VEC + e] = ss[e];
      }
    }
    __syncthreads();
    // every thread adds the lanes of one value (sum or sum of squares of one
    // channel), in lane order
    const int width = cols * VEC;
    for (int idx = threadIdx.x; idx < 2 * width; idx += THREADS) {
      const int which = idx / width, rem = idx - which * width;
      if (col0 * VEC + rem < c) {
        float a = 0.f;
        for (int k = 0; k < lanes; ++k) a += red[(which * lanes + k) * width + rem];
        chsum[which * c + col0 * VEC + rem] = a;
      }
    }
  }
  __syncthreads();  // every channel's sums are in chsum
  const int cg = c / groups, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int v = warp; v < 2 * groups; v += THREADS / 32) {
    const float* src = chsum + (v >= groups ? c : 0) + (v % groups) * cg;
    float a = 0.f;
    for (int j = lane; j < cg; j += 32) a += src[j];
    a = warp_sum(a);
    if (lane == 0) out[v] = a;
  }
}

// The fold of sample s, by the block that retired its last statistics tile:
// from the partials ps (ntile x 2 groups floats), added in tile order (nsub
// sub-lanes per value each add every nsub-th tile, and the sub-lanes' sums
// are added in sub-lane order), the group mean and 1 / sqrt(var + eps), then
// ss[0][ch] = scale, ss[1][ch] = shift with
//   scale = inv_g * gamma, shift = beta - mean_g * scale, then with FiLM
//   scale *= fs + 1, shift = shift * (fs + 1) + fb
// (FiLM read in its own dtype and widened in registers: no cast launch).
// sm: nsub * 2 groups floats (nsub > 1) and 2 groups more for the sums.
__device__ __forceinline__ float film_at(const void* film, int film_bf16, size_t i) {
  return film_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(film)[i])
                   : static_cast<const float*>(film)[i];
}

__device__ __forceinline__ void fold(const float* __restrict__ ps, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, const void* film,
                                     int film_bf16, float* __restrict__ ss, float* sm, int s,
                                     int rows, int c, int groups, int ntile, float eps) {
  const int nv = 2 * groups;
  const int nsub = max(1, THREADS / nv);
  float* sub_sums = sm;
  float* sums = nsub > 1 ? sm + nsub * nv : sm;
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {  // needed after the sums
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(gamma + ch));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(beta + ch));
  }
  for (int idx = threadIdx.x; idx < nv * nsub; idx += THREADS) {
    const int v = idx % nv, sub = idx / nv;
    float a = 0.f;
    int k = sub;
    for (; k + (FOLD_LOADS - 1) * nsub < ntile; k += FOLD_LOADS * nsub) {
      float t[FOLD_LOADS];
#pragma unroll
      for (int u = 0; u < FOLD_LOADS; ++u) t[u] = __ldcg(ps + (size_t)(k + u * nsub) * nv + v);
#pragma unroll
      for (int u = 0; u < FOLD_LOADS; ++u) a += t[u];
    }
    for (; k < ntile; k += nsub) a += __ldcg(ps + (size_t)k * nv + v);
    sub_sums[sub * nv + v] = a;
  }
  if (nsub > 1) {
    __syncthreads();
    for (int v = threadIdx.x; v < nv; v += THREADS) {
      float a = 0.f;
      for (int sub = 0; sub < nsub; ++sub) a += sub_sums[sub * nv + v];
      sums[v] = a;
    }
  }
  __syncthreads();
  const int cg = c / groups;
  const float count = (float)rows * (float)cg;
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    const int g = ch / cg;
    // rounding pinned by the _rn intrinsics: the compiler may not contract
    // them differently on the two FiLM dtypes' paths
    const float mean = __fdiv_rn(sums[g], count);
    const float var = __fsub_rn(__fdiv_rn(sums[groups + g], count), __fmul_rn(mean, mean));
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    float scale = __fmul_rn(inv, gamma[ch]);
    float shift = __fsub_rn(beta[ch], __fmul_rn(mean, scale));
    if (film != nullptr) {
      const size_t i0 = (size_t)s * 2 * c + ch;
      const float fs = __fadd_rn(film_at(film, film_bf16, i0), 1.0f);
      const float fb = film_at(film, film_bf16, i0 + c);
      scale = __fmul_rn(scale, fs);
      shift = __fadd_rn(__fmul_rn(shift, fs), fb);
    }
    ss[ch] = scale;
    ss[c + ch] = shift;
  }
}

// One apply tile: out = silu(x * scale[ch] + shift[ch]) over rows [r0, r1)
// of the sample (xs in, os out), the (ty, tx) layout of stats_tile, so each
// thread's channels and their (scale, shift) stay fixed over the tile.
template <typename T, int VEC>
__device__ __forceinline__ void apply_tile(const Pack<T, VEC>* __restrict__ xs,
                                           const float* __restrict__ sb,
                                           Pack<T, VEC>* __restrict__ os, int r0, int r1, int c) {
  const int cv = c / VEC;
  const int cols = min(cv, THREADS);
  const int lanes = THREADS / cols;
  const int tx = threadIdx.x % cols, ty = threadIdx.x / cols;
  if (ty >= lanes) return;
  for (int col = tx; col < cv; col += cols) {
    // written by another block in this launch: from the L2
    float sc[VEC], sh[VEC];
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(sb + col * VEC + e));
        const float4 d = __ldcg(reinterpret_cast<const float4*>(sb + c + col * VEC + e));
        sc[e] = a.x, sc[e + 1] = a.y, sc[e + 2] = a.z, sc[e + 3] = a.w;
        sh[e] = d.x, sh[e + 1] = d.y, sh[e + 2] = d.z, sh[e + 3] = d.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sc[e] = __ldcg(sb + col * VEC + e);
        sh[e] = __ldcg(sb + c + col * VEC + e);
      }
    }
    auto one = [&](const Pack<T, VEC>& p, Pack<T, VEC>* dst) {
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float y = fmaf(to_f32<T>(p.v[e]), sc[e], sh[e]);
        o.v[e] = from_f32<T>(__fdividef(y, 1.0f + __expf(-y)));
      }
      store_stream(dst, o);
    };
    int r = r0 + ty;
    for (; r + (UNROLL - 1) * lanes < r1; r += UNROLL * lanes) {
      Pack<T, VEC> p[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) p[u] = load_last(xs + (size_t)(r + u * lanes) * cv + col);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) one(p[u], os + (size_t)(r + u * lanes) * cv + col);
    }
    for (; r < r1; r += lanes) one(load_last(xs + (size_t)r * cv + col), os + (size_t)r * cv + col);
  }
}

// Shared memory of a block, in floats: the row lanes' sums (none with one
// lane) and the per-channel sums of a statistics tile; the fold reuses it.
__host__ __device__ __forceinline__ int red_floats(int c, int vec) {
  const int cols = min(c / vec, THREADS), lanes = THREADS / cols;
  return lanes > 1 ? 2 * lanes * cols * vec : 0;
}

__host__ __device__ __forceinline__ int smem_floats(int c, int groups, int vec) {
  const int nv = 2 * groups, nsub = max(1, THREADS / nv);
  return max(red_floats(c, vec) + 2 * c, nsub > 1 ? (nsub + 1) * nv : nv);
}

// state: [0] ticket, [1] blocks that left, [2, 2 + cap) arrival counters,
// [2 + cap, 2 + 2 cap) ready flags (the generation number of the call that
// last folded the sample). part: (b, ntile, 2, groups) floats; ss: (b, 2, c)
// floats (scale, shift). A block holds its current item and the next ticket,
// drawn at the start of the item and read at its end, so the draw's latency
// falls inside the item.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
groupnorm_silu_fused(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const void* film, float* __restrict__ part,
                     float* __restrict__ ss, T* __restrict__ out, int* state, int b, int rows,
                     int c, int groups, int tile_rows, int ntile, int lead, int gen, int cap,
                     int film_bf16, float eps) {
  extern __shared__ float sm[];
  __shared__ int s_next, s_last;
  int* ticket = state;
  int* left = state + 1;
  int* arrive = state + 2;
  int* flag = state + 2 + cap;
  const int total = 2 * b * ntile;
  const int cv = c / VEC, nv = 2 * groups;
  float* chsum = sm + red_floats(c, VEC);
  const uint64_t policy = evict_last_policy();
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x);
  Pack<T, VEC>* ov = reinterpret_cast<Pack<T, VEC>*>(out);

  if (threadIdx.x == 0) s_next = atomicAdd(ticket, 1);
  __syncthreads();
  int cur = s_next;
  while (cur < total) {
    __syncthreads();  // every thread has read s_next
    int next = 0;
    if (threadIdx.x == 0) next = atomicAdd(ticket, 1);
    int apply, s, tile;
    item_of(cur, b, ntile, lead, apply, s, tile);
    const int r0 = tile * tile_rows, r1 = min(r0 + tile_rows, rows);
    const size_t base = (size_t)s * rows * cv;
    if (!apply) {
      stats_tile<T, VEC>(xv + base, part + ((size_t)s * ntile + tile) * nv, sm, chsum, r0, r1, c,
                         groups, policy);
      __syncthreads();  // the partial is written
      if (threadIdx.x == 0)  // release: the partial; acquire: the others', if last
        s_last = atom_add_acq_rel(arrive + s, 1) == ntile - 1;
      __syncthreads();
      if (s_last) {
        fold(part + (size_t)s * ntile * nv, gamma, beta, film, film_bf16, ss + (size_t)s * 2 * c,
             sm, s, rows, c, groups, ntile, eps);
        __syncthreads();  // (scale, shift) written by every thread
        if (threadIdx.x == 0) {  // the release orders the block's writes before it
          arrive[s] = 0;
          st_release(flag + s, gen);
        }
      }
    } else {
      if (threadIdx.x == 0) {
        int spins = 0;
        while (ld_acquire(flag + s) != gen) {
          __nanosleep(64);
          if (++spins > SPIN_LIMIT) __trap();  // a broken order would hang: fail instead
        }
      }
      __syncthreads();
      apply_tile<T, VEC>(xv + base, ss + (size_t)s * 2 * c, ov + base, r0, r1, c);
    }
    if (threadIdx.x == 0) s_next = next;
    __syncthreads();
    cur = s_next;
  }
  if (threadIdx.x == 0 && atomicAdd(left, 1) == (int)gridDim.x - 1) {
    // every block has drawn its last ticket: ready for the next call
    atomicExch(ticket, 0);
    atomicExch(left, 0);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* gamma, const void* beta, const void* film, void* part,
           void* ss, void* out, void* state, int b, int rows, int c, int groups, int tile_rows,
           int ntile, int lead, int grid, int gen, int cap, int film_bf16, float eps,
           void* stream) {
  groupnorm_silu_fused<T, VEC><<<grid, THREADS, sizeof(float) * smem_floats(c, groups, VEC),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), film, static_cast<float*>(part), static_cast<float*>(ss),
      static_cast<T*>(out), static_cast<int*>(state), b, rows, c, groups, tile_rows, ntile, lead,
      gen, cap, film_bf16, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, rows, c) contiguous in T; gamma, beta: (c,) float; film: null
// or (b, 2, c) contiguous, float or (film_bf16 != 0) bfloat16 ([:, 0] scale,
// [:, 1] shift). Scratch (float): part (b, ntile, 2, groups), ss (b, 2, c).
// state: 2 + 2 * cap ints, zero before the first call on a stream and left
// so by every call; cap >= b; gen differs from the previous call's.
// vectorised != 0 needs c % 4 == 0 (float) or c % 8 == 0 (bfloat16) and x,
// out 16-byte aligned. Requires c % groups == 0, c <= 4096,
// rows * c < 2^31, ntile * tile_rows >= rows > (ntile - 1) * tile_rows,
// ntile <= lead <= b * ntile and 2 * b * ntile < 2^31.
extern "C" int srgd_groupnorm_silu_f32(const void* x, const void* gamma, const void* beta,
                                       const void* film, void* part, void* ss, void* out,
                                       void* state, int b, int rows, int c, int groups,
                                       int tile_rows, int ntile, int lead, int grid, int gen,
                                       int cap, int film_bf16, int vectorised, float eps,
                                       void* stream) {
  return vectorised ? launch<float, 4>(x, gamma, beta, film, part, ss, out, state, b, rows, c,
                                       groups, tile_rows, ntile, lead, grid, gen, cap, film_bf16,
                                       eps, stream)
                    : launch<float, 1>(x, gamma, beta, film, part, ss, out, state, b, rows, c,
                                       groups, tile_rows, ntile, lead, grid, gen, cap, film_bf16,
                                       eps, stream);
}

extern "C" int srgd_groupnorm_silu_bf16(const void* x, const void* gamma, const void* beta,
                                        const void* film, void* part, void* ss, void* out,
                                        void* state, int b, int rows, int c, int groups,
                                        int tile_rows, int ntile, int lead, int grid, int gen,
                                        int cap, int film_bf16, int vectorised, float eps,
                                        void* stream) {
  using bf16 = __nv_bfloat16;
  return vectorised ? launch<bf16, 8>(x, gamma, beta, film, part, ss, out, state, b, rows, c,
                                      groups, tile_rows, ntile, lead, grid, gen, cap, film_bf16,
                                      eps, stream)
                    : launch<bf16, 1>(x, gamma, beta, film, part, ss, out, state, b, rows, c,
                                      groups, tile_rows, ntile, lead, grid, gen, cap, film_bf16,
                                      eps, stream);
}
