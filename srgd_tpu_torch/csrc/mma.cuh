// Tensor-core building blocks for the bfloat16 kernels (sm_80 and later; the
// library is built for sm_90a): 16-byte asynchronous copies into shared
// memory, ldmatrix fragment loads, the mma.sync m16n8k16 bf16 product with
// float accumulation and, for sm_90a, the warpgroup product wgmma m64n64k16
// with its shared-memory descriptors and fences.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1)      a1 = (g + 8, 2t..2t+1)
//                           a2 = (g, 2t+8..2t+9)    a3 = (g + 8, 2t+8..2t+9)
//   B (16 x 8):             b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, float):      c0, c1 = (g, 2t..2t+1)  c2, c3 = (g + 8, 2t..2t+1)
// So two neighbouring C blocks (16 columns), rounded to bf16, are the A
// fragment of the next product without leaving the registers (frag_from_acc).
//
// Shared-memory tiles that ldmatrix reads are row-major bf16 with rows padded
// by 8 elements (16 bytes): the eight 16-byte rows of one 8 x 8 block then
// fall into eight different bank groups whenever the unpadded row is a
// multiple of 64 bytes, so the loads are free of bank conflicts without a
// swizzle. The tiles that wgmma reads have their own layout, further down.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace srgd {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;  // bf16 elements of padding on every shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with valid == false
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid = true) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 blocks; lane i gives the address of row i % 8 of block
// i / 8 and receives, of block j, the pair (row g, columns 2t..2t+1) in r[j].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same with each block transposed on the way: r[j] is the pair
// (rows 2t..2t+1, column g) of the stored block j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16 x 8, float) += a (16 x 16, bf16) x b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx: 2 ulp, denormals flushed);
// 0 for x far below the float range, which the online softmaxes rely on.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to nearest even into one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The low and high bf16 of a register, widened to float.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The A fragment of 16 columns held as two neighbouring accumulator blocks.
__device__ __forceinline__ void frag_from_acc(uint32_t (&a)[4], const float (&c0)[4],
                                              const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Addresses a lane hands to ldmatrix_x4 / ldmatrix_x4_trans for the two
// 8-wide B blocks of one k-step, as (row, column) offsets inside a row-major
// tile; r[0], r[1] are b0, b1 of the first block, r[2], r[3] of the second.
// B stored [k][n] (V, the context): transposed load at (bt_row, bt_col).
// B stored [n][k] (K): plain load at (bn_row, bn_col).
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) << 3; }

// ---------------------------------------------------------------------------
// wgmma (sm_90a): one warpgroup (4 warps) multiplies a 64-row tile; operands
// come from shared memory through 64-bit descriptors, A also from registers.
//
// Shared-memory operand layout used here (no swizzle): a tile is cut into
// lines of 8 elements (16 bytes). For an operand stored with K contiguous
// ("K-major": y[row][k], v^T[e][row]) a line is 8 k of one row, and the
// tile is stored chunk by chunk of 8 k: element (r, k) lies at
//   (k / 8) * stride + r * 8 + k % 8           (elements)
// For an operand stored with M or N contiguous ("MN-major": W[k][n]) a line
// is 8 n of one k, and the tile is stored chunk by chunk of 8 n: element
// (k, n) lies at
//   (n / 8) * stride + k * 8 + n % 8
// with stride = chunk_stride(lines in a chunk): the lines of a chunk are
// contiguous (the hardware's 8 x 16-byte core matrices are then 128
// contiguous bytes) and one spare line keeps 16-byte stores of neighbouring
// chunks out of each other's banks. In the descriptor the "leading" offset is
// the distance between the two 8-k halves of a k16 step and the "stride"
// offset the distance between 8-row (or 8-n) groups: (stride, 128 bytes) for
// K-major and (128 bytes, stride) for MN-major. Verified on an H100 against a
// float matmul for SS K-major x MN-major, SS MN-major x K-major and RS x
// K-major before the kernels were built on it.
//
// The accumulator of m64n64k16 is float d[8][4]: warp w of the warpgroup
// holds rows 16 w .. 16 w + 15 in the C layout of mma.m16n8k16 above (block
// nb = columns 8 nb .. 8 nb + 7), and a register A operand is that warp's
// m16k16 A fragment, so frag_from_acc chains two products here too.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int chunk_stride(int lines) { return lines * 8 + 8; }

// lbo, sbo: leading and stride offsets in elements.
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fff) | (uint64_t)((lbo >> 3) & 0x3fff) << 16 |
         (uint64_t)((sbo >> 3) & 0x3fff) << 32;
}
__device__ __forceinline__ uint64_t desc_k_major(const bf16* p, int stride) {
  return smem_desc(p, stride, 64);
}
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* p, int stride) {
  return smem_desc(p, 64, stride);
}

#define SRGD_ACC32(d)                                                                            \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),      \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),  \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),  \
      "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),  \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),  \
      "+f"(d[7][2]), "+f"(d[7][3])
#define SRGD_REGS32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "  \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64) = a (64 x 16) b (16 x 64) + (acc ? d : 0), both operands in
// shared memory; TA / TB = 1 for an MN-major operand, 0 for K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SRGD_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SRGD_ACC32(d)
      : "l"(da), "l"(db), "r"((int)acc), "n"(TA), "n"(TB));
}

// The same with a in registers (this warp's 16 x 16 A fragment).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                         bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SRGD_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SRGD_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"((int)acc), "n"(TB));
}

// Before the first wgmma after its registers or shared memory were written.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait for every committed wgmma of this warpgroup: accumulators readable,
// operands in shared memory free.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes this thread's ordinary shared-memory stores visible to wgmma, which
// reads through the asynchronous proxy; a barrier follows it.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier over the 128 threads of warpgroup wg, 0 or 1 (barrier 0 is
// __syncthreads; the ids are literals so that the block holds three barriers
// and not all sixteen).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// int8 on sm_90a: wgmma m64n256k32 s8 x s8 -> s32 from shared memory, the
// 128-byte-swizzled layout TMA writes, mbarriers and TMA tile loads.
//
// The s8 forms of wgmma take both operands K-major only: a tile is rows of
// 128 bytes of K (one swizzle row), stored 128 bytes apart, and TMA with
// CU_TENSOR_MAP_SWIZZLE_128B writes 16-byte piece j of row r at piece
// j ^ (r % 8) of its row; the tile's base is 1024-byte aligned. Its
// descriptor: start address, leading offset unused (1), stride offset 1024
// bytes (eight rows), layout 1 (128-byte swizzle). A k32 step inside the
// 128-byte row adds 32 bytes to the start address: the hardware applies the
// swizzle to the address it forms, as TMA did.
//
// The accumulator of m64n256k32 is int d[128]: warp w of the warpgroup holds
// rows 16 w + g and 16 w + g + 8 (g = lane / 4, t = lane % 4) as
// d[4 nb + 0, 1] = (row 16 w + g, columns 8 nb + 2t, 8 nb + 2t + 1) and
// d[4 nb + 2, 3] = (row 16 w + g + 8, the same columns), nb = 0 .. 31: the
// C layout of mma.m16n8k16 above, block by block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

#define SRGD_S32X128(d)                                                                          \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),            \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),    \
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),              \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),              \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),              \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),              \
      "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),              \
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),              \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),              \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),              \
      "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),              \
      "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),              \
      "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),              \
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),              \
      "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),              \
      "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),              \
      "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),          \
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),        \
      "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),        \
      "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),        \
      "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
#define SRGD_REGS128                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "             \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "             \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "             \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "       \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "   \
  "%126, %127}"

// d (64 x 256, int32) = a (64 x 32, s8) b (32 x 256, s8) + (acc ? d : 0),
// both operands K-major in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " SRGD_REGS128 ", %128, %129, p;\n}\n"
      : SRGD_S32X128(d)
      : "l"(da), "l"(db), "r"((int)acc));
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N> __device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers per thread for every warp of a warpgroup (a multiple of 8 in
// [24, 256]): the producer gives its registers up, the consumers take them.
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// mbarriers (64-bit, in shared memory).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A barrier that is
// never completed traps after about 2^28 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 28)) __trap();
  }
}

// TMA tile loads into shared memory, completing on `bar`'s transactions;
// coordinates are elements, innermost first, and may lie outside the tensor
// (those elements are written as zero). tmap: the address of a
// __grid_constant__ CUtensorMap kernel parameter.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// klen x (8 nchunks) of a dense global matrix w (rows wcols long), from row
// k0 and column 8 nch0, into an MN-major tile whose chunks are cs elements
// apart, by all THREADS_ threads. Consecutive threads take consecutive
// 16-byte pieces of a row, so the global reads are contiguous; in shared
// memory they land in neighbouring chunks, cs elements apart, which the spare
// line of chunk_stride puts into different banks.
template <int THREADS_>
__device__ __forceinline__ void copy_mn_async(bf16* dst, int cs, const bf16* __restrict__ w,
                                              int wcols, int k0, int klen, int nch0,
                                              int nchunks) {
  for (int idx = threadIdx.x; idx < nchunks * klen; idx += THREADS_) {
    const int k = idx / nchunks, j = idx - k * nchunks;
    cp_async16(dst + j * cs + k * 8, w + (size_t)(k0 + k) * wcols + (nch0 + j) * 8);
  }
}

// Streaming multiprocessors of the current device, read once per process
// (the launches that size persistent grids by it).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace srgd
