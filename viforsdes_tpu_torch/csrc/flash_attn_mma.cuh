// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): bf16 tiles in shared memory filled
// by cp.async, ldmatrix reads of mma.sync operand fragments, the product
// itself, and the block shape and mask shortcut the kernels share.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, per lane,
// with g = lane / 4 and c = 2 * (lane % 4) (each A/B register holds two bf16,
// the lower column in the low half):
//   A (16 x 16): a0 = (g, c..c+1), a1 = (g+8, c..c+1), a2 = (g, c+8..c+9),
//                a3 = (g+8, c+8..c+9)
//   B (16 x 8):  b0 = (k c..c+1, n g), b1 = (k c+8..c+9, n g)
//   C (16 x 8, fp32): c[i] at row g + 8*(i/2), column c + i%2.
// So the C fragments of two neighbouring n-tiles, rounded to bf16 and packed,
// are the A fragment of one 16-deep step: one product's output feeds the next
// product from registers (a_from_c).
#pragma once

#include <cstdint>

#include "attn_common.cuh"

namespace flash {
namespace mma {

using bf16 = __nv_bfloat16;

// Row padding of a shared-memory tile, in elements. A row of D + 8 bf16 is an
// odd multiple of 16 bytes at D = 32, 64, 128, so the eight 16-byte rows that
// one ldmatrix phase reads fall in eight distinct bank groups.
constexpr int kPad = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows row0 .. row0+R-1 of a bf16 [B, H, S, D] view into dst[r * (D + kPad)
// + d], 16 bytes per cp.async; rows at or past S are zero.
template <int R, int D, int kThreadCount>
__device__ __forceinline__ void load_rows_async(bf16* dst, const attn::View& v, int b, int h,
                                                int row0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreadCount) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row0 + r < S;
    const bf16* src = attn::row_ptr<bf16>(v, b, h, in ? row0 + r : 0) + c;
    cp_async16(dst + r * (D + kPad) + c, src, in);
  }
}

// Four 8 x 8 bf16 matrices from shared memory; lane t gives the address of
// row t % 8 of matrix t / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// This lane's ldmatrix address for a 16 x 16 block at (r0, c0) of a
// row-major tile with row stride LD, read as
//  - ldsm_x4:   the A fragment {a0, a1, a2, a3} of rows r0.., columns c0..;
//  - ldsm_x4_t: the B fragments {b0, b1} of n-tile c0 and {b0, b1} of n-tile
//               c0 + 8, where the tile is [k][n] (k = r0.., n = c0..).
template <int LD>
__device__ __forceinline__ const bf16* frag_rows16(const bf16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}

// This lane's ldmatrix address for the B fragments {b0, b1} of n-tiles n0 and
// n0 + 8 at depth k0..k0+15, read with ldsm_x4 from a tile stored [n][k].
template <int LD>
__device__ __forceinline__ const bf16* frag_cols16(const bf16* tile, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + ((lane >> 3) & 1) * 8;
}

// c += a . b on the tensor cores, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (to nearest even) in one register, lo in
// the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one 16-deep step from the C fragments of n-tiles 2k and
// 2k + 1 (columns 16k .. 16k+15), rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Store a warp's 16-row accumulator (ND n-tiles of 8 columns) as bf16 rows
// row0 + g and row0 + g + 8 of the view; rows at or past S are skipped.
template <int ND>
__device__ __forceinline__ void store_rows16(const attn::MutView& out, int b, int h, int row0,
                                             int S, const float (&acc)[ND][4], int lane) {
  const int g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= S) continue;
    bf16* p = attn::row_ptr<bf16>(out, b, h, row) + c;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      attn::store2<bf16>(p + nd * 8, acc[nd][2 * half], acc[nd][2 * half + 1]);
    }
  }
}

}  // namespace mma

// Blocks of the tensor-core kernels: four warps, each owning 16 output rows.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // output rows of a block

// True when every (query, key) pair of query rows [q0, q1) and key rows
// [k0, k1) is visible: all rows below S and all on one side of real_len.
__device__ __forceinline__ bool all_visible(int q0, int q1, int k0, int k1, int S, int real_len) {
  if (q1 > S || k1 > S) return false;
  return max(q1, k1) <= real_len || min(q0, k0) >= real_len;
}

}  // namespace flash
