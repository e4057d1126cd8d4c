// Hopper building blocks of the flash-attention kernels K5 (flash_attn_fwd.cu),
// K6 and K7 (flash_attn_bwd.cu), in inline PTX for sm_90a, with no CUTLASS or
// CuTe:
//   - mbarrier: init, arrive, arrive.expect_tx, try_wait.parity;
//   - TMA: 4-D tile loads (cp.async.bulk.tensor) of a bf16 or fp32
//     [B, H, S, D] view into shared memory that complete on an mbarrier, and,
//     on the host, the tensor map that describes the view;
//   - wgmma: fence, commit, wait, the m64nNk16 bf16 products and the m64nNk8
//     tf32 products (fp32 inputs, 3xTF32) with fp32 accumulators, A from
//     shared memory or from registers, B from shared memory;
//   - the 64-bit shared-memory matrix descriptor.
//
// Tiles in shared memory. R rows of a view arrive by TMA as D / kAtom column
// blocks of kAtom = min(D, 64) columns, each [R][kAtom] bf16: a row is one
// swizzle span (128 bytes; 64 at D = 32), and the 16-byte chunks of row r are
// permuted by r mod 8 (the tensor map's SWIZZLE_128B, or SWIZZLE_64B). That
// is the canonical swizzled layout wgmma reads, both ways:
//   - K-major (the tile's rows are the product's M or N, its columns the
//     depth): depth step kk starts 32 bytes further along a row, in column
//     block 16 kk / kAtom; 8-row groups lie 8 rows apart (SBO);
//   - MN-major (the tile's rows are the depth): depth step kk starts 16 rows
//     further down; 8-row groups lie 8 rows apart (SBO), column blocks R rows
//     apart (LBO).
// The swizzle is a function of address bits, so every column block starts on
// a 1024-byte boundary. Rows past S arrive as zeros.
//
// Fragments of the fp32 accumulator of m64nNk16, per thread of the warpgroup
// (warp w of its four, g = lane / 4, c = 2 * (lane % 4)):
//   d[4j + i] at row 16w + g + 8 * (i / 2), column 8j + c + i % 2:
// a row's columns lie in the four lanes of a quad. The A fragment from
// registers of one depth step (16 columns) holds, per thread, the same rows
// g and g + 8 and columns c, c + 1, c + 8, c + 9 of the warp's 16 rows, so
// accumulator chunks 2kk and 2kk + 1, rounded to bf16 and packed
// (a_from_acc), are the A operand of depth step kk of the next product.
//
// fp32 inputs (K5, K6, K7 with fp32 q, k, v, do) run each product as 3xTF32:
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and a b = a_hi b_hi +
// a_hi b_lo + a_lo b_hi, three m64nNk8 tf32 products into one fp32
// accumulator; what is left out, a_lo b_lo, is below 2^-22 |a b|. TF32 alone
// keeps 10 mantissa bits. An fp32 operand tile (Tile32) holds both parts: in
// each column block of kAtom32 = min(columns, 32) fp32, the tile's R rows of
// hi and then its R rows of lo (R a multiple of 8). A row of a block is one
// swizzle span (128, 64 or 32 bytes), its 16-byte chunks permuted by address
// bits as TMA's SWIZZLE_128B/64B/32B do. tf32 wgmma has no transpose: both
// shared-memory operands are K-major (depth step kk of 8 fp32 starts 32 bytes
// further along a row).
// The A fragment from registers of one tf32 depth step (8 columns) holds,
// per thread, rows g and g + 8 and columns t and t + 4 (t = lane % 4), where
// accumulator chunk kk holds columns 2t and 2t + 1. a_split_from_acc passes
// the accumulator as it is, so depth position p of the product reads column
// pi(p) = 2p (p < 4), 2(p - 4) + 1 (p >= 4) of the chunk; the B tile that
// meets it stores depth u at position tf32_depth_pos(u), the inverse.
#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time, not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver the runtime has loaded, looked up once
// through the runtime, so that the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [B, H, S, D] view (element strides sb, sh, ss;
// unit stride on D) read in boxes of `rows` rows of one column block: dims
// (D, S, H, B), byte strides (ss, sh, sb), box (min(D, 64), rows, 1, 1), 128-
// or 64-byte swizzle. Rows past S read as zero. The wrapper has checked the
// base address and the strides (multiples of 16 bytes).
// The tensor map of a [B, H, S, D] view of elements of `bytes` bytes (element
// strides sb, sh, ss; unit stride on D) read in boxes of `rows` rows of `atom`
// columns: dims (D, S, H, B), byte strides (ss, sh, sb), box (atom, rows, 1,
// 1). Rows past S read as zero.
inline cudaError_t encode_bhsd(CUtensorMap* map, CUtensorMapDataType type, int bytes, int atom,
                               CUtensorMapSwizzle swizzle, const void* p, long long sb, long long sh,
                               long long ss, int B, int H, int S, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * bytes, static_cast<cuuint64_t>(sh) * bytes,
                                 static_cast<cuuint64_t>(sb) * bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(atom), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t bhsd_map(CUtensorMap* map, const void* p, long long sb, long long sh, long long ss,
                            int B, int H, int S, int D, int rows) {
  const int atom = D < 64 ? D : 64;
  return encode_bhsd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, atom,
                     atom == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B, p, sb, sh, ss, B, H, S,
                     D, rows);
}

// The same for an fp32 view (D >= 32): boxes of 32 columns (128 bytes, one
// 128-byte swizzle span).
inline cudaError_t bhsd_map32(CUtensorMap* map, const void* p, long long sb, long long sh, long long ss,
                              int B, int H, int S, int D, int rows) {
  return encode_bhsd(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 32, CU_TENSOR_MAP_SWIZZLE_128B, p, sb, sh, ss, B,
                     H, S, D, rows);
}

// ---------------------------------------------------------------- tiles

// The shared-memory layout of a tile of a head_dim-D view (see the top).
template <int D>
struct Tile {
  static constexpr int kAtom = D < 64 ? D : 64;  // columns of a block
  static constexpr int kPitch = 2 * kAtom;       // bytes of a row of a block
  static constexpr int kBlocks = D / kAtom;
  static constexpr uint64_t kLayout = kPitch == 128 ? 1 : 2;  // descriptor: 128- or 64-byte swizzle
  template <int R>
  static constexpr int bytes() { return R * D * 2; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An fp32 tile of Cols columns (3xTF32 operands): column blocks of kAtom
// columns, each 2R rows (R of hi, then R of lo) of kPitch bytes, swizzled
// by kPitch (see the top).
template <int Cols>
struct Tile32 {
  static constexpr int kAtom = Cols < 32 ? Cols : 32;
  static constexpr int kPitch = 4 * kAtom;
  static constexpr int kBlocks = Cols / kAtom;
  static constexpr uint64_t kLayout = kPitch == 128 ? 1 : kPitch == 64 ? 2 : 3;  // descriptor swizzle
  static constexpr uint32_t kSwizzle = kPitch / 16 - 1;  // chunk bits XORed with row bits
  template <int R>
  static constexpr int bytes() { return 2 * R * Cols * 4; }
  // Byte offset of element (r, c) of the hi part of a tile of R rows (r + R:
  // the lo part); the swizzle XORs bits 4.. of the offset with bits 7..
  template <int R>
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t o = static_cast<uint32_t>(r * kPitch + (c % kAtom) * 4);
    return static_cast<uint32_t>((c / kAtom) * 2 * R * kPitch) + (o ^ (((o >> 7) & kSwizzle) << 4));
  }
};

// p, as the compiler must take it anew where this runs: in a loop, the
// descriptors derived from it are then recomputed each pass instead of being
// hoisted out and held in registers (a few integer instructions against up
// to two registers per descriptor for the whole loop).
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// p rounded up to the next 1024-byte boundary of shared memory.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// After the barriers' init, before any thread or the TMA unit uses them.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Arrive, and add `bytes` to the transfers the current phase waits for.
__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that never
// ends (a fault in a pipeline) traps after 2^26 polls, seconds beyond any
// wait of these kernels, instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------- TMA

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of the map at (col, row, h, b) into dst; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// Rows row0 .. row0 + R - 1 of head (b, h): the tile's column blocks, R rows
// each, on bar (Tile<D>::bytes<R>() bytes in all).
template <int D, int R>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map, uint64_t* bar, int row0, int h,
                                         int b) {
  using L = Tile<D>;
#pragma unroll
  for (int blk = 0; blk < L::kBlocks; ++blk) tma_load(dst + blk * R * L::kAtom, map, bar, blk * L::kAtom, row0, h, b);
}

// Rows row0 .. row0 + R - 1 of an fp32 head (b, h) into the hi part of a
// Tile32<D> of R rows: D / 32 boxes on bar (R * D * 4 bytes in all).
template <int D, int R>
__device__ __forceinline__ void tma_rows32(float* dst, const CUtensorMap* map, uint64_t* bar, int row0, int h,
                                           int b) {
#pragma unroll
  for (int blk = 0; blk < D / 32; ++blk) tma_load(dst + blk * 2 * R * 32, map, bar, blk * 32, row0, h, b);
}

// Order this thread's writes to shared memory before later reads by the
// async proxy (wgmma, TMA): after the writes, before the barrier arrive.
__device__ __forceinline__ void proxy_fence() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---------------------------------------------------------------- descriptors

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | layout << 62;
}

// K-major operand: the 64 rows from row0 (M) or all R rows (N) of a tile of
// R rows, depth step kk (columns 16 kk .. 16 kk + 15).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int row0, int kk) {
  using L = Tile<D>;
  constexpr int kSteps = L::kAtom / 16;  // depth steps in a column block
  const uint32_t addr = smem_u32(tile) + (kk / kSteps) * R * L::kPitch + row0 * L::kPitch + (kk % kSteps) * 32;
  return make_desc(addr, 16, 8 * L::kPitch, L::kLayout);
}

// MN-major operand: depth step kk (rows 16 kk .. 16 kk + 15) of a tile of R
// rows, all D columns.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  using L = Tile<D>;
  return make_desc(smem_u32(tile) + kk * 16 * L::kPitch, R * L::kPitch, 8 * L::kPitch, L::kLayout);
}

// K-major operand of a Tile32<Cols> of R rows (hi and lo parts): the 64 (M)
// or R (N) rows from row0 (R + row0: the lo part), depth step kk (columns
// 8 kk .. 8 kk + 7).
template <int Cols, int R>
__device__ __forceinline__ uint64_t desc_k32(const float* tile, int row0, int kk) {
  using L = Tile32<Cols>;
  constexpr int kSteps = L::kAtom / 8;  // depth steps in a column block
  const uint32_t addr =
      smem_u32(tile) + (kk / kSteps) * 2 * R * L::kPitch + row0 * L::kPitch + (kk % kSteps) * 32;
  return make_desc(addr, 16, 8 * L::kPitch, L::kLayout);
}

// ---------------------------------------------------------------- registers

// Hand registers back to the SM's pool (a producer warpgroup), or take them
// (consumer warpgroups): all four warps of a warpgroup run it together.
template <uint32_t R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <uint32_t R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous product uses across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i]) :: "memory");
  }
}

// d = A B (accumulate == 0) or d += A B over one depth step of 16: A (64 x 16)
// and B (16 x N) from shared memory by descriptor, both K-major.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);

// d += A B over one depth step of 16: A from registers (a_from_acc), B
// (16 x N) from shared memory by descriptor, MN-major.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d = A B (accumulate == 0) or d += A B over one depth step of 8, tf32 inputs:
// A (64 x 8) and B (8 x N) from shared memory by descriptor, both K-major.
template <int N>
__device__ __forceinline__ void mma_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);

// d += A B (or d = A B with accumulate == 0) over one depth step of 8, tf32
// inputs: A from registers (a_split_from_acc, or loaded from a tile), B
// (8 x N) from shared memory by descriptor, K-major.
template <int N>
__device__ __forceinline__ void mma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate = 1);

template <>
__device__ __forceinline__ void mma_ss_tf32<8>(float (&d)[4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss_tf32<16>(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss_tf32<32>(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Two fp32 values rounded to bf16 (to nearest even) in one register, lo in
// the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one depth step from accumulator chunks 2kk and 2kk + 1
// (c = the accumulator from element 8 kk), rounded to bf16.
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

// x rounded to tf32 (to nearest, ties away), low 13 bits zero.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The 3xTF32 split of x: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// Where depth row u is stored in a K-major B tile that meets A fragments
// from a_split_from_acc: within each 8-row step, u % 8 at (u % 8) / 2 +
// 4 (u % 2) (see the top).
__device__ __forceinline__ int tf32_depth_pos(int u) { return (u & ~7) + ((u & 7) >> 1) + 4 * (u & 1); }

// The hi and lo A fragments of one tf32 depth step from accumulator chunk kk
// (c = the accumulator from element 4 kk: rows g, g, g + 8, g + 8 and
// columns 2t, 2t + 1, 2t, 2t + 1), in the fragment's order (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4), column 2t standing at depth t and 2t + 1
// at depth t + 4.
__device__ __forceinline__ void a_split_from_acc(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* c) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h, l;
    tf32_split(x[i], h, l);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(l);
  }
}

}  // namespace hopper
