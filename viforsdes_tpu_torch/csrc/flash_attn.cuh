// Shared definitions of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the arguments, the mask and its tile shortcut, the
// block shape and the accumulator store of the wgmma kernels (K5-K7 for bf16
// and for fp32 inputs; hopper.cuh), and what the 3xTF32 kernels (K5-K7 for
// fp32 inputs) share: the producer warpgroup's stagers, which split a TMA
// tile into tf32 hi and lo in place and write its transpose, the register A
// fragments of a fixed tile, and the product of split accumulator fragments
// with a transposed tile.
#pragma once

#include <math_constants.h>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace flash {

using attn::MutView;
using attn::View;

// DEFAULT_MASK_VALUE of the Pallas flash kernel: finite, so a fully masked
// tile gives exp(0) = 1 rather than NaN, and a later real key zeroes it.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct FwdArgs {
  View q, k, v;
  MutView o;
  float* lse;    // [B, H, S] fp32
  int B, H, S, real_len;
  float scale;
};

struct BwdArgs {
  View q, k, v, d_o;
  const float* lse;  // [B, H, S]
  const float* di;   // [B, H, S], rowsum(o * do)
  MutView dq, dk, dv;
  int B, H, S, real_len;
  float scale;
};

// Tokens at or past real_len form their own segment; a query sees only keys
// of its segment, and no key at or past S.
__device__ __forceinline__ bool visible(int q_row, int k_row, int S, int real_len) {
  return k_row < S && ((q_row >= real_len) == (k_row >= real_len));
}

// True when every (query, key) pair of query rows [q0, q1) and key rows
// [k0, k1) is visible: all rows below S and all on one side of real_len.
__device__ __forceinline__ bool all_visible(int q0, int q1, int k0, int k1, int S, int real_len) {
  if (q1 > S || k1 > S) return false;
  return max(q1, k1) <= real_len || min(q0, k0) >= real_len;
}

// Blocks of the bf16 wgmma kernels (K5-K7): two consumer warpgroups of 64
// output rows each, then a producer warpgroup whose first warp issues the
// TMA loads of a ring of kWgStages stages. The producer hands registers to
// the consumers (setmaxnreg): 128 x 40 + 256 x 232 fit the SM's 65,536.
constexpr int kWgConsumerWarps = 8;
constexpr int kWgThreads = 32 * kWgConsumerWarps + 128;
constexpr int kWgRows = 128;  // output rows of a block
constexpr int kWgStages = 4;
constexpr unsigned kProducerRegs = 40;
constexpr unsigned kConsumerRegs = 232;

// Store a warp's 16 rows of a warpgroup accumulator ([64, D], D / 2 floats
// a thread; hopper.cuh) times row_scale as T (bf16, or fp32 for the 3xTF32
// kernels) rows row0 + g and row0 + g + 8 of the view; rows at or past S are
// skipped.
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void store_acc16(const MutView& out, int b, int h, int row0, int S,
                                            const float (&acc)[D / 2], const float (&row_scale)[2],
                                            int lane) {
  const int g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= S) continue;
    T* p = attn::row_ptr<T>(out, b, h, row) + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      attn::store2<T>(p + 8 * j, acc[4 * j + 2 * half] * row_scale[half],
                      acc[4 * j + 2 * half + 1] * row_scale[half]);
    }
  }
}

// ---------------------------------------------------------------- fp32 inputs (3xTF32)

// The fp32 kernels' producer warpgroup: warp 0 issues the TMA loads (in K6
// its lanes also copy lse and di), warps 1-3 are the stagers, kStagers
// threads. The registers the producer hands over: 128 x 56 + 256 x 224 fit
// the 384 x 168 a block of three warpgroups is launched with.
constexpr int kStagers = 96;
constexpr unsigned kProducerRegs32 = 56;
constexpr unsigned kConsumerRegs32 = 224;

// Split rows 0 .. R - 1 of a Tile32<D> of R rows (TMA wrote them into its hi
// part) into hi and lo in place, as stager tid of kStagers; with T, also write
// them to t, a Tile32<R> of D rows: row d, depth position tf32_depth_pos(r),
// hi and lo. Each thread takes 16-byte chunks of four columns of one row;
// neighbouring threads take neighbouring rows. (Blocks of 4 x 4, stored 16
// bytes at a time to t, ran slower.)
template <int D, int R, bool T>
__device__ __forceinline__ void stage_tile(float* tile, float* t, int tid) {
  using L = hopper::Tile32<D>;
  using LT = hopper::Tile32<R>;
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  unsigned char* t_base = reinterpret_cast<unsigned char*>(t);
  for (int i = tid; i < R * (D / 4); i += kStagers) {
    const int r = i % R, c = 4 * (i / R);
    float4* hi_p = reinterpret_cast<float4*>(base + L::template offset<R>(r, c));
    const float4 x4 = *hi_p;
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) hopper::tf32_split(x[e], hi[e], lo[e]);
    *hi_p = make_float4(hi[0], hi[1], hi[2], hi[3]);
    hi_p[R * L::kPitch / 16] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    if constexpr (T) {
      const int pos = hopper::tf32_depth_pos(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* p = reinterpret_cast<float*>(t_base + LT::template offset<D>(c + e, pos));
        p[0] = hi[e];
        p[D * LT::kPitch / 4] = lo[e];
      }
    }
  }
}

// The A fragments of one warp's 16 rows from row0 of a Tile32<D> of R rows
// (hi part), every depth step: rows g and g + 8, columns t and t + 4 of
// each 8-column step (hopper.cuh), read once.
template <int D, int R>
__device__ __forceinline__ void a_from_tile(uint32_t (&a)[D / 8][4], const float* tile, int row0, int lane) {
  using L = hopper::Tile32<D>;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      a[kk][i] = *reinterpret_cast<const uint32_t*>(base + L::template offset<R>(row, col));
    }
  }
}

// d += a b over a tile's BQ depth rows in 3xTF32: a the hi and lo fragments
// from registers, b a Tile32<BQ> of D rows (hi, lo; depth permuted).
template <int D, int BQ>
__device__ __forceinline__ void grad_tf32(float (&d)[D / 2], const uint32_t (&ah)[BQ / 8][4],
                                          const uint32_t (&al)[BQ / 8][4], const float* b) {
#pragma unroll
  for (int kk = 0; kk < BQ / 8; ++kk) {
    const uint64_t bh = hopper::desc_k32<BQ, D>(b, 0, kk), bl = hopper::desc_k32<BQ, D>(b, D, kk);
    hopper::mma_rs_tf32<D>(d, ah[kk], bh);
    hopper::mma_rs_tf32<D>(d, ah[kk], bl);
    hopper::mma_rs_tf32<D>(d, al[kk], bh);
  }
}

}  // namespace flash
