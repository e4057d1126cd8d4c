// Shared definitions of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): tile sizes, the mask, and the tile loaders of the fp32
// FMA kernels (K5, and K6/K7 for fp32 inputs; the bf16 K6/K7 run on the
// tensor cores, flash_attn_mma.cuh).
//
// Every FMA kernel works on 64 x 64 tiles of the [S, S] logits of one (batch,
// head) with 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows
// 4*ty .. 4*ty+3 and columns 4*tx .. 4*tx+3 of a tile, and rows 4*ty .. of the
// [64, D] accumulators with D/16 of their columns. Operands live in shared
// memory as fp32 (converted on load), the products are plain fp32 FMA over
// float4 reads: operands read along a tile's rows are stored transposed,
// [D][64 + 4], so each thread reads four consecutive rows at once.
#pragma once

#include <math_constants.h>

#include "attn_common.cuh"

namespace flash {

using attn::MutView;
using attn::View;

constexpr int kTile = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr int kLdt = kTile + 4;    // row stride of a transposed tile
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

// Rows row0 .. row0+63 of a [B, H, S, D] view into dst[d * kLdt + r]
// (transposed); rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(const View& v, int b, int h, int row0, int S,
                                            float* dst) {
  for (int i = threadIdx.x; i < kTile * (D / 4); i += kThreads) {
    const int r = i % kTile, c = (i / kTile) * 4;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (row0 + r < S) attn::load4<T>(attn::row_ptr<T>(v, b, h, row0 + r) + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(c + e) * kLdt + r] = x[e];
  }
}

// The same rows into dst[r * D + d] (row-major).
template <typename T, int D>
__device__ __forceinline__ void load_tile(const View& v, int b, int h, int row0, int S,
                                          float* dst) {
  for (int i = threadIdx.x; i < kTile * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (row0 + r < S) attn::load4<T>(attn::row_ptr<T>(v, b, h, row0 + r) + c, x);
    *reinterpret_cast<float4*>(dst + r * D + c) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// acc[i][j] += sum over the tile's 64 rows c of a_t[c][4*ty + i] * m[c][col j],
// where a_t is [64][kLdt] and m is row-major [64][D]. Column j of thread
// column tx: groups of four consecutive columns, 64 apart (D >= 64), so a
// warp's float4 reads of m cover 256 contiguous bytes; two columns at D = 32.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / 16], const float* a_t,
                                           const float* m, int ty, int tx) {
  constexpr int DPT = D / 16;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    const float4 av = *reinterpret_cast<const float4*>(a_t + c * kLdt + ty * 4);
    const float a4[4] = {av.x, av.y, av.z, av.w};
    float mv[DPT];
    if constexpr (DPT >= 4) {
#pragma unroll
      for (int g = 0; g < DPT / 4; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(m + c * D + g * 64 + tx * 4);
        mv[4 * g] = x.x; mv[4 * g + 1] = x.y; mv[4 * g + 2] = x.z; mv[4 * g + 3] = x.w;
      }
    } else {
      const float2 x = *reinterpret_cast<const float2*>(m + c * D + tx * DPT);
      mv[0] = x.x; mv[1] = x.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(a4[i], mv[j], acc[i][j]);
    }
  }
}

// s[i][j] = sum_d a_t[d][4*ty + i] * b_t[d][4*tx + j] over both [D][kLdt] tiles.
template <int D>
__device__ __forceinline__ void tile_product(float (&s)[4][4], const float* a_t,
                                             const float* b_t, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  }
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(a_t + d * kLdt + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(b_t + d * kLdt + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  }
}

// Store rows 4*ty + i of a [64, D] accumulator (times row_scale[i]) to the
// view, rows at or past S skipped.
template <typename T, int D>
__device__ __forceinline__ void store_acc(const MutView& out, int b, int h, int row0, int S,
                                          const float (&acc)[4][D / 16], const float* row_scale,
                                          int ty, int tx) {
  constexpr int DPT = D / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= S) continue;
    T* p = attn::row_ptr<T>(out, b, h, row);
    if constexpr (DPT >= 4) {
#pragma unroll
      for (int g = 0; g < DPT / 4; ++g) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * g + e] * row_scale[i];
        attn::store4<T>(p + g * 64 + tx * 4, x);
      }
    } else {
      attn::store2<T>(p + tx * DPT, acc[i][0] * row_scale[i], acc[i][1] * row_scale[i]);
    }
  }
}

// Write a 4 x 4 register tile transposed: dst[(4*tx + j) * kLdt + 4*ty + i].
__device__ __forceinline__ void store_tile_t(float* dst, const float (&t)[4][4], int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(dst + (tx * 4 + j) * kLdt + ty * 4) =
        make_float4(t[0][j], t[1][j], t[2][j], t[3][j]);
  }
}

}  // namespace flash
