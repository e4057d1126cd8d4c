// K5: flash-attention forward (non-causal, online softmax).
//
// Replaces the TPU kernel `_flash_attention_kernel` of the Pallas TPU flash
// attention, launched by `_flash_attention_impl_lm128` in
// viforsdes_tpu/ops/pallas/flash_fixed.py. Per (batch, head):
//   s = (q k^T) * scale in fp32, masked to kMaskValue where a key is past S
//       or in the other segment (tokens at or past real_len);
//   o = softmax(s) v with the running max m and sum l, p rounded to v's dtype
//       before p v as the Pallas kernel does (bf16; fp32 p stays fp32);
//       lse = m + log l is saved for the backward (one fp32 per row in place
//       of the TPU's 128-lane l, m).
//
// What bounds it on an H100: arithmetic. At the Lorenz shape [32, 4, 2001, 64]
// one q k^T is 2*B*H*S^2*D = 65.6 GFLOP and the forward does two such
// products per layer (131 GFLOP, 0.133 ms at 989 TFLOP/s of bf16 tensor
// cores), against 98 MB of q, k, v in bf16 (3 x 32.8 MB; 0.03 ms at 3.35 TB/s).
// At head_dim 64 the exponentials weigh as much: one per score, 16 a clock
// on an SM's special-function units, against the 256 tensor-core FLOP of the
// same score's two products at ~4096 a clock.
//
// bf16 inputs (the main path) run wgmma fed by TMA (hopper.cuh). A block owns
// 128 q rows: two consumer warpgroups of 64 rows (one wgmma M tile each) and
// a producer warpgroup, which hands most of its registers to the consumers
// (setmaxnreg) and whose one thread loads q once, then streams k and v tiles
// of kKv rows (128; 64 at head_dim 128) through a ring of kWgStages stages,
// each behind a full and an empty mbarrier: the loads run ahead of the
// products with no block-wide barrier. Each consumer warpgroup, per kv tile:
//   - computes s = q k^T with both operands in shared memory (k K-major);
//   - runs the online softmax in the accumulator registers, in base 2 with
//     the scale folded into log2(e). A tile wholly inside one segment and
//     below S takes its row max on the raw scores and exp2(s scale2 - m) with
//     no index arithmetic; other tiles scale, then set masked scores to
//     kMaskValue. The row max is a local max and two quad shuffles; p is
//     added to l unrounded (l stays a per-lane partial sum until the end);
//   - rounds p to bf16 as it packs it into A fragments, and adds p v with A
//     from registers and v MN-major from shared memory: p never leaves
//     registers.
// Within a warpgroup the tiles overlap: tile j's q k^T is issued together
// with tile j - 1's p v, and tile j's softmax runs while that p v is on the
// tensor cores; then o is rescaled and the stage of tile j - 1 released. The
// epilogue applies the l == 0 guard, stores o as bf16 and lse in
// natural-log units, as the backward reads it. The ragged tail (S = 2001)
// needs nothing: the tensor map zero-fills rows past S and the masks drop
// them.
//
// fp32 inputs run the same structure on the tensor cores at fp32 accuracy
// (fwd_tf32_kernel): both products in 3xTF32, a b = a_hi b_hi + a_hi b_lo +
// a_lo b_hi with hi = tf32(x) and lo = tf32(x - hi), three m64nNk8 tf32
// wgmma into one fp32 accumulator (hopper.cuh), as K6 and K7 do for fp32
// (flash_attn_bwd.cu). Bound: 3 x 131.2 GFLOP at the Lorenz shape, 0.795 ms
// at 495 TFLOP/s of dense TF32. What the design does about what differs from
// bf16:
//   - tf32 wgmma has no transpose: p v reads v MN-major in bf16, which tf32
//     cannot. The producer warpgroup's warps 1-3 (stagers, kStagers in
//     flash_attn.cuh) wait for each k and v tile TMA brings, split k into hi
//     and lo in place (lo in the tile's second half: Tile32) and v straight
//     into v^T, hi and lo, with the kv depth permuted to meet p's
//     accumulator as A fragment (tf32_depth_pos), then release the stage on
//     a second barrier (ready). q k^T is K-major on both sides, so k needs no
//     transpose. The staging bounds the kernel more than the products do
//     (with it cut out K5 ran in 0.61 of the time): each stager takes k's
//     and v's chunk in one pass, two independent chains (stage_kv), and v
//     lands as TMA's rows alone, so that four stages fit.
//   - q arrives once a block and is split in place; at head_dim 32 and 64
//     each consumer warp reads its hi part once as register A fragments
//     (a_from_tile), so s reads only q's lo part and k from shared memory
//     (at 128 the registers go to o, and q stays in shared memory).
//   - p is split into hi and lo A fragments straight from the accumulator
//     (a_split_from_acc): unrounded, as the fp32 Pallas kernel takes it.
//   - Shared memory: q with its lo part takes 64 KB at head_dim 64, a stage
//     (k and v^T, each hi and lo, and v) 40 KB at 32-row kv tiles: four
//     stages; 32 rows ran 9% faster than 16 (half the rescales of o per
//     score, and q's lo part read once for twice the keys). At head_dim 128
//     one consumer warpgroup owns 64 rows and streams 16-row tiles
//     (FwdPlan32, mirrored by flash_plan).
// The online softmax, the overlap of tile j's s with tile j - 1's p v, the
// epilogue and the ragged tail are the bf16 kernel's.

#include <type_traits>

#include "flash_attn.cuh"
#include "hopper.cuh"

namespace flash {

// ---------------------------------------------------------------- bf16 path

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// K5's plan at head_dim D: kWgRows q rows a block, kKv kv rows a stage.
// Shared memory: q, then the ring of (k tile, v tile), then the barriers,
// after up to 1024 bytes that align the tiles (flash_plan in
// ops/flash_attention.py mirrors this).
template <int D>
struct FwdPlan {
  static constexpr int kKv = D == 128 ? 64 : 128;
  static constexpr int kQBytes = hopper::Tile<D>::template bytes<kWgRows>();
  static constexpr int kStageBytes = 2 * hopper::Tile<D>::template bytes<kKv>();
  static constexpr int kBarriers = 1 + 2 * kWgStages;
  static constexpr size_t kSmem = 1024 + kQBytes + kWgStages * kStageBytes + 8 * kBarriers;
};

struct FwdMaps {
  CUtensorMap q, k, v;
};

// The online softmax of one tile of raw scores s (a warpgroup accumulator:
// rows from row0, kv columns from kv0), in base 2 with the scale folded in:
// s becomes p = exp2(s scale2 - m) (unrounded), m moves to the new row max
// (scaled), l to alpha l plus this lane's share of the tile's sum, and alpha
// is what rescales the earlier o. A tile wholly inside one segment and below
// S (masked false) takes the row max on the raw scores and needs no index
// arithmetic; other tiles scale, then set masked scores to kMaskValue.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               bool masked, int row0, int kv0, int S, int real_len,
                                               float scale2, int lane) {
  const int g = (lane % 32) / 4, c2 = 2 * (lane % 4);
  float mx[2];
  if (!masked) {
    mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  } else {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int row = row0 + g + 8 * ((i >> 1) & 1);
      const int kv = kv0 + (i >> 2) * 8 + c2 + (i & 1);
      s[i] = visible(row, kv, S, real_len) ? s[i] * scale2 : kMaskValue;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // the row's columns lie in the quad
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    if (!masked) mx[half] = fmaxf(m[half], mx[half] * scale2);
    alpha[half] = exp2f(m[half] - mx[half]);  // 0 on the first tile (m = -inf)
    m[half] = mx[half];
    l[half] *= alpha[half];
  }
  if (!masked) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = exp2f(fmaf(s[i], scale2, -m[(i >> 1) & 1]));
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) l[(i >> 1) & 1] += s[i];
}

// s = q k^T of one tile: q the warpgroup's 64 rows (K-major), k the tile's
// BK rows (K-major); s is not read (the first depth step overwrites it).
template <int D, int BK>
__device__ __forceinline__ void fwd_scores(float (&s)[BK / 2], const hopper::bf16* q_wg,
                                           const hopper::bf16* k_t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::mma_ss<BK>(s, hopper::desc_k<D, kWgRows>(q_wg, 0, kk), hopper::desc_k<D, BK>(k_t, 0, kk), kk);
  }
}

// o += bf16(p) v of one tile: A from registers, v MN-major.
template <int D, int BK>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                       const hopper::bf16* v_t) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) hopper::mma_rs<D>(o, pa[kk], hopper::desc_mn<D, BK>(v_t, kk));
}

// K5 on Hopper: o and lse of 128 q rows, 64 per consumer warpgroup.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) fwd_wgmma_kernel(const FwdArgs a,
                                                                  const __grid_constant__ FwdMaps maps) {
  using hopper::bf16;
  using P = FwdPlan<D>;
  constexpr int BK = P::kKv, ST = kWgStages;
  constexpr int NS = BK / 2, NO = D / 2;  // accumulator floats a thread: s, o
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* base = hopper::align1024(smem_wg);
  bf16* q_s = reinterpret_cast<bf16*>(base);                  // [kWgRows] rows of q
  bf16* kv_s = reinterpret_cast<bf16*>(base + P::kQBytes);    // [ST] x (k tile, v tile)
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + P::kQBytes + ST * P::kStageBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;        // [ST]: the stage's k and v have arrived
  uint64_t* empty = bars + 1 + ST;  // [ST]: every consumer warp is done with it

  const int q0 = blockIdx.x * kWgRows, h = blockIdx.y, b = blockIdx.z;
  // the warp index broadcast from lane 0, uniform across the warp as the
  // roles' warpgroup-wide setmaxnreg wants
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0), lane = threadIdx.x % 32;
  const int S = a.S, n_tiles = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::bar_init(q_full, 1);
    for (int st = 0; st < ST; ++st) {
      hopper::bar_init(full + st, 1);
      hopper::bar_init(empty + st, kWgConsumerWarps);
    }
    hopper::bar_init_fence();
  }
  __syncthreads();

  if (warp >= kWgConsumerWarps) {  // the producer warpgroup: one thread issues every load
    hopper::regs_dec<kProducerRegs>();
    if (warp == kWgConsumerWarps && lane == 0) {
      hopper::prefetch_map(&maps.q);
      hopper::prefetch_map(&maps.k);
      hopper::prefetch_map(&maps.v);
      hopper::bar_arrive_expect_tx(q_full, P::kQBytes);
      hopper::tma_rows<D, kWgRows>(q_s, &maps.q, q_full, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST;
        bf16* k_t = kv_s + st * 2 * BK * D;
        if (j >= ST) hopper::bar_wait(empty + st, (j / ST - 1) & 1);
        hopper::bar_arrive_expect_tx(full + st, P::kStageBytes);
        hopper::tma_rows<D, BK>(k_t, &maps.k, full + st, j * BK, h, b);
        hopper::tma_rows<D, BK>(k_t + BK * D, &maps.v, full + st, j * BK, h, b);
      }
    }
  } else {
    // a consumer warpgroup: q rows qw .. qw + 63, this warp's 16 from qw + wrow
    hopper::regs_inc<kConsumerRegs>();
    const int wg = warp / 4, qw = q0 + 64 * wg, wrow = 16 * (warp % 4);
    const float scale2 = a.scale * kLog2e;  // s in base-2 units

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    // running max (base 2) and this lane's share of the running sum, rows g, g + 8
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f}, alpha[2];
    uint32_t pa[BK / 16][4];  // bf16(p) of the tile whose p v is next
    hopper::bar_wait(q_full, 0);
    const bf16* q_wg = q_s + 64 * wg * hopper::Tile<D>::kAtom;  // this warpgroup's 64 rows of each block
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(empty + st);
    };

    // tile 0: its scores and softmax alone
    {
      float s[NS];
      hopper::bar_wait(full, 0);
      hopper::wg_fence();
      fwd_scores<D, BK>(s, q_wg, kv_s);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(s);
      online_softmax(s, m, l, alpha, !all_visible(qw, qw + 64, 0, BK, S, a.real_len), qw + wrow, 0, S,
                     a.real_len, scale2, lane);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hopper::a_from_acc(pa[kk], s + 8 * kk);
    }
    // tile j's scores are issued with tile j - 1's p v, and its softmax runs
    // while that product is on the tensor cores
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST, prev = (j - 1) % ST, kv0 = j * BK;
      float s[NS];
      hopper::bar_wait(full + st, (j / ST) & 1);
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::wg_fence();
      fwd_scores<D, BK>(s, q_wg, kv_s + st * 2 * BK * D);
      hopper::wg_commit();
      fwd_pv<D, BK>(o, pa, kv_s + (prev * 2 + 1) * BK * D);
      hopper::wg_commit();
      hopper::wg_wait<1>();  // the scores
      hopper::fence_regs(s);
      online_softmax(s, m, l, alpha, !all_visible(qw, qw + 64, kv0, kv0 + BK, S, a.real_len), qw + wrow, kv0,
                     S, a.real_len, scale2, lane);
      hopper::wg_wait<0>();  // p v of tile j - 1
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      release(prev);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hopper::a_from_acc(pa[kk], s + 8 * kk);
    }
    // the last tile's p v
    {
      const int last = (n_tiles - 1) % ST;
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::wg_fence();
      fwd_pv<D, BK>(o, pa, kv_s + (last * 2 + 1) * BK * D);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      release(last);
    }

    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
      inv[half] = l[half] == 0.0f ? 1.0f : 1.0f / l[half];  // the l == 0 guard
    }
    store_acc16<D>(a.o, b, h, qw + wrow, S, o, inv, lane);
    if (lane % 4 == 0) {
      const long long bh = static_cast<long long>(b) * a.H + h;
      const int g = lane / 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = qw + wrow + g + 8 * half;
        if (row < S) a.lse[bh * S + row] = m[half] * kLn2 + logf(l[half]);
      }
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const FwdArgs& a, cudaStream_t stream) {
  using P = FwdPlan<D>;
  FwdMaps maps;
  cudaError_t err = hopper::bhsd_map(&maps.q, a.q.p, a.q.sb, a.q.sh, a.q.ss, a.B, a.H, a.S, D, kWgRows);
  if (err == cudaSuccess) err = hopper::bhsd_map(&maps.k, a.k.p, a.k.sb, a.k.sh, a.k.ss, a.B, a.H, a.S, D, P::kKv);
  if (err == cudaSuccess) err = hopper::bhsd_map(&maps.v, a.v.p, a.v.sb, a.v.sh, a.v.ss, a.B, a.H, a.S, D, P::kKv);
  if (err != cudaSuccess) return err;
  auto kernel = fwd_wgmma_kernel<D>;
  err = attn::allow_smem(kernel, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kWgRows - 1) / kWgRows, a.H, a.B);
  kernel<<<grid, kWgThreads, P::kSmem, stream>>>(a, maps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path (3xTF32)

// K5's plan for fp32 inputs at head_dim D: kRows q rows a block (kGroups
// consumer warpgroups), kKv kv rows a stage. Shared memory: q of the block
// (hi and lo), the ring of (k and v^T, each hi and lo; v as TMA writes it),
// then the barriers, after up to 1024 bytes that align the tiles
// (flash_plan in ops/flash_attention.py mirrors this).
template <int D>
struct FwdPlan32 {
  static constexpr int kGroups = D == 128 ? 1 : 2;
  static constexpr int kRows = 64 * kGroups;
  static constexpr int kThreads = 128 * (kGroups + 1);
  static constexpr int kKv = D == 128 ? 16 : 32;
  static constexpr int kStages = 4;
  // q's hi part as register A fragments (D / 2 registers a thread), read
  // once a block: s then reads only q's lo part and k from shared memory.
  // At head_dim 128 the registers go to o.
  static constexpr bool kRegA = D <= 64;
  static constexpr int kTile = hopper::Tile32<D>::template bytes<kKv>();
  static constexpr int kQBytes = hopper::Tile32<D>::template bytes<kRows>();
  // v lands as TMA's kKv rows alone, D / 32 column blocks of kKv rows: the
  // layout of the hi part of a Tile32<D> of kKv / 2 rows
  static constexpr int kLanding = kKv * D * 4;
  static constexpr int kStageBytes = 2 * kTile + kLanding;
  static constexpr int kTmaBytes = 2 * kKv * D * 4;  // k and v by TMA
  static constexpr int kBarriers = 2 + 3 * kStages;
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes + 8 * kBarriers;
  static_assert(hopper::Tile32<kKv>::template bytes<D>() == kTile, "v^T takes a tile's bytes");
};

// s = q k^T of one tile in 3xTF32: q the warpgroup's 64 rows of the block's
// Tile32 of R rows (with kRegA its hi part from registers, qa), k the tile's
// BK rows (hi and lo, K-major); s is not read (the first depth step
// overwrites it).
template <int D, int BK, int R, bool kRegA, int KA>
__device__ __forceinline__ void fwd_scores_tf32(float (&s)[BK / 2], const float* q_s, const uint32_t (&qa)[KA][4],
                                                const float* k, int wg) {
  const int hi = 64 * wg, lo = R + 64 * wg;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t ql = hopper::desc_k32<D, R>(q_s, lo, kk);
    const uint64_t kh = hopper::desc_k32<D, BK>(k, 0, kk), kl = hopper::desc_k32<D, BK>(k, BK, kk);
    if constexpr (kRegA) {
      hopper::mma_rs_tf32<BK>(s, qa[kk], kh, kk);
      hopper::mma_rs_tf32<BK>(s, qa[kk], kl, 1);
    } else {
      const uint64_t qh = hopper::desc_k32<D, R>(q_s, hi, kk);
      hopper::mma_ss_tf32<BK>(s, qh, kh, kk);
      hopper::mma_ss_tf32<BK>(s, qh, kl, 1);
    }
    hopper::mma_ss_tf32<BK>(s, ql, kh, 1);
  }
}

// The stagers' work on one stage, as stager tid of kStagers: split k (a
// Tile32<D> of R rows, TMA wrote its hi part) into hi and lo in place, and v
// (its landing tile, FwdPlan32::kLanding) into t, a Tile32<R> of D rows: row
// d, depth position tf32_depth_pos(r), hi and lo. Each thread takes the same
// 16-byte chunk of k and of v, two independent chains (the two tiles one
// after the other, as stage_tile does them, ran 11% slower).
template <int D, int R>
__device__ __forceinline__ void stage_kv(float* k, const float* v, float* t, int tid) {
  using L = hopper::Tile32<D>;
  using LT = hopper::Tile32<R>;
  unsigned char* k_base = reinterpret_cast<unsigned char*>(k);
  const unsigned char* v_base = reinterpret_cast<const unsigned char*>(v);
  unsigned char* t_base = reinterpret_cast<unsigned char*>(t);
  for (int i = tid; i < R * (D / 4); i += kStagers) {
    const int r = i % R, c = 4 * (i / R);
    float4* kp = reinterpret_cast<float4*>(k_base + L::template offset<R>(r, c));
    const float4 k4 = *kp;
    const float4 v4 = *reinterpret_cast<const float4*>(v_base + L::template offset<R / 2>(r, c));
    const float kx[4] = {k4.x, k4.y, k4.z, k4.w}, vx[4] = {v4.x, v4.y, v4.z, v4.w};
    float kh[4], kl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) hopper::tf32_split(kx[e], kh[e], kl[e]);
    *kp = make_float4(kh[0], kh[1], kh[2], kh[3]);
    kp[R * L::kPitch / 16] = make_float4(kl[0], kl[1], kl[2], kl[3]);
    const int pos = hopper::tf32_depth_pos(r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float hi, lo;
      hopper::tf32_split(vx[e], hi, lo);
      float* p = reinterpret_cast<float*>(t_base + LT::template offset<D>(c + e, pos));
      p[0] = hi;
      p[D * LT::kPitch / 4] = lo;
    }
  }
}

// K5 for fp32 inputs: o and lse of kRows q rows, 64 per consumer warpgroup.
template <int D>
__global__ void __launch_bounds__(FwdPlan32<D>::kThreads, 1) fwd_tf32_kernel(const FwdArgs a,
                                                                             const __grid_constant__ FwdMaps maps) {
  using P = FwdPlan32<D>;
  constexpr int BK = P::kKv, ST = P::kStages, R = P::kRows, CW = 4 * P::kGroups;
  constexpr int NS = BK / 2, NO = D / 2, KK = BK / 8;  // floats a thread: s, o; depth steps of p v
  extern __shared__ __align__(1024) unsigned char smem_tf[];
  unsigned char* base = hopper::align1024(smem_tf);
  float* q_s = reinterpret_cast<float*>(base);  // Tile32<D> of R q rows
  unsigned char* ring = base + P::kQBytes;      // [ST] x (k, v^T, v)
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + ST * P::kStageBytes);
  uint64_t* q_full = bars;       // q has arrived
  uint64_t* q_ready = bars + 1;  // and is split
  uint64_t* full = bars + 2;     // [ST]: the stage's k and v have arrived
  uint64_t* ready = full + ST;   // [ST]: k split, v^T written
  uint64_t* empty = ready + ST;  // [ST]: every consumer warp is done with it
  auto operand = [&](int st, int which) {  // 0 k, 1 v^T, 2 v (kLanding bytes)
    return reinterpret_cast<float*>(ring + st * P::kStageBytes + which * P::kTile);
  };

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0), lane = threadIdx.x % 32;
  const int S = a.S, n_tiles = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::bar_init(q_full, 1);
    hopper::bar_init(q_ready, kStagers);
    for (int st = 0; st < ST; ++st) {
      hopper::bar_init(full + st, 1);
      hopper::bar_init(ready + st, kStagers);
      hopper::bar_init(empty + st, CW);
    }
    hopper::bar_init_fence();
  }
  __syncthreads();

  if (warp >= CW) {  // the producer warpgroup
    if constexpr (P::kGroups == 2) hopper::regs_dec<kProducerRegs32>();
    if (warp == CW) {
      if (lane == 0) {
        hopper::prefetch_map(&maps.k);
        hopper::prefetch_map(&maps.v);
        hopper::bar_arrive_expect_tx(q_full, R * D * 4);
        hopper::tma_rows32<D, R>(q_s, &maps.q, q_full, q0, h, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int st = j % ST;
          if (j >= ST) hopper::bar_wait(empty + st, (j / ST - 1) & 1);
          hopper::bar_arrive_expect_tx(full + st, P::kTmaBytes);
          hopper::tma_rows32<D, BK>(operand(st, 0), &maps.k, full + st, j * BK, h, b);
          hopper::tma_rows32<D, BK / 2>(operand(st, 2), &maps.v, full + st, j * BK, h, b);  // kLanding
        }
      }
    } else {  // the stagers
      const int tid = static_cast<int>(threadIdx.x) - 32 * (CW + 1);
      hopper::bar_wait(q_full, 0);
      stage_tile<D, R, false>(q_s, nullptr, tid);
      hopper::proxy_fence();
      hopper::bar_arrive(q_ready);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST;
        hopper::bar_wait(full + st, (j / ST) & 1);
        stage_kv<D, BK>(operand(st, 0), operand(st, 2), operand(st, 1), tid);
        hopper::proxy_fence();
        hopper::bar_arrive(ready + st);
      }
    }
  } else {
    // a consumer warpgroup: q rows qw .. qw + 63, this warp's 16 from qw + wrow
    if constexpr (P::kGroups == 2) hopper::regs_inc<kConsumerRegs32>();
    const int wg = warp / 4, qw = q0 + 64 * wg, wrow = 16 * (warp % 4);
    const float scale2 = a.scale * kLog2e;  // s in base-2 units

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    // running max (base 2) and this lane's share of the running sum, rows g, g + 8
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f}, alpha[2];
    uint32_t ph[KK][4], pl[KK][4];  // hi and lo of p of the tile whose p v is next
    hopper::bar_wait(q_ready, 0);
    constexpr int KA = P::kRegA ? D / 8 : 1;
    uint32_t qa[KA][4];  // with kRegA: the hi A fragments of this warp's q rows
    if constexpr (P::kRegA) a_from_tile<D, R>(qa, q_s, 64 * wg + wrow, lane);
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(empty + st);
    };
    auto softmax = [&](float (&s)[NS], int j) {  // p of tile j in place of s
      const int kv0 = j * BK;
      online_softmax(s, m, l, alpha, !all_visible(qw, qw + 64, kv0, kv0 + BK, S, a.real_len), qw + wrow, kv0, S,
                     a.real_len, scale2, lane);
    };
    auto pack = [&](const float (&s)[NS]) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) hopper::a_split_from_acc(ph[kk], pl[kk], s + 4 * kk);
    };

    // tile 0: its scores and softmax alone
    {
      float s[NS];
      hopper::bar_wait(ready, 0);
      hopper::wg_fence();
      fwd_scores_tf32<D, BK, R, P::kRegA>(s, q_s, qa, operand(0, 0), wg);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(s);
      softmax(s, 0);
      pack(s);
    }
    // tile j's scores are issued with tile j - 1's p v, and its softmax runs
    // while that product is on the tensor cores
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST, prev = (j - 1) % ST;
      float s[NS];
      hopper::bar_wait(ready + st, (j / ST) & 1);
      hopper::fence_regs(o);
      hopper::fence_regs(ph);
      hopper::fence_regs(pl);
      hopper::wg_fence();
      fwd_scores_tf32<D, BK, R, P::kRegA>(s, q_s, qa, operand(st, 0), wg);
      hopper::wg_commit();
      grad_tf32<D, BK>(o, ph, pl, operand(prev, 1));
      hopper::wg_commit();
      hopper::wg_wait<1>();  // the scores
      hopper::fence_regs(s);
      softmax(s, j);
      hopper::wg_wait<0>();  // p v of tile j - 1
      hopper::fence_regs(o);
      hopper::fence_regs(ph);
      hopper::fence_regs(pl);
      release(prev);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack(s);
    }
    // the last tile's p v
    {
      const int last = (n_tiles - 1) % ST;
      hopper::fence_regs(o);
      hopper::fence_regs(ph);
      hopper::fence_regs(pl);
      hopper::wg_fence();
      grad_tf32<D, BK>(o, ph, pl, operand(last, 1));
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(o);
      release(last);
    }

    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
      inv[half] = l[half] == 0.0f ? 1.0f : 1.0f / l[half];  // the l == 0 guard
    }
    store_acc16<D, float>(a.o, b, h, qw + wrow, S, o, inv, lane);
    if (lane % 4 == 0) {
      const long long bh = static_cast<long long>(b) * a.H + h;
      const int g = lane / 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = qw + wrow + g + 8 * half;
        if (row < S) a.lse[bh * S + row] = m[half] * kLn2 + logf(l[half]);
      }
    }
  }
}

template <int D>
cudaError_t launch_tf32(const FwdArgs& a, cudaStream_t stream) {
  using P = FwdPlan32<D>;
  FwdMaps maps;
  cudaError_t err = hopper::bhsd_map32(&maps.q, a.q.p, a.q.sb, a.q.sh, a.q.ss, a.B, a.H, a.S, D, P::kRows);
  if (err == cudaSuccess) err = hopper::bhsd_map32(&maps.k, a.k.p, a.k.sb, a.k.sh, a.k.ss, a.B, a.H, a.S, D, P::kKv);
  if (err == cudaSuccess) err = hopper::bhsd_map32(&maps.v, a.v.p, a.v.sb, a.v.sh, a.v.ss, a.B, a.H, a.S, D, P::kKv);
  if (err != cudaSuccess) return err;
  auto kernel = fwd_tf32_kernel<D>;
  err = attn::allow_smem(kernel, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + P::kRows - 1) / P::kRows, a.H, a.B);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(a, maps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- dispatch

// bf16 inputs take the bf16 wgmma kernel, fp32 inputs the 3xTF32 one.
template <typename T, int D>
cudaError_t launch_typed(const FwdArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_wgmma<D>(a, stream);
  } else {
    return launch_tf32<D>(a, stream);
  }
}

template <typename T>
cudaError_t launch(const FwdArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_typed<T, 32>(a, stream);
    case 64: return launch_typed<T, 64>(a, stream);
    case 128: return launch_typed<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The plan at head_dim D for bf16 or fp32 inputs: {q rows a block, kv rows
// a stage, stages, threads, dynamic shared memory bytes}.
template <int D>
void fwd_plan(int is_bf16, long long* out) {
  using P = FwdPlan<D>;
  using P32 = FwdPlan32<D>;
  const long long bf16[5] = {kWgRows, P::kKv, kWgStages, kWgThreads, static_cast<long long>(P::kSmem)};
  const long long fp32[5] = {P32::kRows, P32::kKv, P32::kStages, P32::kThreads, static_cast<long long>(P32::kSmem)};
  for (int i = 0; i < 5; ++i) out[i] = is_bf16 ? bf16[i] : fp32[i];
}

}  // namespace flash

extern "C" int flash_attn_fwd(
    const void* q, long long sqb, long long sqh, long long sqs,
    const void* k, long long skb, long long skh, long long sks,
    const void* v, long long svb, long long svh, long long svs,
    void* o, long long sob, long long soh, long long sos,
    float* lse, int B, int H, int S, int D, int real_len, int is_bf16, float scale,
    void* stream) {
  using namespace flash;
  if (B == 0 || H == 0 || S == 0) return 0;
  FwdArgs a{{q, sqb, sqh, sqs}, {k, skb, skh, sks}, {v, svb, svh, svs},
            {o, sob, soh, sos}, lse, B, H, S, real_len, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(a, D, st) : launch<float>(a, D, st));
}

// K5's plan at head_dim D for bf16 (is_bf16 1) or fp32 inputs: {q rows a
// block, kv rows a stage, stages, threads, dynamic shared memory bytes}.
extern "C" int flash_attn_fwd_plan(int D, int is_bf16, long long* out) {
  switch (D) {
    case 32: flash::fwd_plan<32>(is_bf16, out); return 0;
    case 64: flash::fwd_plan<64>(is_bf16, out); return 0;
    case 128: flash::fwd_plan<128>(is_bf16, out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
