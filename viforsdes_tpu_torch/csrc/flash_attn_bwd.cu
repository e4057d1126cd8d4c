// K6 / K7: flash-attention backward, as two passes.
//
// Replace the TPU kernels `_flash_attention_dkv_kernel` (launched by
// `_flash_attention_bwd_dkv_lm128`) and `_flash_attention_dq_kernel`
// (launched by `_flash_attention_bwd_dq_fixed`) of
// viforsdes_tpu/ops/pallas/flash_fixed.py. With p = exp(s - lse) recomputed
// from q, k and the forward's log-sum-exp, and di = rowsum(o * do):
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - di) * scale,
//   dk = ds^T q,  dq = ds k,
// with p and ds rounded to the input dtype before the products that take
// them, as the Pallas kernels do.
//
// What bounds it on an H100: arithmetic. One [S, S] x D product is
// 2*B*H*S^2*D = 65.6 GFLOP at the Lorenz shape [32, 4, 2001, 64]. The dK/dV
// pass does four (s, dp, dv, dk: 262 GFLOP, 0.265 ms at 989 TFLOP/s of bf16
// tensor cores) and the dQ pass three (s, dp, dq: 197 GFLOP, 0.199 ms),
// against 131 MB of q, k, v, do in and 98 MB of gradients out (0.07 ms at
// 3.35 TB/s).
//
// Each pass gives a block its output rows and loops over the other side's
// tiles, so each block owns its output rows outright: no atomics, and the
// gradients are the same bit for bit from run to run.
//
// K6 with bf16 inputs (the main path) runs wgmma fed by TMA (hopper.cuh). A
// block owns 128 kv rows: two consumer warpgroups of 64 (one wgmma M tile
// each) and a producer warpgroup that hands most of its registers to them
// (setmaxnreg). k and v arrive once by TMA and stay in shared memory; q and
// do tiles of kQ rows stream through a ring of kWgStages stages by TMA, with
// lse (times log2(e)) and di copied beside them by the producer warp's
// lanes, each stage behind a full and an empty mbarrier. Per q tile, each
// consumer warpgroup
//   - computes S^T = K Q^T and dP^T = V dO^T, both operands in shared memory
//     (K-major);
//   - forms P^T = exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T
//     (dP^T - di) scale in the accumulator registers (row kv, column q),
//     masked in fragment coordinates only on tiles that cross S or real_len;
//   - adds dV += bf16(P^T) dO and dK += bf16(dS^T) Q with A from registers
//     (rounded as it is packed) and dO, Q MN-major from the same shared tiles
//     that fed the first two products.
// Within a warpgroup the tiles overlap: tile j's S^T and dP^T are issued
// together with tile j - 1's dV and dK products, and tile j's P^T and dS^T
// are formed while those run; then the stage of tile j - 1 is released.
// What sizes kQ is the registers that overlap keeps live: dK and dV (D
// columns each), S^T and dP^T of tile j and the bf16 P^T and dS^T of tile
// j - 1. At 64-row q tiles that passes what ptxas gives a consumer at head_dim
// 64: it spills and serializes the products, and K6 runs slower than at 32
// rows. So kQ is 32, and 16 at head_dim 128.
//
// K7 with bf16 inputs runs the same way, sides swapped. A block owns 128 q
// rows, two consumer warpgroups of 64 and a producer warpgroup; q and do
// arrive once by TMA and stay in shared memory, and each consumer thread
// keeps lse (times log2(e), less log2(scale)) and di of its two rows in
// registers for the whole block. k and v tiles of kKv rows stream through a
// ring of kWgStages stages by TMA, each behind a full and an empty mbarrier.
// Per kv tile, each consumer warpgroup
//   - computes S = Q K^T and dP = dO V^T, both operands in shared memory
//     (K-major), as two commit groups;
//   - forms P scale = exp2(S scale log2(e) - lse log2(e) + log2(scale)) as
//     soon as S is in, while dP is on the tensor cores, then dS = P scale
//     (dP - di), in the accumulator registers (row q, column kv), masked in
//     fragment coordinates only on tiles that cross S or real_len (the zero
//     rows TMA fills past S give P = exp2(-lse log2(e)), not 0);
//   - adds dQ += bf16(dS) K with A from registers (rounded as it is packed)
//     and K MN-major from the same shared tile that fed S.
// Tile j's S and dP are issued together with tile j - 1's dQ product, and
// tile j's P and dS are formed while those run; then the stage of tile j - 1
// is released. The live registers are dQ (D / 2 floats a thread), S and dP
// (kKv / 2 each) and the packed dS of tile j - 1 (kKv / 4).
//
// K6 and K7 with fp32 inputs run the same structure on the tensor cores at
// fp32 accuracy: every product (s, dp, dv, dk in K6; s, dp, dq in K7) is
// 3xTF32, a b = a_hi b_hi + a_hi b_lo + a_lo b_hi with hi = tf32(x) and lo =
// tf32(x - hi), three m64nNk8 tf32 wgmma into one fp32 accumulator
// (hopper.cuh), as PyTorch's memory-efficient attention does with mma.sync
// for fp32. One pass of TF32 keeps 10 mantissa bits, far from the fp32
// bars. Bound: 3 x 262.4 GFLOP (K6) and 3 x 196.8 GFLOP (K7) at the Lorenz
// shape, 1.590 and 1.193 ms at 495 TFLOP/s of dense TF32. What the design
// does about what differs from bf16:
//   - tf32 wgmma has no transpose: both shared-memory operands must be
//     K-major. The products that bf16 reads MN-major (dv += p^T do and
//     dk += ds^T q in K6, dq += ds k in K7) need their B with the depth
//     (q rows, kv rows) contiguous. The producer warpgroup's warps 1-3
//     (stagers) wait for each tile TMA brings, split it into hi and lo in
//     place (lo in the tile's second half: Tile32) and write the
//     transposed operand (q^T and do^T, or k^T), hi and lo, then release it
//     to the consumers on a second barrier (ready). The consumers only
//     issue products and form p and ds.
//   - The tf32 A fragment from registers does not line up with the
//     accumulator: a thread holds columns t and t + 4 of each 8-column depth
//     step, its accumulator 2t and 2t + 1. The accumulator goes in as it is
//     (a_split_from_acc) and the stagers store the transposed tiles' depth
//     permuted to match (tf32_depth_pos), so no shuffle is needed.
//   - Shared memory: fp32 tiles with their lo parts take four times the bf16
//     bytes. A stage holds q and do (hi, lo) and q^T and do^T (hi, lo) in K6,
//     k and v (hi, lo) and k^T (hi, lo) in K7; the fixed side's 128 rows with
//     their lo take 128 KB at head_dim 64. So the streamed tiles are 16 rows
//     at head_dim 64 (32 at 32); at head_dim 128 a block owns 64 rows (one
//     consumer warpgroup) and streams 8-row tiles (DkvPlan32, DqPlan32,
//     mirrored by flash_plan).
//   - Registers: the passes triple the products, not the accumulators; the
//     tile heights keep each consumer's overlap (dk and dv, s and dp, and the
//     hi and lo fragments of p^T and ds^T) under what ptxas gives it.
//   - Shared-memory bandwidth bounds both kernels: at 16-row tiles a product
//     of s or dp reads its 64-row A (2 KB a depth step) for 512 bytes of B,
//     three times, and the stagers' traffic comes on top. K7 keeps the hi
//     parts of its fixed q and do as register A fragments (D / 2 registers
//     a thread each, read once a block), which takes s and dp from 7.5 KB of
//     shared-memory reads a depth step to 3.5. K6 has no registers for that
//     beside dk and dv.
// The hi part of a tile TMA loaded could stay the raw fp32 word, with lo =
// tf32(x - x with its low 13 bits cut): on the H100 that holds the same
// error (the tensor core ignores the low 13 bits of an fp32 word) at the same
// speed, so the stagers write hi back rounded. Timing a change here: copy
// this file, edit it, and pass the copy to tools/time_flash.py beside the
// package's.

#include <type_traits>

#include "flash_attn.cuh"
#include "hopper.cuh"

namespace flash {

// ---------------------------------------------------------------- bf16 path

constexpr float kLog2e = 1.4426950408889634f;

// K6's plan at head_dim D: kWgRows kv rows a block, kQ q rows a stage.
// Shared memory: k and v of the block, the ring of (q tile, do tile), the
// ring's lse and di, then the barriers, after up to 1024 bytes that align the
// tiles (flash_plan in ops/flash_attention.py mirrors this).
template <int D>
struct DkvPlan {
  static constexpr int kQ = D == 128 ? 16 : 32;
  static constexpr int kKvBytes = 2 * hopper::Tile<D>::template bytes<kWgRows>();
  static constexpr int kStageBytes = 2 * hopper::Tile<D>::template bytes<kQ>();  // by TMA
  static constexpr int kRowBytes = 2 * kQ * 4;                                    // lse, di
  static constexpr int kBarriers = 1 + 2 * kWgStages;
  static constexpr size_t kSmem = 1024 + kKvBytes + kWgStages * (kStageBytes + kRowBytes) + 8 * kBarriers;
};

struct DkvMaps {
  CUtensorMap q, k, v, d_o;
};

// p^T = exp(s^T scale - lse) and ds^T = p^T (dp^T - di) scale of one tile,
// in place of s and dp (warpgroup accumulators: rows kv from row0, columns q
// from q0), with lse2 = lse log2(e) and di of the tile's q rows in shared
// memory. A tile wholly inside one segment and below S (masked false) needs
// no index arithmetic; on other tiles masked pairs get p = ds = 0.
template <int NS>
__device__ __forceinline__ void dkv_scores(float (&s)[NS], float (&dp)[NS], const float* lse2, const float* di,
                                           bool masked, int row0, int q0, int S, int real_len, float scale,
                                           int lane) {
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const float scale2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int qc = (i >> 2) * 8 + c2 + (i & 1);
    float pv = exp2f(fmaf(s[i], scale2, -lse2[qc]));
    if (masked) {
      const int kv = row0 + g + 8 * ((i >> 1) & 1);
      pv = q0 + qc < S && visible(q0 + qc, kv, S, real_len) ? pv : 0.0f;
    }
    dp[i] = pv * (dp[i] - di[qc]) * scale;
    s[i] = pv;
  }
}

// s^T = k q^T and dp^T = v do^T of one tile: k and v the warpgroup's 64 rows
// (K-major), q and do the tile's BQ rows (K-major, do after q in qo); s and
// dp are not read (the first depth step overwrites them).
template <int D, int BQ>
__device__ __forceinline__ void dkv_scores_mma(float (&s)[BQ / 2], float (&dp)[BQ / 2], const hopper::bf16* k_wg,
                                               const hopper::bf16* v_wg, const hopper::bf16* qo) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::mma_ss<BQ>(s, hopper::desc_k<D, kWgRows>(k_wg, 0, kk), hopper::desc_k<D, BQ>(qo, 0, kk), kk);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::mma_ss<BQ>(dp, hopper::desc_k<D, kWgRows>(v_wg, 0, kk), hopper::desc_k<D, BQ>(qo + BQ * D, 0, kk), kk);
  }
}

// dv += bf16(p^T) do and dk += bf16(ds^T) q of one tile: A from registers,
// do and q MN-major (do after q in qo).
template <int D, int BQ>
__device__ __forceinline__ void dkv_grad_mma(float (&dk)[D / 2], float (&dv)[D / 2], const uint32_t (&pa)[BQ / 16][4],
                                             const uint32_t (&da)[BQ / 16][4], const hopper::bf16* qo) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) hopper::mma_rs<D>(dv, pa[kk], hopper::desc_mn<D, BQ>(qo + BQ * D, kk));
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) hopper::mma_rs<D>(dk, da[kk], hopper::desc_mn<D, BQ>(qo, kk));
}

// K6 on Hopper: dk and dv of 128 kv rows, 64 per consumer warpgroup.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) dkv_wgmma_kernel(const BwdArgs a,
                                                                  const __grid_constant__ DkvMaps maps) {
  using hopper::bf16;
  using P = DkvPlan<D>;
  constexpr int BQ = P::kQ, ST = kWgStages;
  constexpr int NS = BQ / 2, NG = D / 2;  // accumulator floats a thread: s and dp, dk and dv
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* base = hopper::align1024(smem_wg);
  bf16* k_s = reinterpret_cast<bf16*>(base);                                  // [kWgRows] rows of k
  bf16* v_s = k_s + kWgRows * D;                                              // [kWgRows] rows of v
  bf16* qo_s = reinterpret_cast<bf16*>(base + P::kKvBytes);                   // [ST] x (q tile, do tile)
  float* lse_s = reinterpret_cast<float*>(base + P::kKvBytes + ST * P::kStageBytes);  // [ST][BQ], lse log2(e)
  float* di_s = lse_s + ST * BQ;                                                      // [ST][BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(di_s + ST * BQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;        // [ST]: the stage's q, do, lse, di are in
  uint64_t* empty = bars + 1 + ST;  // [ST]: every consumer warp is done with it

  const int kv0 = blockIdx.x * kWgRows, h = blockIdx.y, b = blockIdx.z;
  // the warp index broadcast from lane 0, uniform across the warp as the
  // roles' warpgroup-wide setmaxnreg wants
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0), lane = threadIdx.x % 32;
  const int S = a.S, n_tiles = (S + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    hopper::bar_init(kv_full, 1);
    for (int st = 0; st < ST; ++st) {
      hopper::bar_init(full + st, 32);  // the producer warp's lanes
      hopper::bar_init(empty + st, kWgConsumerWarps);
    }
    hopper::bar_init_fence();
  }
  __syncthreads();

  if (warp >= kWgConsumerWarps) {  // the producer warpgroup: its first warp loads
    hopper::regs_dec<kProducerRegs>();
    if (warp == kWgConsumerWarps) {
      const long long bh = static_cast<long long>(b) * a.H + h;
      if (lane == 0) {
        hopper::prefetch_map(&maps.q);
        hopper::prefetch_map(&maps.d_o);
        hopper::bar_arrive_expect_tx(kv_full, P::kKvBytes);
        hopper::tma_rows<D, kWgRows>(k_s, &maps.k, kv_full, kv0, h, b);
        hopper::tma_rows<D, kWgRows>(v_s, &maps.v, kv_full, kv0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST, q0 = j * BQ;
        bf16* q_t = qo_s + st * 2 * BQ * D;
        if (j >= ST) hopper::bar_wait(empty + st, (j / ST - 1) & 1);
        for (int r = lane; r < BQ; r += 32) {  // rows past S: zeros, masked below
          const bool in = q0 + r < S;
          lse_s[st * BQ + r] = in ? a.lse[bh * S + q0 + r] * kLog2e : 0.0f;
          di_s[st * BQ + r] = in ? a.di[bh * S + q0 + r] : 0.0f;
        }
        if (lane == 0) {
          hopper::bar_arrive_expect_tx(full + st, P::kStageBytes);
          hopper::tma_rows<D, BQ>(q_t, &maps.q, full + st, q0, h, b);
          hopper::tma_rows<D, BQ>(q_t + BQ * D, &maps.d_o, full + st, q0, h, b);
        } else {
          hopper::bar_arrive(full + st);
        }
      }
    }
  } else {
    // a consumer warpgroup: kv rows kw .. kw + 63, this warp's 16 from kw + wrow
    hopper::regs_inc<kConsumerRegs>();
    const int wg = warp / 4, kw = kv0 + 64 * wg, wrow = 16 * (warp % 4);

    float dk[NG], dv[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) dk[i] = dv[i] = 0.0f;
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // bf16(p^T), bf16(ds^T) of the tile whose dv, dk are next
    hopper::bar_wait(kv_full, 0);
    const bf16* k_wg = k_s + 64 * wg * hopper::Tile<D>::kAtom;  // this warpgroup's 64 rows of each block
    const bf16* v_wg = v_s + 64 * wg * hopper::Tile<D>::kAtom;
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(empty + st);
    };
    auto form = [&](float (&s)[NS], float (&dp)[NS], int j) {  // p^T, ds^T of tile j in place
      const int st = j % ST, q0 = j * BQ;
      dkv_scores(s, dp, lse_s + st * BQ, di_s + st * BQ, !all_visible(q0, q0 + BQ, kw, kw + 64, S, a.real_len),
                 kw + wrow, q0, S, a.real_len, a.scale, lane);
    };
    auto pack = [&](const float (&s)[NS], const float (&dp)[NS]) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        hopper::a_from_acc(pa[kk], s + 8 * kk);
        hopper::a_from_acc(da[kk], dp + 8 * kk);
      }
    };

    // tile 0: its s^T, dp^T, p^T and ds^T alone
    {
      float s[NS], dp[NS];
      hopper::bar_wait(full, 0);
      hopper::wg_fence();
      dkv_scores_mma<D, BQ>(s, dp, k_wg, v_wg, qo_s);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      form(s, dp, 0);
      pack(s, dp);
    }
    // tile j's s^T and dp^T are issued with tile j - 1's dv and dk products,
    // and its p^T and ds^T are formed while those are on the tensor cores
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST, prev = (j - 1) % ST;
      float s[NS], dp[NS];
      hopper::bar_wait(full + st, (j / ST) & 1);
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      hopper::fence_regs(pa);
      hopper::fence_regs(da);
      hopper::wg_fence();
      dkv_scores_mma<D, BQ>(s, dp, k_wg, v_wg, qo_s + st * 2 * BQ * D);
      hopper::wg_commit();
      dkv_grad_mma<D, BQ>(dk, dv, pa, da, qo_s + prev * 2 * BQ * D);
      hopper::wg_commit();
      hopper::wg_wait<1>();  // s^T and dp^T
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      form(s, dp, j);
      hopper::wg_wait<0>();  // dv and dk of tile j - 1
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      hopper::fence_regs(pa);
      hopper::fence_regs(da);
      release(prev);
      pack(s, dp);
    }
    // the last tile's dv and dk
    {
      const int last = (n_tiles - 1) % ST;
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      hopper::fence_regs(pa);
      hopper::fence_regs(da);
      hopper::wg_fence();
      dkv_grad_mma<D, BQ>(dk, dv, pa, da, qo_s + last * 2 * BQ * D);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      release(last);
    }

    const float one[2] = {1.0f, 1.0f};
    store_acc16<D>(a.dk, b, h, kw + wrow, S, dk, one, lane);
    store_acc16<D>(a.dv, b, h, kw + wrow, S, dv, one, lane);
  }
}

template <int D>
cudaError_t launch_dkv_wgmma(const BwdArgs& a, cudaStream_t stream) {
  using P = DkvPlan<D>;
  DkvMaps maps;
  cudaError_t err = hopper::bhsd_map(&maps.k, a.k.p, a.k.sb, a.k.sh, a.k.ss, a.B, a.H, a.S, D, kWgRows);
  if (err == cudaSuccess) err = hopper::bhsd_map(&maps.v, a.v.p, a.v.sb, a.v.sh, a.v.ss, a.B, a.H, a.S, D, kWgRows);
  if (err == cudaSuccess) err = hopper::bhsd_map(&maps.q, a.q.p, a.q.sb, a.q.sh, a.q.ss, a.B, a.H, a.S, D, P::kQ);
  if (err == cudaSuccess) {
    err = hopper::bhsd_map(&maps.d_o, a.d_o.p, a.d_o.sb, a.d_o.sh, a.d_o.ss, a.B, a.H, a.S, D, P::kQ);
  }
  if (err != cudaSuccess) return err;
  auto kernel = dkv_wgmma_kernel<D>;
  err = attn::allow_smem(kernel, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kWgRows - 1) / kWgRows, a.H, a.B);
  kernel<<<grid, kWgThreads, P::kSmem, stream>>>(a, maps);
  return cudaGetLastError();
}

// K7's plan at head_dim D: kWgRows q rows a block, kKv kv rows a stage.
// kKv is 64 at head_dim 32 and 64: it ran faster than 32 and 128 (at 128, S
// and dP take 64 floats a thread each, and ptxas spills and serializes the
// products). Head_dim 128 takes 32: at 64 its dQ of 64 floats beside S and
// dP spills.
// Shared memory: q and do of the block, the ring of (k tile, v tile), then
// the barriers, after up to 1024 bytes that align the tiles (flash_plan in
// ops/flash_attention.py mirrors this).
template <int D>
struct DqPlan {
  static constexpr int kKv = D == 128 ? 32 : 64;
  static constexpr int kQoBytes = 2 * hopper::Tile<D>::template bytes<kWgRows>();  // q, do
  static constexpr int kStageBytes = 2 * hopper::Tile<D>::template bytes<kKv>();   // k, v
  static constexpr int kBarriers = 1 + 2 * kWgStages;
  static constexpr size_t kSmem = 1024 + kQoBytes + kWgStages * kStageBytes + 8 * kBarriers;
};

struct DqMaps {
  CUtensorMap q, k, v, d_o;
};

// p scale = exp2(s scale log2(e) - lse2) of one tile in place of s
// (warpgroup accumulators: rows q from row0, columns kv from kv0), with lse2
// = lse log2(e) - log2(scale) of this thread's two rows: the scale rides in
// the exponent. A tile wholly inside one segment and below S (masked false)
// needs no index arithmetic; on other tiles masked pairs get 0.
template <int NS>
__device__ __forceinline__ void dq_probs(float (&s)[NS], const float (&lse2)[2], bool masked, int row0, int kv0,
                                         int S, int real_len, float scale2, int lane) {
  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int half = (i >> 1) & 1;
    const float ps = exp2f(fmaf(s[i], scale2, -lse2[half]));
    if (masked) {
      const int row = row0 + g + 8 * half, kv = kv0 + (i >> 2) * 8 + c2 + (i & 1);
      s[i] = row < S && visible(row, kv, S, real_len) ? ps : 0.0f;
    } else {
      s[i] = ps;
    }
  }
}

// ds = p scale (dp - di) in place of p scale.
template <int NS>
__device__ __forceinline__ void dq_ds(float (&s)[NS], const float (&dp)[NS], const float (&di)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] *= dp[i] - di[(i >> 1) & 1];
}

// s = q k^T, then dp = do v^T of one tile, each its own commit group: q and
// do the warpgroup's 64 rows (K-major), k and v the tile's BK rows
// (K-major, v after k in kv); s and dp are not read (the first depth step
// overwrites them).
template <int D, int BK>
__device__ __forceinline__ void dq_scores_mma(float (&s)[BK / 2], float (&dp)[BK / 2], const hopper::bf16* q_wg,
                                              const hopper::bf16* do_wg, const hopper::bf16* kv) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::mma_ss<BK>(s, hopper::desc_k<D, kWgRows>(q_wg, 0, kk), hopper::desc_k<D, BK>(kv, 0, kk), kk);
  }
  hopper::wg_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::mma_ss<BK>(dp, hopper::desc_k<D, kWgRows>(do_wg, 0, kk), hopper::desc_k<D, BK>(kv + BK * D, 0, kk), kk);
  }
  hopper::wg_commit();
}

// dq += bf16(ds) k of one tile: A from registers, k MN-major.
template <int D, int BK>
__device__ __forceinline__ void dq_grad_mma(float (&dq)[D / 2], const uint32_t (&da)[BK / 16][4],
                                            const hopper::bf16* k_t) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) hopper::mma_rs<D>(dq, da[kk], hopper::desc_mn<D, BK>(k_t, kk));
}

// K7 on Hopper: dq of 128 q rows, 64 per consumer warpgroup.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) dq_wgmma_kernel(const BwdArgs a,
                                                                 const __grid_constant__ DqMaps maps) {
  using hopper::bf16;
  using P = DqPlan<D>;
  constexpr int BK = P::kKv, ST = kWgStages;
  constexpr int NS = BK / 2, NG = D / 2;  // accumulator floats a thread: s and dp, dq
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* base = hopper::align1024(smem_wg);
  bf16* q_s = reinterpret_cast<bf16*>(base);                   // [kWgRows] rows of q
  bf16* do_s = q_s + kWgRows * D;                              // [kWgRows] rows of do
  bf16* kv_s = reinterpret_cast<bf16*>(base + P::kQoBytes);    // [ST] x (k tile, v tile)
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + P::kQoBytes + ST * P::kStageBytes);
  uint64_t* qo_full = bars;
  uint64_t* full = bars + 1;        // [ST]: the stage's k and v have arrived
  uint64_t* empty = bars + 1 + ST;  // [ST]: every consumer warp is done with it

  const int q0 = blockIdx.x * kWgRows, h = blockIdx.y, b = blockIdx.z;
  // the warp index broadcast from lane 0, uniform across the warp as the
  // roles' warpgroup-wide setmaxnreg wants
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0), lane = threadIdx.x % 32;
  const int S = a.S, n_tiles = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::bar_init(qo_full, 1);
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
      hopper::prefetch_map(&maps.k);
      hopper::prefetch_map(&maps.v);
      hopper::bar_arrive_expect_tx(qo_full, P::kQoBytes);
      hopper::tma_rows<D, kWgRows>(q_s, &maps.q, qo_full, q0, h, b);
      hopper::tma_rows<D, kWgRows>(do_s, &maps.d_o, qo_full, q0, h, b);
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
    const float scale2 = a.scale * kLog2e;

    // lse log2(e) - log2(scale) and di of this thread's rows (g and g + 8 of
    // the warp's 16), fixed for the block; rows past S read zeros, masked
    // below
    float lse2[2], di[2];
    {
      const long long bh = static_cast<long long>(b) * a.H + h;
      const float log2_scale = log2f(a.scale);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = qw + wrow + lane / 4 + 8 * half;
        lse2[half] = row < S ? fmaf(a.lse[bh * S + row], kLog2e, -log2_scale) : 0.0f;
        di[half] = row < S ? a.di[bh * S + row] : 0.0f;
      }
    }
    float dq[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) dq[i] = 0.0f;
    uint32_t da[BK / 16][4];  // bf16(ds) of the tile whose dq product is next
    hopper::bar_wait(qo_full, 0);
    const bf16* q_wg = q_s + 64 * wg * hopper::Tile<D>::kAtom;  // this warpgroup's 64 rows of each block
    const bf16* do_wg = do_s + 64 * wg * hopper::Tile<D>::kAtom;
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(empty + st);
    };
    auto probs = [&](float (&s)[NS], int j) {  // p scale of tile j in place of s
      const int kv0 = j * BK;
      dq_probs(s, lse2, !all_visible(qw, qw + 64, kv0, kv0 + BK, S, a.real_len), qw + wrow, kv0, S, a.real_len,
               scale2, lane);
    };
    auto pack = [&](const float (&s)[NS]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hopper::a_from_acc(da[kk], s + 8 * kk);
    };

    // tile 0: its s, dp and ds alone, p while dp is on the tensor cores
    {
      float s[NS], dp[NS];
      hopper::bar_wait(full, 0);
      hopper::wg_fence();
      dq_scores_mma<D, BK>(s, dp, q_wg, do_wg, kv_s);
      hopper::wg_wait<1>();  // s
      hopper::fence_regs(s);
      probs(s, 0);
      hopper::wg_wait<0>();  // dp
      hopper::fence_regs(dp);
      dq_ds(s, dp, di);
      pack(s);
    }
    // tile j's s and dp are issued with tile j - 1's dq product; its p is
    // formed while dp and that product are on the tensor cores, its ds while
    // the product is
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST, prev = (j - 1) % ST;
      float s[NS], dp[NS];
      hopper::bar_wait(full + st, (j / ST) & 1);
      hopper::fence_regs(dq);
      hopper::fence_regs(da);
      hopper::wg_fence();
      dq_scores_mma<D, BK>(s, dp, q_wg, do_wg, kv_s + st * 2 * BK * D);
      dq_grad_mma<D, BK>(dq, da, kv_s + prev * 2 * BK * D);
      hopper::wg_commit();
      hopper::wg_wait<2>();  // s
      hopper::fence_regs(s);
      probs(s, j);
      hopper::wg_wait<1>();  // dp
      hopper::fence_regs(dp);
      dq_ds(s, dp, di);
      hopper::wg_wait<0>();  // dq of tile j - 1
      hopper::fence_regs(dq);
      hopper::fence_regs(da);
      release(prev);
      pack(s);
    }
    // the last tile's dq product
    {
      const int last = (n_tiles - 1) % ST;
      hopper::fence_regs(dq);
      hopper::fence_regs(da);
      hopper::wg_fence();
      dq_grad_mma<D, BK>(dq, da, kv_s + last * 2 * BK * D);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(dq);
      release(last);
    }

    const float one[2] = {1.0f, 1.0f};
    store_acc16<D>(a.dq, b, h, qw + wrow, S, dq, one, lane);
  }
}

template <int D>
cudaError_t launch_dq_wgmma(const BwdArgs& a, cudaStream_t stream) {
  using P = DqPlan<D>;
  DqMaps maps;
  cudaError_t err = hopper::bhsd_map(&maps.q, a.q.p, a.q.sb, a.q.sh, a.q.ss, a.B, a.H, a.S, D, kWgRows);
  if (err == cudaSuccess) {
    err = hopper::bhsd_map(&maps.d_o, a.d_o.p, a.d_o.sb, a.d_o.sh, a.d_o.ss, a.B, a.H, a.S, D, kWgRows);
  }
  if (err == cudaSuccess) err = hopper::bhsd_map(&maps.k, a.k.p, a.k.sb, a.k.sh, a.k.ss, a.B, a.H, a.S, D, P::kKv);
  if (err == cudaSuccess) err = hopper::bhsd_map(&maps.v, a.v.p, a.v.sb, a.v.sh, a.v.ss, a.B, a.H, a.S, D, P::kKv);
  if (err != cudaSuccess) return err;
  auto kernel = dq_wgmma_kernel<D>;
  err = attn::allow_smem(kernel, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kWgRows - 1) / kWgRows, a.H, a.B);
  kernel<<<grid, kWgThreads, P::kSmem, stream>>>(a, maps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path (3xTF32)

// K6's plan for fp32 inputs at head_dim D: kRows kv rows a block (kGroups
// consumer warpgroups), kQ q rows a stage. Shared memory: k and v of the
// block (hi and lo), the ring of (q, do, q^T, do^T; each hi and lo), the
// ring's lse and di, then the barriers, after up to 1024 bytes that align
// the tiles (flash_plan in ops/flash_attention.py mirrors this).
template <int D>
struct DkvPlan32 {
  static constexpr int kGroups = D == 128 ? 1 : 2;
  static constexpr int kRows = 64 * kGroups;
  static constexpr int kThreads = 128 * (kGroups + 1);
  static constexpr int kQ = D == 32 ? 32 : D == 64 ? 16 : 8;
  static constexpr int kStages = D == 32 ? 4 : 3;
  static constexpr int kTile = hopper::Tile32<D>::template bytes<kQ>();  // one streamed operand = Tile32<kQ> of D rows
  static constexpr int kKvBytes = 2 * hopper::Tile32<D>::template bytes<kRows>();
  static constexpr int kStageBytes = 4 * kTile;
  static constexpr int kTmaBytes = 2 * kQ * D * 4;  // q and do by TMA
  static constexpr int kRowBytes = 2 * kQ * 4;      // lse, di
  static constexpr int kBarriers = 2 + 3 * kStages;
  static constexpr size_t kSmem = 1024 + kKvBytes + kStages * (kStageBytes + kRowBytes) + 8 * kBarriers;
  static_assert(hopper::Tile32<kQ>::template bytes<D>() == kTile, "q^T and do^T take a tile's bytes");
};

// s^T = k q^T and dp^T = v do^T of one tile in 3xTF32: k and v the
// warpgroup's 64 rows of the block's Tile32 of R rows, q and do the tile's BQ
// rows (hi and lo in each, K-major); s and dp are not read. k_s and v_s
// pass through opaque: the 4 D / 8 descriptors of the fixed tiles are then
// not held in registers across the tile loop (K6 ran 4% faster so). (k's and
// v's hi parts as register A fragments, as K7 takes q and do, spill at the
// 168 registers a consumer thread gets beside dk, dv and the p^T, ds^T
// fragments, and ran slower.)
template <int D, int BQ, int R>
__device__ __forceinline__ void dkv_scores_tf32(float (&s)[BQ / 2], float (&dp)[BQ / 2], const float* k_s,
                                                const float* v_s, const float* q, const float* d_o, int wg) {
  const int hi = 64 * wg, lo = R + 64 * wg;
  k_s = hopper::opaque(k_s);
  v_s = hopper::opaque(v_s);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t kh = hopper::desc_k32<D, R>(k_s, hi, kk), kl = hopper::desc_k32<D, R>(k_s, lo, kk);
    const uint64_t qh = hopper::desc_k32<D, BQ>(q, 0, kk), ql = hopper::desc_k32<D, BQ>(q, BQ, kk);
    hopper::mma_ss_tf32<BQ>(s, kh, qh, kk);
    hopper::mma_ss_tf32<BQ>(s, kh, ql, 1);
    hopper::mma_ss_tf32<BQ>(s, kl, qh, 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t vh = hopper::desc_k32<D, R>(v_s, hi, kk), vl = hopper::desc_k32<D, R>(v_s, lo, kk);
    const uint64_t oh = hopper::desc_k32<D, BQ>(d_o, 0, kk), ol = hopper::desc_k32<D, BQ>(d_o, BQ, kk);
    hopper::mma_ss_tf32<BQ>(dp, vh, oh, kk);
    hopper::mma_ss_tf32<BQ>(dp, vh, ol, 1);
    hopper::mma_ss_tf32<BQ>(dp, vl, oh, 1);
  }
}

// K6 for fp32 inputs: dk and dv of kRows kv rows, 64 per consumer warpgroup.
template <int D>
__global__ void __launch_bounds__(DkvPlan32<D>::kThreads, 1) dkv_tf32_kernel(const BwdArgs a,
                                                                             const __grid_constant__ DkvMaps maps) {
  using P = DkvPlan32<D>;
  constexpr int BQ = P::kQ, ST = P::kStages, R = P::kRows, CW = 4 * P::kGroups;
  constexpr int NS = BQ / 2, NG = D / 2, KQ = BQ / 8;  // floats a thread: s and dp, dk and dv; depth steps
  extern __shared__ __align__(1024) unsigned char smem_tf[];
  unsigned char* base = hopper::align1024(smem_tf);
  float* k_s = reinterpret_cast<float*>(base);                      // Tile32<D> of R kv rows
  float* v_s = reinterpret_cast<float*>(base + P::kKvBytes / 2);
  unsigned char* ring = base + P::kKvBytes;                         // [ST] x (q, do, q^T, do^T)
  float* lse_s = reinterpret_cast<float*>(ring + ST * P::kStageBytes);  // [ST][BQ], lse log2(e)
  float* di_s = lse_s + ST * BQ;                                        // [ST][BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(di_s + ST * BQ);
  uint64_t* kv_full = bars;       // k and v have arrived
  uint64_t* kv_ready = bars + 1;  // and are split
  uint64_t* full = bars + 2;      // [ST]: the stage's q, do, lse, di are in
  uint64_t* ready = full + ST;    // [ST]: q and do split, q^T and do^T written
  uint64_t* empty = ready + ST;   // [ST]: every consumer warp is done with it
  auto operand = [&](int st, int which) {  // 0 q, 1 do, 2 q^T, 3 do^T
    return reinterpret_cast<float*>(ring + st * P::kStageBytes + which * P::kTile);
  };

  const int kv0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0), lane = threadIdx.x % 32;
  const int S = a.S, n_tiles = (S + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    hopper::bar_init(kv_full, 1);
    hopper::bar_init(kv_ready, kStagers);
    for (int st = 0; st < ST; ++st) {
      hopper::bar_init(full + st, 32);  // the producer warp's lanes
      hopper::bar_init(ready + st, kStagers);
      hopper::bar_init(empty + st, CW);
    }
    hopper::bar_init_fence();
  }
  __syncthreads();

  if (warp >= CW) {  // the producer warpgroup
    if constexpr (P::kGroups == 2) hopper::regs_dec<kProducerRegs32>();
    if (warp == CW) {
      const long long bh = static_cast<long long>(b) * a.H + h;
      if (lane == 0) {
        hopper::prefetch_map(&maps.q);
        hopper::prefetch_map(&maps.d_o);
        hopper::bar_arrive_expect_tx(kv_full, 2 * R * D * 4);
        hopper::tma_rows32<D, R>(k_s, &maps.k, kv_full, kv0, h, b);
        hopper::tma_rows32<D, R>(v_s, &maps.v, kv_full, kv0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST, q0 = j * BQ;
        if (j >= ST) hopper::bar_wait(empty + st, (j / ST - 1) & 1);
        for (int r = lane; r < BQ; r += 32) {  // rows past S: zeros, masked below
          const bool in = q0 + r < S;
          lse_s[st * BQ + r] = in ? a.lse[bh * S + q0 + r] * kLog2e : 0.0f;
          di_s[st * BQ + r] = in ? a.di[bh * S + q0 + r] : 0.0f;
        }
        if (lane == 0) {
          hopper::bar_arrive_expect_tx(full + st, P::kTmaBytes);
          hopper::tma_rows32<D, BQ>(operand(st, 0), &maps.q, full + st, q0, h, b);
          hopper::tma_rows32<D, BQ>(operand(st, 1), &maps.d_o, full + st, q0, h, b);
        } else {
          hopper::bar_arrive(full + st);
        }
      }
    } else {  // the stagers
      const int tid = static_cast<int>(threadIdx.x) - 32 * (CW + 1);
      hopper::bar_wait(kv_full, 0);
      stage_tile<D, R, false>(k_s, nullptr, tid);
      stage_tile<D, R, false>(v_s, nullptr, tid);
      hopper::proxy_fence();
      hopper::bar_arrive(kv_ready);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST;
        hopper::bar_wait(full + st, (j / ST) & 1);
        stage_tile<D, BQ, true>(operand(st, 0), operand(st, 2), tid);
        stage_tile<D, BQ, true>(operand(st, 1), operand(st, 3), tid);
        hopper::proxy_fence();
        hopper::bar_arrive(ready + st);
      }
    }
  } else {
    // a consumer warpgroup: kv rows kw .. kw + 63, this warp's 16 from kw + wrow
    if constexpr (P::kGroups == 2) hopper::regs_inc<kConsumerRegs32>();
    const int wg = warp / 4, kw = kv0 + 64 * wg, wrow = 16 * (warp % 4);

    float dk[NG], dv[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) dk[i] = dv[i] = 0.0f;
    // hi and lo of p^T and ds^T of the tile whose dv, dk are next
    uint32_t ph[KQ][4], pl[KQ][4], dh[KQ][4], dl[KQ][4];
    hopper::bar_wait(kv_ready, 0);
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(empty + st);
    };
    auto form = [&](float (&s)[NS], float (&dp)[NS], int j) {  // p^T, ds^T of tile j in place
      const int st = j % ST, q0 = j * BQ;
      dkv_scores(s, dp, lse_s + st * BQ, di_s + st * BQ, !all_visible(q0, q0 + BQ, kw, kw + 64, S, a.real_len),
                 kw + wrow, q0, S, a.real_len, a.scale, lane);
    };
    auto pack = [&](const float (&s)[NS], const float (&dp)[NS]) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        hopper::a_split_from_acc(ph[kk], pl[kk], s + 4 * kk);
        hopper::a_split_from_acc(dh[kk], dl[kk], dp + 4 * kk);
      }
    };
    auto fence_frags = [&] {
      hopper::fence_regs(ph);
      hopper::fence_regs(pl);
      hopper::fence_regs(dh);
      hopper::fence_regs(dl);
    };

    // tile 0: its s^T, dp^T, p^T and ds^T alone
    {
      float s[NS], dp[NS];
      hopper::bar_wait(ready, 0);
      hopper::wg_fence();
      dkv_scores_tf32<D, BQ, R>(s, dp, k_s, v_s, operand(0, 0), operand(0, 1), wg);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      form(s, dp, 0);
      pack(s, dp);
    }
    // tile j's s^T and dp^T are issued with tile j - 1's dv and dk products,
    // and its p^T and ds^T are formed while those are on the tensor cores
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST, prev = (j - 1) % ST;
      float s[NS], dp[NS];
      hopper::bar_wait(ready + st, (j / ST) & 1);
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      fence_frags();
      hopper::wg_fence();
      dkv_scores_tf32<D, BQ, R>(s, dp, k_s, v_s, operand(st, 0), operand(st, 1), wg);
      hopper::wg_commit();
      grad_tf32<D, BQ>(dv, ph, pl, operand(prev, 3));
      grad_tf32<D, BQ>(dk, dh, dl, operand(prev, 2));
      hopper::wg_commit();
      hopper::wg_wait<1>();  // s^T and dp^T
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      form(s, dp, j);
      hopper::wg_wait<0>();  // dv and dk of tile j - 1
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      fence_frags();
      release(prev);
      pack(s, dp);
    }
    // the last tile's dv and dk
    {
      const int last = (n_tiles - 1) % ST;
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      fence_frags();
      hopper::wg_fence();
      grad_tf32<D, BQ>(dv, ph, pl, operand(last, 3));
      grad_tf32<D, BQ>(dk, dh, dl, operand(last, 2));
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      release(last);
    }

    const float one[2] = {1.0f, 1.0f};
    store_acc16<D, float>(a.dk, b, h, kw + wrow, S, dk, one, lane);
    store_acc16<D, float>(a.dv, b, h, kw + wrow, S, dv, one, lane);
  }
}

template <int D>
cudaError_t launch_dkv_tf32(const BwdArgs& a, cudaStream_t stream) {
  using P = DkvPlan32<D>;
  DkvMaps maps;
  cudaError_t err = hopper::bhsd_map32(&maps.k, a.k.p, a.k.sb, a.k.sh, a.k.ss, a.B, a.H, a.S, D, P::kRows);
  if (err == cudaSuccess) err = hopper::bhsd_map32(&maps.v, a.v.p, a.v.sb, a.v.sh, a.v.ss, a.B, a.H, a.S, D, P::kRows);
  if (err == cudaSuccess) err = hopper::bhsd_map32(&maps.q, a.q.p, a.q.sb, a.q.sh, a.q.ss, a.B, a.H, a.S, D, P::kQ);
  if (err == cudaSuccess) {
    err = hopper::bhsd_map32(&maps.d_o, a.d_o.p, a.d_o.sb, a.d_o.sh, a.d_o.ss, a.B, a.H, a.S, D, P::kQ);
  }
  if (err != cudaSuccess) return err;
  auto kernel = dkv_tf32_kernel<D>;
  err = attn::allow_smem(kernel, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + P::kRows - 1) / P::kRows, a.H, a.B);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(a, maps);
  return cudaGetLastError();
}

// K7's plan for fp32 inputs at head_dim D: kRows q rows a block (kGroups
// consumer warpgroups), kKv kv rows a stage. Shared memory: q and do of the
// block (hi and lo), the ring of (k, v, k^T; each hi and lo), then the
// barriers, after up to 1024 bytes that align the tiles (flash_plan in
// ops/flash_attention.py mirrors this).
template <int D>
struct DqPlan32 {
  static constexpr int kGroups = D == 128 ? 1 : 2;
  static constexpr int kRows = 64 * kGroups;
  static constexpr int kThreads = 128 * (kGroups + 1);
  static constexpr int kKv = D == 32 ? 32 : D == 64 ? 16 : 8;
  static constexpr int kStages = 4;
  // q and do's hi parts as register A fragments (D / 2 registers a thread),
  // read once a block: s and dp then read only their lo parts and k, v from
  // shared memory. At head_dim 128 the registers go to dq.
  static constexpr bool kRegA = D <= 64;
  static constexpr int kTile = hopper::Tile32<D>::template bytes<kKv>();
  static constexpr int kQoBytes = 2 * hopper::Tile32<D>::template bytes<kRows>();
  static constexpr int kStageBytes = 3 * kTile;
  static constexpr int kTmaBytes = 2 * kKv * D * 4;  // k and v by TMA
  static constexpr int kBarriers = 2 + 3 * kStages;
  static constexpr size_t kSmem = 1024 + kQoBytes + kStages * kStageBytes + 8 * kBarriers;
  static_assert(hopper::Tile32<kKv>::template bytes<D>() == kTile, "k^T takes a tile's bytes");
};

// s = q k^T, then dp = do v^T of one tile in 3xTF32, each its own commit
// group: q and do the warpgroup's 64 rows of the block's Tile32 of R rows
// (with kRegA their hi parts from registers, qa and oa), k and v the tile's
// BK rows (hi and lo in each, K-major); s and dp are not read.
template <int D, int BK, int R, bool kRegA, int KA>
__device__ __forceinline__ void dq_scores_tf32(float (&s)[BK / 2], float (&dp)[BK / 2], const float* q_s,
                                               const float* do_s, const uint32_t (&qa)[KA][4],
                                               const uint32_t (&oa)[KA][4], const float* k, const float* v,
                                               int wg) {
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
  hopper::wg_commit();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t ol = hopper::desc_k32<D, R>(do_s, lo, kk);
    const uint64_t vh = hopper::desc_k32<D, BK>(v, 0, kk), vl = hopper::desc_k32<D, BK>(v, BK, kk);
    if constexpr (kRegA) {
      hopper::mma_rs_tf32<BK>(dp, oa[kk], vh, kk);
      hopper::mma_rs_tf32<BK>(dp, oa[kk], vl, 1);
    } else {
      const uint64_t oh = hopper::desc_k32<D, R>(do_s, hi, kk);
      hopper::mma_ss_tf32<BK>(dp, oh, vh, kk);
      hopper::mma_ss_tf32<BK>(dp, oh, vl, 1);
    }
    hopper::mma_ss_tf32<BK>(dp, ol, vh, 1);
  }
  hopper::wg_commit();
}

// K7 for fp32 inputs: dq of kRows q rows, 64 per consumer warpgroup.
template <int D>
__global__ void __launch_bounds__(DqPlan32<D>::kThreads, 1) dq_tf32_kernel(const BwdArgs a,
                                                                           const __grid_constant__ DqMaps maps) {
  using P = DqPlan32<D>;
  constexpr int BK = P::kKv, ST = P::kStages, R = P::kRows, CW = 4 * P::kGroups;
  constexpr int NS = BK / 2, NG = D / 2, KK = BK / 8;  // floats a thread: s and dp, dq; depth steps
  extern __shared__ __align__(1024) unsigned char smem_tf[];
  unsigned char* base = hopper::align1024(smem_tf);
  float* q_s = reinterpret_cast<float*>(base);                  // Tile32<D> of R q rows
  float* do_s = reinterpret_cast<float*>(base + P::kQoBytes / 2);
  unsigned char* ring = base + P::kQoBytes;                     // [ST] x (k, v, k^T)
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + ST * P::kStageBytes);
  uint64_t* qo_full = bars;       // q and do have arrived
  uint64_t* qo_ready = bars + 1;  // and are split
  uint64_t* full = bars + 2;      // [ST]: the stage's k and v have arrived
  uint64_t* ready = full + ST;    // [ST]: k and v split, k^T written
  uint64_t* empty = ready + ST;   // [ST]: every consumer warp is done with it
  auto operand = [&](int st, int which) {  // 0 k, 1 v, 2 k^T
    return reinterpret_cast<float*>(ring + st * P::kStageBytes + which * P::kTile);
  };

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0), lane = threadIdx.x % 32;
  const int S = a.S, n_tiles = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::bar_init(qo_full, 1);
    hopper::bar_init(qo_ready, kStagers);
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
        hopper::bar_arrive_expect_tx(qo_full, 2 * R * D * 4);
        hopper::tma_rows32<D, R>(q_s, &maps.q, qo_full, q0, h, b);
        hopper::tma_rows32<D, R>(do_s, &maps.d_o, qo_full, q0, h, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int st = j % ST;
          if (j >= ST) hopper::bar_wait(empty + st, (j / ST - 1) & 1);
          hopper::bar_arrive_expect_tx(full + st, P::kTmaBytes);
          hopper::tma_rows32<D, BK>(operand(st, 0), &maps.k, full + st, j * BK, h, b);
          hopper::tma_rows32<D, BK>(operand(st, 1), &maps.v, full + st, j * BK, h, b);
        }
      }
    } else {  // the stagers
      const int tid = static_cast<int>(threadIdx.x) - 32 * (CW + 1);
      hopper::bar_wait(qo_full, 0);
      stage_tile<D, R, false>(q_s, nullptr, tid);
      stage_tile<D, R, false>(do_s, nullptr, tid);
      hopper::proxy_fence();
      hopper::bar_arrive(qo_ready);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST;
        hopper::bar_wait(full + st, (j / ST) & 1);
        stage_tile<D, BK, true>(operand(st, 0), operand(st, 2), tid);
        stage_tile<D, BK, false>(operand(st, 1), nullptr, tid);
        hopper::proxy_fence();
        hopper::bar_arrive(ready + st);
      }
    }
  } else {
    // a consumer warpgroup: q rows qw .. qw + 63, this warp's 16 from qw + wrow
    if constexpr (P::kGroups == 2) hopper::regs_inc<kConsumerRegs32>();
    const int wg = warp / 4, qw = q0 + 64 * wg, wrow = 16 * (warp % 4);
    const float scale2 = a.scale * kLog2e;

    // lse log2(e) - log2(scale) and di of this thread's rows (g and g + 8 of
    // the warp's 16), fixed for the block; rows past S read zeros, masked
    // below
    float lse2[2], di[2];
    {
      const long long bh = static_cast<long long>(b) * a.H + h;
      const float log2_scale = log2f(a.scale);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = qw + wrow + lane / 4 + 8 * half;
        lse2[half] = row < S ? fmaf(a.lse[bh * S + row], kLog2e, -log2_scale) : 0.0f;
        di[half] = row < S ? a.di[bh * S + row] : 0.0f;
      }
    }
    float dq[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) dq[i] = 0.0f;
    uint32_t dh[KK][4], dl[KK][4];  // hi and lo of ds of the tile whose dq product is next
    hopper::bar_wait(qo_ready, 0);
    constexpr int KA = P::kRegA ? D / 8 : 1;
    uint32_t qa[KA][4], oa[KA][4];  // with kRegA: the hi A fragments of this warp's q and do rows
    if constexpr (P::kRegA) {
      a_from_tile<D, R>(qa, q_s, 64 * wg + wrow, lane);
      a_from_tile<D, R>(oa, do_s, 64 * wg + wrow, lane);
    }
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(empty + st);
    };
    auto probs = [&](float (&s)[NS], int j) {  // p scale of tile j in place of s
      const int kv0 = j * BK;
      dq_probs(s, lse2, !all_visible(qw, qw + 64, kv0, kv0 + BK, S, a.real_len), qw + wrow, kv0, S, a.real_len,
               scale2, lane);
    };
    auto pack = [&](const float (&s)[NS]) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) hopper::a_split_from_acc(dh[kk], dl[kk], s + 4 * kk);
    };

    // tile 0: its s, dp and ds alone, p while dp is on the tensor cores
    {
      float s[NS], dp[NS];
      hopper::bar_wait(ready, 0);
      hopper::wg_fence();
      dq_scores_tf32<D, BK, R, P::kRegA>(s, dp, q_s, do_s, qa, oa, operand(0, 0), operand(0, 1), wg);
      hopper::wg_wait<1>();  // s
      hopper::fence_regs(s);
      probs(s, 0);
      hopper::wg_wait<0>();  // dp
      hopper::fence_regs(dp);
      dq_ds(s, dp, di);
      pack(s);
    }
    // tile j's s and dp are issued with tile j - 1's dq product; its p is
    // formed while dp and that product are on the tensor cores, its ds while
    // the product is
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST, prev = (j - 1) % ST;
      float s[NS], dp[NS];
      hopper::bar_wait(ready + st, (j / ST) & 1);
      hopper::fence_regs(dq);
      hopper::fence_regs(dh);
      hopper::fence_regs(dl);
      hopper::wg_fence();
      dq_scores_tf32<D, BK, R, P::kRegA>(s, dp, q_s, do_s, qa, oa, operand(st, 0), operand(st, 1), wg);
      grad_tf32<D, BK>(dq, dh, dl, operand(prev, 2));
      hopper::wg_commit();
      hopper::wg_wait<2>();  // s
      hopper::fence_regs(s);
      probs(s, j);
      hopper::wg_wait<1>();  // dp
      hopper::fence_regs(dp);
      dq_ds(s, dp, di);
      hopper::wg_wait<0>();  // dq of tile j - 1
      hopper::fence_regs(dq);
      hopper::fence_regs(dh);
      hopper::fence_regs(dl);
      release(prev);
      pack(s);
    }
    // the last tile's dq product
    {
      const int last = (n_tiles - 1) % ST;
      hopper::fence_regs(dq);
      hopper::fence_regs(dh);
      hopper::fence_regs(dl);
      hopper::wg_fence();
      grad_tf32<D, BK>(dq, dh, dl, operand(last, 2));
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(dq);
      release(last);
    }

    const float one[2] = {1.0f, 1.0f};
    store_acc16<D, float>(a.dq, b, h, qw + wrow, S, dq, one, lane);
  }
}

template <int D>
cudaError_t launch_dq_tf32(const BwdArgs& a, cudaStream_t stream) {
  using P = DqPlan32<D>;
  DqMaps maps;
  cudaError_t err = hopper::bhsd_map32(&maps.q, a.q.p, a.q.sb, a.q.sh, a.q.ss, a.B, a.H, a.S, D, P::kRows);
  if (err == cudaSuccess) {
    err = hopper::bhsd_map32(&maps.d_o, a.d_o.p, a.d_o.sb, a.d_o.sh, a.d_o.ss, a.B, a.H, a.S, D, P::kRows);
  }
  if (err == cudaSuccess) err = hopper::bhsd_map32(&maps.k, a.k.p, a.k.sb, a.k.sh, a.k.ss, a.B, a.H, a.S, D, P::kKv);
  if (err == cudaSuccess) err = hopper::bhsd_map32(&maps.v, a.v.p, a.v.sb, a.v.sh, a.v.ss, a.B, a.H, a.S, D, P::kKv);
  if (err != cudaSuccess) return err;
  auto kernel = dq_tf32_kernel<D>;
  err = attn::allow_smem(kernel, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + P::kRows - 1) / P::kRows, a.H, a.B);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(a, maps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- dispatch

// Pass 0 launches K6 (dk, dv), pass 1 K7 (dq); the wrapper runs 0 then 1.
// bf16 inputs take the bf16 wgmma kernels, fp32 inputs the 3xTF32 ones.
template <typename T, int D>
cudaError_t launch_typed(const BwdArgs& a, int pass, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return pass == 0 ? launch_dkv_wgmma<D>(a, stream) : launch_dq_wgmma<D>(a, stream);
  } else {
    return pass == 0 ? launch_dkv_tf32<D>(a, stream) : launch_dq_tf32<D>(a, stream);
  }
}

template <typename T>
cudaError_t launch(const BwdArgs& a, int D, int pass, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_typed<T, 32>(a, pass, stream);
    case 64: return launch_typed<T, 64>(a, pass, stream);
    case 128: return launch_typed<T, 128>(a, pass, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The plan of pass 0 (K6) or 1 (K7) at head_dim D for bf16 or fp32 inputs:
// {rows a block, rows a stage, stages, threads, dynamic shared memory bytes}.
template <int D>
void bwd_plan(int pass, int is_bf16, long long* out) {
  long long plan[5];
  if (is_bf16) {
    const long long bf16[5] = {kWgRows, pass == 0 ? DkvPlan<D>::kQ : DqPlan<D>::kKv, kWgStages, kWgThreads,
                               static_cast<long long>(pass == 0 ? DkvPlan<D>::kSmem : DqPlan<D>::kSmem)};
    for (int i = 0; i < 5; ++i) plan[i] = bf16[i];
  } else if (pass == 0) {
    using P = DkvPlan32<D>;
    const long long fp32[5] = {P::kRows, P::kQ, P::kStages, P::kThreads, static_cast<long long>(P::kSmem)};
    for (int i = 0; i < 5; ++i) plan[i] = fp32[i];
  } else {
    using P = DqPlan32<D>;
    const long long fp32[5] = {P::kRows, P::kKv, P::kStages, P::kThreads, static_cast<long long>(P::kSmem)};
    for (int i = 0; i < 5; ++i) plan[i] = fp32[i];
  }
  for (int i = 0; i < 5; ++i) out[i] = plan[i];
}

}  // namespace flash

extern "C" int flash_attn_bwd(
    const void* q, long long sqb, long long sqh, long long sqs,
    const void* k, long long skb, long long skh, long long sks,
    const void* v, long long svb, long long svh, long long svs,
    const void* d_o, long long sdb, long long sdh, long long sds,
    const float* lse, const float* di,
    void* dq, long long sdqb, long long sdqh, long long sdqs,
    void* dk, long long sdkb, long long sdkh, long long sdks,
    void* dv, long long sdvb, long long sdvh, long long sdvs,
    int B, int H, int S, int D, int real_len, int is_bf16, float scale, int pass,
    void* stream) {
  using namespace flash;
  if (B == 0 || H == 0 || S == 0) return 0;
  BwdArgs a{{q, sqb, sqh, sqs}, {k, skb, skh, sks}, {v, svb, svh, svs},
            {d_o, sdb, sdh, sds}, lse, di,
            {dq, sdqb, sdqh, sdqs}, {dk, sdkb, sdkh, sdks}, {dv, sdvb, sdvh, sdvs},
            B, H, S, real_len, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(a, D, pass, st)
                                  : launch<float>(a, D, pass, st));
}

// The plan of K6 (pass 0: kv rows a block, q rows a stage) or K7 (pass 1: q
// rows a block, kv rows a stage) at head_dim D for bf16 (is_bf16 1) or fp32
// inputs: {rows a block, rows a stage, stages, threads, dynamic shared memory
// bytes}.
extern "C" int flash_attn_bwd_plan(int D, int pass, int is_bf16, long long* out) {
  if (pass != 0 && pass != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: flash::bwd_plan<32>(pass, is_bf16, out); return 0;
    case 64: flash::bwd_plan<64>(pass, is_bf16, out); return 0;
    case 128: flash::bwd_plan<128>(pass, is_bf16, out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
