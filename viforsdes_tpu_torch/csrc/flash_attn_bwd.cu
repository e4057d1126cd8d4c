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
// Both passes give each block 64 output rows and loop over the other side's
// tiles, so each block owns its output rows outright: no atomics, and the
// gradients are the same bit for bit from run to run.
//
// bf16 inputs (the main path) run on the tensor cores, mma.sync m16n8k16
// with fp32 accumulators (flash_attn_mma.cuh). Four warps, each owning 16
// output rows. Operand tiles stay bf16 in shared memory, rows padded against
// bank conflicts, read with ldmatrix (.trans where an operand is taken
// transposed). The streamed tiles (q, do, lse, di in K6; k, v in K7) arrive by
// cp.async into two stages, so the next tile loads while this one computes.
//   K6: per warp, S^T = K Q^T and dP^T = V dO^T over 16 kv rows; p^T and
//       ds^T stay in the accumulator registers, are rounded to bf16 as they
//       are packed into A fragments, and feed dV += p^T dO and dK += ds^T Q
//       without touching shared memory. q and do are read twice from the one
//       bf16 tile: plain as the B operand of S^T and dP^T, transposed as the
//       B operand of dV and dK.
//   K7: per warp, S = Q K^T and dP = dO V^T over 16 q rows, then
//       dQ += bf16(ds) K with K read transposed.
// Masks apply in fragment coordinates (keys past S, the ragged tail, the
// real_len segments), skipped on tiles that lie wholly inside one segment.
// K6 streams 32-row q tiles at head_dim 128 (64 below) so that dK, dV and the
// two score tiles fit in registers.
//
// fp32 inputs keep the first design, fp32-exact: shared-memory tiles in fp32,
// 4 x 4 register tiles of fp32 FMA, the ragged tail zero-filled on load and
// masked, as in K5.

#include <type_traits>

#include "flash_attn.cuh"
#include "flash_attn_mma.cuh"

namespace flash {

// K6 for fp32 inputs: dk and dv of one kv tile, fp32 FMA.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdArgs a) {
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* k_t = smem;                  // [D][kLdt]   fixed for the block
  float* v_t = k_t + D * kLdt;        // [D][kLdt]
  float* q_t = v_t + D * kLdt;        // [D][kLdt]   per q tile
  float* do_t = q_t + D * kLdt;       // [D][kLdt]
  float* q_s = do_t + D * kLdt;       // [64][D]
  float* do_s = q_s + kTile * D;      // [64][D]
  float* ps = do_s + kTile * D;       // [64 q][kLdt]: p, then ds
  float* lse_s = ps + kTile * kLdt;   // [64]
  float* di_s = lse_s + kTile;        // [64]

  const int kv0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S;
  const long long bh = static_cast<long long>(b) * a.H + h;

  load_tile_t<T, D>(a.k, b, h, kv0, S, k_t);
  load_tile_t<T, D>(a.v, b, h, kv0, S, v_t);

  float dk[4][DPT], dv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    load_tile_t<T, D>(a.q, b, h, q0, S, q_t);
    load_tile_t<T, D>(a.d_o, b, h, q0, S, do_t);
    load_tile<T, D>(a.q, b, h, q0, S, q_s);
    load_tile<T, D>(a.d_o, b, h, q0, S, do_s);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? a.lse[bh * S + q0 + r] : 0.0f;
      di_s[r] = in ? a.di[bh * S + q0 + r] : 0.0f;
    }
    __syncthreads();

    // transposed tiles: row i is kv row 4*ty + i, column j is q row 4*tx + j
    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    tile_product<D>(s, k_t, q_t, ty, tx);
    tile_product<D>(dp, v_t, do_t, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx * 4 + j;
        const bool keep = q0 + qr < S && visible(q0 + qr, kv0 + ty * 4 + i, S, a.real_len);
        const float pv = keep ? expf(s[i][j] * a.scale - lse_s[qr]) : 0.0f;
        p[i][j] = attn::round_to<T>(pv);
        ds[i][j] = attn::round_to<T>(pv * (dp[i][j] - di_s[qr]) * a.scale);
      }
    }
    // ps[q][kv] = p: its transpose of the register tile is the [q][kv] layout
    store_tile_t(ps, p, ty, tx);
    __syncthreads();
    accumulate<D>(dv, ps, do_s, ty, tx);   // dv[kv] += sum_q p[q][kv] do[q]
    __syncthreads();
    store_tile_t(ps, ds, ty, tx);
    __syncthreads();
    accumulate<D>(dk, ps, q_s, ty, tx);    // dk[kv] += sum_q ds[q][kv] q[q]
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_acc<T, D>(a.dk, b, h, kv0, S, dk, one, ty, tx);
  store_acc<T, D>(a.dv, b, h, kv0, S, dv, one, ty, tx);
}

// K7 for fp32 inputs: dq of one q tile, fp32 FMA.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* q_t = smem;                  // [D][kLdt]   fixed for the block
  float* do_t = q_t + D * kLdt;       // [D][kLdt]
  float* k_t = do_t + D * kLdt;       // [D][kLdt]   per kv tile
  float* v_t = k_t + D * kLdt;        // [D][kLdt]
  float* k_s = v_t + D * kLdt;        // [64][D]
  float* ds_t = k_s + kTile * D;      // [64 kv][kLdt]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S;
  const long long bh = static_cast<long long>(b) * a.H + h;

  load_tile_t<T, D>(a.q, b, h, q0, S, q_t);
  load_tile_t<T, D>(a.d_o, b, h, q0, S, do_t);
  float lse[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse[i] = row < S ? a.lse[bh * S + row] : 0.0f;
    di[i] = row < S ? a.di[bh * S + row] : 0.0f;
  }

  float dq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[i][j] = 0.0f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += kTile) {
    __syncthreads();
    load_tile_t<T, D>(a.k, b, h, kv0, S, k_t);
    load_tile_t<T, D>(a.v, b, h, kv0, S, v_t);
    load_tile<T, D>(a.k, b, h, kv0, S, k_s);
    __syncthreads();

    float s[4][4], dp[4][4], ds[4][4];
    tile_product<D>(s, q_t, k_t, ty, tx);
    tile_product<D>(dp, do_t, v_t, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = row < S && visible(row, kv0 + tx * 4 + j, S, a.real_len);
        const float pv = keep ? expf(s[i][j] * a.scale - lse[i]) : 0.0f;
        ds[i][j] = attn::round_to<T>(pv * (dp[i][j] - di[i]) * a.scale);
      }
    }
    store_tile_t(ds_t, ds, ty, tx);
    __syncthreads();
    accumulate<D>(dq, ds_t, k_s, ty, tx);  // dq[q] += sum_kv ds[q][kv] k[kv]
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_acc<T, D>(a.dq, b, h, q0, S, dq, one, ty, tx);
}

// ---------------------------------------------------------------- bf16 path

// Blocks an SM must hold at once (the register cap of __launch_bounds__):
// at head_dim <= 64, K6 capped at 170 registers (3 blocks) and K7 at 128 (4)
// run faster for a few bytes of spill; at head_dim 128 the cap spills the
// accumulators, so the compiler keeps its choice.
template <int D>
struct DkvMma {
  static constexpr int kLd = D + mma::kPad;
  static constexpr int kQ = D == 128 ? 32 : 64;  // q rows per streamed tile
  static constexpr int kMinBlocks = D == 128 ? 1 : 3;
  static constexpr size_t kSmem =
      sizeof(mma::bf16) * (2 * kMmaRows + 4 * kQ) * kLd + sizeof(float) * 4 * kQ;
};

template <int D>
struct DqMma {
  static constexpr int kLd = D + mma::kPad;
  static constexpr int kKv = 64;  // kv rows per streamed tile
  static constexpr int kMinBlocks = D == 128 ? 1 : 4;
  static constexpr size_t kSmem = sizeof(mma::bf16) * (2 * kMmaRows + 4 * kKv) * kLd;
};

// K6 on the tensor cores: dk and dv of 64 kv rows, 16 per warp.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, DkvMma<D>::kMinBlocks) dkv_mma_kernel(BwdArgs a) {
  using mma::bf16;
  constexpr int LD = DkvMma<D>::kLd, BQ = DkvMma<D>::kQ;
  constexpr int NQ = BQ / 8, ND = D / 8;  // n-tiles over q (scores), over d (dk, dv)
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_mma);  // [64][LD]       fixed for the block
  bf16* v_s = k_s + kMmaRows * LD;                 // [64][LD]
  bf16* q_s = v_s + kMmaRows * LD;                 // [2][BQ][LD]    two stages
  bf16* do_s = q_s + 2 * BQ * LD;                  // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                  // [2][BQ]

  const int kv0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int S = a.S, wrow = warp * 16;
  const long long bh = static_cast<long long>(b) * a.H + h;

  auto load_q_tile = [&](int stage, int q0) {
    mma::load_rows_async<BQ, D, kMmaThreads>(q_s + stage * BQ * LD, a.q, b, h, q0, S);
    mma::load_rows_async<BQ, D, kMmaThreads>(do_s + stage * BQ * LD, a.d_o, b, h, q0, S);
    const int t = threadIdx.x, r = t % BQ;
    if (t < 2 * BQ) {
      const bool in = q0 + r < S;
      const float* src = (t < BQ ? a.lse : a.di) + bh * S + (in ? q0 + r : 0);
      mma::cp_async4((t < BQ ? lse_s : di_s) + stage * BQ + r, src, in);
    }
  };

  mma::load_rows_async<kMmaRows, D, kMmaThreads>(k_s, a.k, b, h, kv0, S);
  mma::load_rows_async<kMmaRows, D, kMmaThreads>(v_s, a.v, b, h, kv0, S);
  load_q_tile(0, 0);
  mma::cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.0f;
  }

  const int n_tiles = (S + BQ - 1) / BQ;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, q0 = j * BQ;
    mma::cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
    if (j + 1 < n_tiles) load_q_tile(st ^ 1, q0 + BQ);
    mma::cp_async_commit();
    const bf16* qt = q_s + st * BQ * LD;
    const bf16* ot = do_s + st * BQ * LD;
    const float* lse_t = lse_s + st * BQ;
    const float* di_t = di_s + st * BQ;

    // s^T = k q^T and dp^T = v do^T: rows are this warp's kv rows, columns q
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      mma::ldsm_x4(ka, mma::frag_rows16<LD>(k_s, wrow, kk * 16, lane));
      mma::ldsm_x4(va, mma::frag_rows16<LD>(v_s, wrow, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t qb[4], ob[4];
        mma::ldsm_x4(qb, mma::frag_cols16<LD>(qt, n * 8, kk * 16, lane));
        mma::ldsm_x4(ob, mma::frag_cols16<LD>(ot, n * 8, kk * 16, lane));
        mma::mma_16816(s[n], ka, qb[0], qb[1]);
        mma::mma_16816(s[n + 1], ka, qb[2], qb[3]);
        mma::mma_16816(dp[n], va, ob[0], ob[1]);
        mma::mma_16816(dp[n + 1], va, ob[2], ob[3]);
      }
    }

    // p^T into s, ds^T into dp, in fragment coordinates (row kv, column q)
    const bool masked = !all_visible(q0, q0 + BQ, kv0, kv0 + kMmaRows, S, a.real_len);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = n * 8 + c2 + (i & 1);
        const int kv = kv0 + wrow + g + 8 * (i >> 1);
        const bool keep = !masked || (q0 + qc < S && visible(q0 + qc, kv, S, a.real_len));
        const float pv = keep ? __expf(fmaf(s[n][i], a.scale, -lse_t[qc])) : 0.0f;
        dp[n][i] = pv * (dp[n][i] - di_t[qc]) * a.scale;
        s[n][i] = pv;
      }
    }

    // dv += bf16(p^T) do, dk += bf16(ds^T) q: A from registers, B transposed
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      mma::a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
      mma::a_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t ob[4], qb[4];
        mma::ldsm_x4_t(ob, mma::frag_rows16<LD>(ot, kk * 16, n * 8, lane));
        mma::ldsm_x4_t(qb, mma::frag_rows16<LD>(qt, kk * 16, n * 8, lane));
        mma::mma_16816(dv[n], pa, ob[0], ob[1]);
        mma::mma_16816(dv[n + 1], pa, ob[2], ob[3]);
        mma::mma_16816(dk[n], da, qb[0], qb[1]);
        mma::mma_16816(dk[n + 1], da, qb[2], qb[3]);
      }
    }
  }

  mma::store_rows16<ND>(a.dk, b, h, kv0 + wrow, S, dk, lane);
  mma::store_rows16<ND>(a.dv, b, h, kv0 + wrow, S, dv, lane);
}

// K7 on the tensor cores: dq of 64 q rows, 16 per warp.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, DqMma<D>::kMinBlocks) dq_mma_kernel(BwdArgs a) {
  using mma::bf16;
  constexpr int LD = DqMma<D>::kLd, BK = DqMma<D>::kKv;
  constexpr int NK = BK / 8, ND = D / 8;  // n-tiles over kv (scores), over d (dq)
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);  // [64][LD]       fixed for the block
  bf16* do_s = q_s + kMmaRows * LD;                // [64][LD]
  bf16* k_s = do_s + kMmaRows * LD;                // [2][BK][LD]    two stages
  bf16* v_s = k_s + 2 * BK * LD;                   // [2][BK][LD]

  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int S = a.S, wrow = warp * 16;
  const long long bh = static_cast<long long>(b) * a.H + h;

  auto load_kv_tile = [&](int stage, int kv0) {
    mma::load_rows_async<BK, D, kMmaThreads>(k_s + stage * BK * LD, a.k, b, h, kv0, S);
    mma::load_rows_async<BK, D, kMmaThreads>(v_s + stage * BK * LD, a.v, b, h, kv0, S);
  };

  mma::load_rows_async<kMmaRows, D, kMmaThreads>(q_s, a.q, b, h, q0, S);
  mma::load_rows_async<kMmaRows, D, kMmaThreads>(do_s, a.d_o, b, h, q0, S);
  load_kv_tile(0, 0);
  mma::cp_async_commit();

  // lse and di of this lane's two rows (g and g + 8 of the warp's 16)
  float lse[2], di[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wrow + g + 8 * half;
    lse[half] = row < S ? a.lse[bh * S + row] : 0.0f;
    di[half] = row < S ? a.di[bh * S + row] : 0.0f;
  }

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.0f;
  }

  const int n_tiles = (S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, kv0 = j * BK;
    mma::cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
    if (j + 1 < n_tiles) load_kv_tile(st ^ 1, kv0 + BK);
    mma::cp_async_commit();
    const bf16* kt = k_s + st * BK * LD;
    const bf16* vt = v_s + st * BK * LD;

    // s = q k^T and dp = do v^T: rows are this warp's q rows, columns kv
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      mma::ldsm_x4(qa, mma::frag_rows16<LD>(q_s, wrow, kk * 16, lane));
      mma::ldsm_x4(oa, mma::frag_rows16<LD>(do_s, wrow, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4], vb[4];
        mma::ldsm_x4(kb, mma::frag_cols16<LD>(kt, n * 8, kk * 16, lane));
        mma::ldsm_x4(vb, mma::frag_cols16<LD>(vt, n * 8, kk * 16, lane));
        mma::mma_16816(s[n], qa, kb[0], kb[1]);
        mma::mma_16816(s[n + 1], qa, kb[2], kb[3]);
        mma::mma_16816(dp[n], oa, vb[0], vb[1]);
        mma::mma_16816(dp[n + 1], oa, vb[2], vb[3]);
      }
    }

    // ds into s, in fragment coordinates (row q, column kv)
    const bool masked = !all_visible(q0, q0 + kMmaRows, kv0, kv0 + BK, S, a.real_len);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + wrow + g + 8 * (i >> 1);
        const int kv = kv0 + n * 8 + c2 + (i & 1);
        const bool keep = !masked || (row < S && visible(row, kv, S, a.real_len));
        const float pv = keep ? __expf(fmaf(s[n][i], a.scale, -lse[i >> 1])) : 0.0f;
        s[n][i] = pv * (dp[n][i] - di[i >> 1]) * a.scale;
      }
    }

    // dq += bf16(ds) k: A from registers, k read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      mma::a_from_c(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t kb[4];
        mma::ldsm_x4_t(kb, mma::frag_rows16<LD>(kt, kk * 16, n * 8, lane));
        mma::mma_16816(dq[n], da, kb[0], kb[1]);
        mma::mma_16816(dq[n + 1], da, kb[2], kb[3]);
      }
    }
  }

  mma::store_rows16<ND>(a.dq, b, h, q0 + wrow, S, dq, lane);
}

template <int D>
cudaError_t launch_mma(const BwdArgs& a, int pass, cudaStream_t stream) {
  const dim3 grid((a.S + kMmaRows - 1) / kMmaRows, a.H, a.B);
  void (*kernel)(BwdArgs) = pass == 0 ? dkv_mma_kernel<D> : dq_mma_kernel<D>;
  const size_t smem = pass == 0 ? DkvMma<D>::kSmem : DqMma<D>::kSmem;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- dispatch

// Pass 0 launches K6 (dk, dv), pass 1 K7 (dq); the wrapper runs 0 then 1.
// bf16 inputs take the tensor-core kernels, fp32 inputs the FMA kernels.
template <typename T, int D>
cudaError_t launch_typed(const BwdArgs& a, int pass, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_mma<D>(a, pass, stream);
  } else {
    const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
    if (pass == 0) {
      auto kernel = dkv_kernel<T, D>;
      const size_t smem =
          sizeof(float) * (4 * D * kLdt + 2 * kTile * D + kTile * kLdt + 2 * kTile);
      cudaError_t err = attn::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, stream>>>(a);
    } else {
      auto kernel = dq_kernel<T, D>;
      const size_t smem = sizeof(float) * (4 * D * kLdt + kTile * D + kTile * kLdt);
      cudaError_t err = attn::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, stream>>>(a);
    }
    return cudaGetLastError();
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
