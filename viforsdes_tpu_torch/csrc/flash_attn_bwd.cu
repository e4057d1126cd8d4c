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
// What bounds it on an H100: arithmetic. The dK/dV pass does four [64, 64]
// products per tile pair (s, dp, dv, dk) and the dQ pass three (s, dp, dq):
// 7 x 65.6 GFLOP per layer at the Lorenz shape [32, 4, 2001, 64].
//
// Design: K6 gives each block one 64-row kv tile and loops over the q tiles;
// K7 gives each block one 64-row q tile and loops over the kv tiles. Each
// block owns its output rows outright, so there are no atomics and the
// gradients are the same bit for bit from run to run. Shared-memory tiles in
// fp32, 4 x 4 register tiles of fp32 FMA, the ragged tail zero-filled on load
// and masked, as in K5.

#include "flash_attn.cuh"

namespace flash {

// K6: dk and dv of one kv tile.
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

// K7: dq of one q tile.
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

// Pass 0 launches K6 (dk, dv), pass 1 K7 (dq); the wrapper runs 0 then 1.
template <typename T, int D>
cudaError_t launch_typed(const BwdArgs& a, int pass, cudaStream_t stream) {
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
