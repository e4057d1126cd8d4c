// K5: flash-attention forward (non-causal, online softmax).
//
// Replaces the TPU kernel `_flash_attention_kernel` of the Pallas TPU flash
// attention, launched by `_flash_attention_impl_lm128` in
// viforsdes_tpu/ops/pallas/flash_fixed.py. Per (batch, head):
//   s = (q k^T) * scale in fp32, masked to kMaskValue where a key is past S
//       or in the other segment (tokens at or past real_len);
//   o = softmax(s) v with the running max m and sum l, p rounded to v's dtype
//       before p v as the Pallas kernel does; lse = m + log l is saved for
//       the backward (one fp32 per row in place of the TPU's 128-lane l, m).
//
// What bounds it on an H100: arithmetic. At the Lorenz shape [32, 4, 2001, 64]
// one q k^T is 2*B*H*S^2*D = 65.6 GFLOP and the forward does two such
// products per layer (131 GFLOP, 0.133 ms at 989 TFLOP/s of bf16 tensor
// cores), against 98 MB of q, k, v in bf16 (3 x 32.8 MB; 0.03 ms at 3.35 TB/s).
//
// Design: one block per (64-row q tile, head, batch); the Pallas grid's
// sequential kv axis becomes a loop over 64-row kv tiles inside the block.
// q stays in shared memory for the whole loop; each kv tile is converted to
// fp32 on load. Both products are fp32 FMA over shared-memory tiles with a
// 4 x 4 register tile per thread (no tensor cores in this version), so the
// fp32 path agrees with an fp32 reference. The ragged tail (S = 2001 is not a
// multiple of 64) is zero-filled on load and masked like any other key.

#include "flash_attn.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdArgs a) {
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* q_t = smem;                // [D][kLdt]
  float* k_t = q_t + D * kLdt;      // [D][kLdt]
  float* v_s = k_t + D * kLdt;      // [64][D]
  float* p_t = v_s + kTile * D;     // [64 kv][kLdt]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S;

  load_tile_t<T, D>(a.q, b, h, q0, S, q_t);

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_t<T, D>(a.k, b, h, kv0, S, k_t);
    load_tile<T, D>(a.v, b, h, kv0, S, v_s);
    __syncthreads();

    float s[4][4];
    tile_product<D>(s, q_t, k_t, ty, tx);

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = visible(row, kv0 + tx * 4 + j, S, a.real_len);
        s[i][j] = keep ? s[i][j] * a.scale : kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 64 columns are spread over the 16 lanes with this ty
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        p[i][j] = attn::round_to<T>(e);  // p cast to v's dtype before p v
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    store_tile_t(p_t, p, ty, tx);
    __syncthreads();
    accumulate<D>(acc, p_t, v_s, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = l[i] == 0.0f ? 1.0f : 1.0f / l[i];  // the l == 0 guard
  store_acc<T, D>(a.o, b, h, q0, S, acc, inv, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < S) a.lse[(static_cast<long long>(b) * a.H + h) * S + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_typed(const FwdArgs& a, cudaStream_t stream) {
  auto kernel = fwd_kernel<T, D>;
  const size_t smem = sizeof(float) * (2 * D * kLdt + kTile * D + kTile * kLdt);
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
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
