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
// Both designs give a block 64 q rows and turn the Pallas grid's sequential
// kv axis into a loop over 64-row kv tiles inside the block.
//
// bf16 inputs (the main path) run on the tensor cores, mma.sync m16n8k16 with
// fp32 accumulators (flash_attn_mma.cuh): four warps, each owning 16 q rows.
// q arrives once by cp.async and stays in registers as A fragments; k and v
// stream through two cp.async stages (one barrier per tile). s = q k^T stays
// in the accumulators; the online softmax runs in fragment coordinates (a
// lane holds rows g and g + 8; a row's columns lie in the four lanes of a
// quad, so its max is a local max and two shuffles), in base 2 with the scale
// folded into log2(e). p is added to l unrounded and rounded to bf16 as it is
// packed into the A fragment of o += p v, v read transposed by ldmatrix: p
// never leaves registers. l stays a per-lane partial sum until the epilogue.
// Masks apply in fragment coordinates, skipped on tiles wholly inside one
// segment; lse is stored in natural-log units, as the backward reads it.
//
// fp32 inputs keep the first design, fp32-exact: tiles converted to fp32 in
// shared memory, both products fp32 FMA over 4 x 4 register tiles, p through
// shared memory. The ragged tail (S = 2001 is not a multiple of 64) is
// zero-filled on load and masked like any other key in both.

#include <type_traits>

#include "flash_attn.cuh"
#include "flash_attn_mma.cuh"

namespace flash {

// K5 for fp32 inputs: fp32 FMA.
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

// ---------------------------------------------------------------- bf16 path

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdMma {
  static constexpr int kLd = D + mma::kPad;
  static constexpr int kKv = 64;  // kv rows per streamed tile
  static constexpr size_t kSmem = sizeof(mma::bf16) * (kMmaRows + 4 * kKv) * kLd;
};

// K5 on the tensor cores: o and lse of 64 q rows, 16 per warp.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) fwd_mma_kernel(FwdArgs a) {
  using mma::bf16;
  constexpr int LD = FwdMma<D>::kLd, BK = FwdMma<D>::kKv;
  constexpr int NK = BK / 8, ND = D / 8, KD = D / 16;  // n-tiles over kv, over d; k-steps over d
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);  // [64][LD]       read once into registers
  bf16* k_s = q_s + kMmaRows * LD;                 // [2][BK][LD]    two stages
  bf16* v_s = k_s + 2 * BK * LD;                   // [2][BK][LD]

  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int S = a.S, wrow = warp * 16;
  const float scale2 = a.scale * kLog2e;  // s in base-2 units

  auto load_kv_tile = [&](int stage, int kv0) {
    mma::load_rows_async<BK, D, kMmaThreads>(k_s + stage * BK * LD, a.k, b, h, kv0, S);
    mma::load_rows_async<BK, D, kMmaThreads>(v_s + stage * BK * LD, a.v, b, h, kv0, S);
  };

  mma::load_rows_async<kMmaRows, D, kMmaThreads>(q_s, a.q, b, h, q0, S);
  load_kv_tile(0, 0);
  mma::cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
  }
  // running max (base 2) and this lane's share of the running sum, rows g, g + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  uint32_t qa[KD][4];

  const int n_tiles = (S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, kv0 = j * BK;
    mma::cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
    if (j + 1 < n_tiles) load_kv_tile(st ^ 1, kv0 + BK);
    mma::cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma::ldsm_x4(qa[kk], mma::frag_rows16<LD>(q_s, wrow, kk * 16, lane));
      }
    }
    const bf16* kt = k_s + st * BK * LD;
    const bf16* vt = v_s + st * BK * LD;

    // s = q k^T: rows are this warp's q rows, columns kv
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4];
        mma::ldsm_x4(kb, mma::frag_cols16<LD>(kt, n * 8, kk * 16, lane));
        mma::mma_16816(s[n], qa[kk], kb[0], kb[1]);
        mma::mma_16816(s[n + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // scale and mask, then the row max over the tile and the quad
    const bool masked = !all_visible(q0, q0 + kMmaRows, kv0, kv0 + BK, S, a.real_len);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + wrow + g + 8 * (i >> 1);
        const int kv = kv0 + n * 8 + c2 + (i & 1);
        const bool keep = !masked || visible(row, kv, S, a.real_len);
        s[n][i] = keep ? s[n][i] * scale2 : kMaskValue;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      alpha[half] = exp2f(m[half] - mx[half]);  // 0 on the first tile (m = -inf)
      m[half] = mx[half];
      l[half] *= alpha[half];
    }

    // p = exp(s - m) into s, summed into l unrounded
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - m[i >> 1]);
        l[i >> 1] += s[n][i];
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
    }

    // o += bf16(p) v: A from registers, v read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      mma::a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];
        mma::ldsm_x4_t(vb, mma::frag_rows16<LD>(vt, kk * 16, n * 8, lane));
        mma::mma_16816(o[n], pa, vb[0], vb[1]);
        mma::mma_16816(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    inv[half] = l[half] == 0.0f ? 1.0f : 1.0f / l[half];  // the l == 0 guard
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] *= inv[i >> 1];
  }
  mma::store_rows16<ND>(a.o, b, h, q0 + wrow, S, o, lane);
  if (lane % 4 == 0) {
    const long long bh = static_cast<long long>(b) * a.H + h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wrow + g + 8 * half;
      if (row < S) a.lse[bh * S + row] = m[half] * kLn2 + logf(l[half]);
    }
  }
}

// ---------------------------------------------------------------- dispatch

// bf16 inputs take the tensor-core kernel, fp32 inputs the FMA kernel.
template <typename T, int D>
cudaError_t launch_typed(const FwdArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    auto kernel = fwd_mma_kernel<D>;
    const size_t smem = FwdMma<D>::kSmem;
    cudaError_t err = attn::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kMmaRows - 1) / kMmaRows, a.H, a.B);
    kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  } else {
    auto kernel = fwd_kernel<T, D>;
    const size_t smem = sizeof(float) * (2 * D * kLdt + kTile * D + kTile * kLdt);
    cudaError_t err = attn::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
    kernel<<<grid, kThreads, smem, stream>>>(a);
  }
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
