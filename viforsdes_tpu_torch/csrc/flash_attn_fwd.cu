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
// fp32 inputs keep the first design, fp32-exact: tiles converted to fp32 in
// shared memory, both products fp32 FMA over 4 x 4 register tiles, p through
// shared memory; the ragged tail zero-filled on load and masked.

#include <type_traits>

#include "flash_attn.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- dispatch

// bf16 inputs take the wgmma kernel, fp32 inputs the FMA kernel.
template <typename T, int D>
cudaError_t launch_typed(const FwdArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_wgmma<D>(a, stream);
  } else {
    auto kernel = fwd_kernel<T, D>;
    const size_t smem = sizeof(float) * (2 * D * kLdt + kTile * D + kTile * kLdt);
    cudaError_t err = attn::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
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

template <int D>
void fwd_plan(long long* out) {
  using P = FwdPlan<D>;
  const long long plan[5] = {kWgRows, P::kKv, kWgStages, kWgThreads, static_cast<long long>(P::kSmem)};
  for (int i = 0; i < 5; ++i) out[i] = plan[i];
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

// K5's bf16 plan at head_dim D: {q rows a block, kv rows a stage, stages,
// threads, dynamic shared memory bytes}.
extern "C" int flash_attn_fwd_plan(int D, long long* out) {
  switch (D) {
    case 32: flash::fwd_plan<32>(out); return 0;
    case 64: flash::fwd_plan<64>(out); return 0;
    case 128: flash::fwd_plan<128>(out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
