// The SiT's norm site in one pass: the adaLN-Zero gated residual, the
// non-affine LayerNorm and the adaLN modulation, forward and backward.
//
// Replaces no TPU kernel: under `jit` XLA fused the chain, and eager PyTorch
// runs it as some 18 launches forward and 40 backward a site
// (viforsdes_tpu_torch/ops/sit.py, ops/cond.py, ops/norms.py). Per token row
// of H elements of sample b, with gate, scale and shift the [B, 1, H]
// broadcast chunks of the cond modulator:
//   forward   x_new = x + gate*y (x_new = x without a residual),
//             m = (1+scale) * LN(x_new) + shift, the statistics in fp32,
//             mean and rsqrt rounded to T before the subtract and the
//             multiply, every elementwise result rounded to T where the
//             eager ops round (ops/norms.py layer_norm); saves fp32
//             (mean, rstd) per row;
//   backward  n = (x_new - mean)*rstd and g = dm*(1+scale) in fp32,
//             d = dx_new + rstd*(g - mean(g) - n*mean(g*n)),
//             dx = d, dy = d*gate, one rounding each; per-CTA partial sums
//             of dscale = sum_s dm*n, dshift = sum_s dm, dgate = sum_s d*y
//             into fp32 scratch [B, chunks, 3, H], summed over the chunks
//             in a fixed order by a second launch (no atomics, so a graph
//             replay gives the same bits).
//
// What bounds it on an H100: memory. A site reads x and y and writes x_new
// and m (4 activations), its backward reads dm, dx_new, x_new and y and
// writes dx and dy (6): 10 activations of [B, S, H], 328 MB in bf16 at the
// Lorenz shape [32, 2001, 256], 98 us at 3.35 TB/s; a few FMAs per element.
//
// Design: one warp per token row, each lane holding H/32 elements as 16-byte
// vectors (lane l's v-th vector at v*32*VEC + l*VEC, so every vector load of
// a warp is 512 contiguous bytes); the row sums are warp shuffles. A CTA
// owns `rows` consecutive rows of one sample (the wrapper's ROWS_PER_CTA,
// 64: a grid of ceil(S / 64) x B CTAs), so it loads that sample's
// modulation vectors once into registers, and in the backward sums its rows'
// parameter gradients in registers and then across its warps through shared
// memory in a fixed order.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace adaln {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 256;  // H: the one width built (every configuration's)
constexpr int kPerLane = kWidth / 32;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(&w[i]) = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// x rounded to T and back (a no-op for fp32): where the eager ops round.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Element i of a lane's slice sits at column (i / N) * 32 * N + lane * N + i % N.
template <typename T>
__device__ __forceinline__ int column(int lane, int v) {
  return v * 32 * Vec<T>::N + lane * Vec<T>::N;
}

template <typename T>
__device__ __forceinline__ void load_row(const T* row, int lane, float* out) {
#pragma unroll
  for (int v = 0; v < kPerLane / Vec<T>::N; ++v) Vec<T>::load(row + column<T>(lane, v), out + v * Vec<T>::N);
}

template <typename T>
__device__ __forceinline__ void store_row(T* row, int lane, const float* in) {
#pragma unroll
  for (int v = 0; v < kPerLane / Vec<T>::N; ++v) Vec<T>::store(row + column<T>(lane, v), in + v * Vec<T>::N);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct FwdArgs {
  const void* x;      // [B, S, H], contiguous
  const void* y;      // [B, S, H] or null (no residual)
  const void* gate;   // rows of H, sample b at b * s_gate
  const void* scale;
  const void* shift;
  long long s_gate, s_scale, s_shift;
  void* x_new;        // [B, S, H]; unused without a residual
  void* m;            // [B, S, H]
  float2* stats;      // [B, S]: fp32 (mean, rstd)
  int S, rows;
  float eps;
};

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads) forward_kernel(FwdArgs a) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = blockIdx.x * a.rows;
  const int last = min(first + a.rows, a.S);

  float gate[kPerLane], scale1[kPerLane], shift[kPerLane];
  if (kResidual) load_row(static_cast<const T*>(a.gate) + b * a.s_gate, lane, gate);
  load_row(static_cast<const T*>(a.scale) + b * a.s_scale, lane, scale1);
  load_row(static_cast<const T*>(a.shift) + b * a.s_shift, lane, shift);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) scale1[i] = round_to<T>(__fadd_rn(1.0f, scale1[i]));  // (1 + scale) in T

  for (int s = first + warp; s < last; s += kWarps) {
    const long long off = (static_cast<long long>(b) * a.S + s) * kWidth;
    float x[kPerLane];
    load_row(static_cast<const T*>(a.x) + off, lane, x);
    if (kResidual) {
      float y[kPerLane];
      load_row(static_cast<const T*>(a.y) + off, lane, y);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) x[i] = round_to<T>(__fadd_rn(x[i], round_to<T>(__fmul_rn(y[i], gate[i]))));
      store_row(static_cast<T*>(a.x_new) + off, lane, x);
    }
    float sum = 0.0f, sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      sum += x[i];
      sq += x[i] * x[i];
    }
    const float mean = warp_sum(sum) / static_cast<float>(kWidth);
    const float var = __fsub_rn(warp_sum(sq) / static_cast<float>(kWidth), __fmul_rn(mean, mean));
    const float rstd = 1.0f / sqrtf(__fadd_rn(fmaxf(var, 0.0f), a.eps));
    const float mean_t = round_to<T>(mean), rstd_t = round_to<T>(rstd);
    float m[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float n = round_to<T>(__fmul_rn(round_to<T>(__fsub_rn(x[i], mean_t)), rstd_t));
      m[i] = __fadd_rn(round_to<T>(__fmul_rn(scale1[i], n)), shift[i]);
    }
    store_row(static_cast<T*>(a.m) + off, lane, m);
    if (lane == 0) a.stats[static_cast<long long>(b) * a.S + s] = make_float2(mean, rstd);
  }
}

struct BwdArgs {
  const void* x_new;   // [B, S, H]
  const void* y;       // [B, S, H] or null (no residual)
  const void* gate;
  const void* scale;
  long long s_gate, s_scale;
  const float2* stats; // [B, S]
  const void* dm;      // [B, S, H]
  const void* dx_new;  // [B, S, H]; unused without a residual
  void* dx;            // [B, S, H]
  void* dy;            // [B, S, H]; unused without a residual
  float* partial;      // [B, chunks, NQ, H]: dscale, dshift[, dgate]
  void* dmod;          // [NQ, B, H] in T
  int B, S, rows, chunks;
};

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads) backward_kernel(BwdArgs a) {
  constexpr int NQ = kResidual ? 3 : 2;
  __shared__ float red[kWarps][NQ][kWidth];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = blockIdx.x * a.rows;
  const int last = min(first + a.rows, a.S);

  float gate[kPerLane], scale1[kPerLane];
  if (kResidual) load_row(static_cast<const T*>(a.gate) + b * a.s_gate, lane, gate);
  load_row(static_cast<const T*>(a.scale) + b * a.s_scale, lane, scale1);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) scale1[i] = round_to<T>(__fadd_rn(1.0f, scale1[i]));  // as the forward used it

  float acc[NQ][kPerLane];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[q][i] = 0.0f;

  for (int s = first + warp; s < last; s += kWarps) {
    const long long r = static_cast<long long>(b) * a.S + s;
    const long long off = r * kWidth;
    const float2 st = a.stats[r];
    float n[kPerLane], g[kPerLane], ext[kPerLane], y[kPerLane];
    load_row(static_cast<const T*>(a.x_new) + off, lane, n);
    load_row(static_cast<const T*>(a.dm) + off, lane, g);
    if (kResidual) {
      load_row(static_cast<const T*>(a.dx_new) + off, lane, ext);
      load_row(static_cast<const T*>(a.y) + off, lane, y);
    }
    float sum_g = 0.0f, sum_gn = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      n[i] = (n[i] - st.x) * st.y;
      acc[0][i] += g[i] * n[i];
      acc[1][i] += g[i];
      g[i] *= scale1[i];
      sum_g += g[i];
      sum_gn += g[i] * n[i];
    }
    const float mean_g = warp_sum(sum_g) / static_cast<float>(kWidth);
    const float mean_gn = warp_sum(sum_gn) / static_cast<float>(kWidth);
    float d[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) d[i] = st.y * (g[i] - mean_g - n[i] * mean_gn);
    if (kResidual) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        d[i] += ext[i];
        acc[NQ - 1][i] += d[i] * y[i];
        y[i] = d[i] * gate[i];
      }
      store_row(static_cast<T*>(a.dy) + off, lane, y);
    }
    store_row(static_cast<T*>(a.dx) + off, lane, d);
  }

  // the CTA's sum over its warps, in warp order
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int v = 0; v < kPerLane / Vec<T>::N; ++v)
#pragma unroll
      for (int j = 0; j < Vec<T>::N; ++j) red[warp][q][column<T>(lane, v) + j] = acc[q][v * Vec<T>::N + j];
  __syncthreads();
  float* out = a.partial + (static_cast<long long>(b) * a.chunks + blockIdx.x) * NQ * kWidth;
  for (int k = threadIdx.x; k < NQ * kWidth; k += kThreads) {
    const int q = k / kWidth, h = k % kWidth;
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w][q][h];
    out[k] = total;
  }
}

// dmod[q, b, h] = sum over the chunks, in chunk order, of partial[b, c, q, h].
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(const float* partial, T* dmod, int B, int chunks, int nq) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= static_cast<long long>(nq) * B * kWidth) return;
  const int h = static_cast<int>(k % kWidth);
  const int b = static_cast<int>((k / kWidth) % B);
  const int q = static_cast<int>(k / (static_cast<long long>(kWidth) * B));
  const float* p = partial + static_cast<long long>(b) * chunks * nq * kWidth + q * kWidth + h;
  float total = 0.0f;
  for (int c = 0; c < chunks; ++c) total += p[static_cast<long long>(c) * nq * kWidth];
  dmod[k] = from_float<T>(total);
}

inline int n_chunks(int S, int rows) { return (S + rows - 1) / rows; }

template <typename T>
cudaError_t forward(const FwdArgs& a, int B, cudaStream_t st) {
  const dim3 grid(n_chunks(a.S, a.rows), B);
  if (a.y != nullptr) {
    forward_kernel<T, true><<<grid, kThreads, 0, st>>>(a);
  } else {
    forward_kernel<T, false><<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const BwdArgs& a, cudaStream_t st) {
  const dim3 grid(a.chunks, a.B);
  const bool residual = a.y != nullptr;
  if (residual) {
    backward_kernel<T, true><<<grid, kThreads, 0, st>>>(a);
  } else {
    backward_kernel<T, false><<<grid, kThreads, 0, st>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nq = residual ? 3 : 2;
  const long long outputs = static_cast<long long>(nq) * a.B * kWidth;
  const unsigned blocks = static_cast<unsigned>((outputs + kThreads - 1) / kThreads);
  reduce_kernel<T><<<blocks, kThreads, 0, st>>>(a.partial, static_cast<T*>(a.dmod), a.B, a.chunks, nq);
  return cudaGetLastError();
}

}  // namespace adaln

extern "C" int adaln_norm_fwd(
    const void* x, const void* y, const void* gate, long long s_gate,
    const void* scale, long long s_scale, const void* shift, long long s_shift,
    void* x_new, void* m, void* stats,
    int B, int S, int H, int rows, int is_bf16, float eps, void* stream) {
  if (H != adaln::kWidth || B <= 0 || S <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const adaln::FwdArgs a{x, y, gate, scale, shift, s_gate, s_scale, s_shift, x_new, m,
                         static_cast<float2*>(stats), S, rows, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? adaln::forward<__nv_bfloat16>(a, B, st) : adaln::forward<float>(a, B, st));
}

extern "C" int adaln_norm_bwd(
    const void* x_new, const void* y, const void* gate, long long s_gate,
    const void* scale, long long s_scale, const void* stats,
    const void* dm, const void* dx_new, void* dx, void* dy, void* partial, void* dmod,
    int B, int S, int H, int rows, int is_bf16, void* stream) {
  if (H != adaln::kWidth || B <= 0 || S <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const adaln::BwdArgs a{x_new, y, gate, scale, s_gate, s_scale, static_cast<const float2*>(stats),
                         dm, dx_new, dx, dy, static_cast<float*>(partial), dmod,
                         B, S, rows, adaln::n_chunks(S, rows)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? adaln::backward<__nv_bfloat16>(a, st) : adaln::backward<float>(a, st));
}
