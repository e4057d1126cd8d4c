// K3 / K4: fused QK-RMSNorm + RoPE, forward and backward.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// viforsdes_tpu/ops/pallas/qk_prep.py (launched by `qk_prep` and
// `_qk_prep_bwd`). Per row x of D elements (one head of one token):
//   forward   r = rsqrt(mean(x^2) + eps) in fp32, xn = x * T(r) rounded to T,
//             RoPE on the [real | imag] halves in fp32, out rounded to T;
//   backward  dn = RoPE^T(dy), dx = r*dn - x * r^3 * sum(dn*x) / D,
//             with r recomputed from the raw x (nothing normalized is saved).
//
// What bounds it on an H100: memory. Each pass reads x (and dy) and writes one
// tensor, about 33 MB per pass at the Lorenz shape [32, 4, 2001, 64] in bf16,
// some 10-20 us at 3.35 TB/s; the arithmetic is a few FMAs per byte.
//
// Design: a row is split between TPR = D / (2 * VEC) threads of one warp, each
// holding VEC elements of the real half and the VEC matching elements of the
// imaginary half, so a rotation pair never leaves its thread. Every load and
// store is 16 bytes (VEC = 8 bf16 or 4 fp32); the row sums are shuffle
// reductions inside the row's lane group. x and dy are read through their
// strides, so q and k come straight from the QKV projection's output without
// a copy; the output is written through its own strides.

#include <cstdint>

#include "attn_common.cuh"

namespace qk_prep {

using attn::MutView;
using attn::View;

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

constexpr int kThreads = 256;

struct Args {
  View x;        // [B, H, S, D]
  View dy;       // backward only
  MutView out;   // y (forward) or dx (backward)
  const float* cos;  // [S, D/2] fp32, contiguous
  const float* sin;
  int B, H, S;
  float eps;
};

template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D, bool kBackward>
__global__ void __launch_bounds__(kThreads) qk_prep_kernel(Args a) {
  constexpr int F = D / 2, V = Vec<T>::N, TPR = F / V;
  static_assert(F % V == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "row split");
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = g / TPR;
  const int j0 = static_cast<int>(g % TPR) * V;
  const bool live = row < static_cast<long long>(a.B) * a.H * a.S;

  int b = 0, h = 0, s = 0;
  float xr[V], xi[V], c[V], sn[V];
#pragma unroll
  for (int i = 0; i < V; ++i) xr[i] = xi[i] = c[i] = sn[i] = 0.0f;
  if (live) {
    s = static_cast<int>(row % a.S);
    const long long bh = row / a.S;
    h = static_cast<int>(bh % a.H);
    b = static_cast<int>(bh / a.H);
    const T* xp = attn::row_ptr<T>(a.x, b, h, s);
    Vec<T>::load(xp + j0, xr);
    Vec<T>::load(xp + F + j0, xi);
    const float* cp = a.cos + static_cast<long long>(s) * F + j0;
    const float* sp = a.sin + static_cast<long long>(s) * F + j0;
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      Vec<float>::load(cp + i, c + i);
      Vec<float>::load(sp + i, sn + i);
    }
  }
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) sq += xr[i] * xr[i] + xi[i] * xi[i];
  // every lane takes part in the shuffles; dead rows sum zeros
  const float ms = row_sum<TPR>(sq) / static_cast<float>(D);
  const float r = 1.0f / sqrtf(ms + a.eps);

  float yr[V], yi[V];
  if (!kBackward) {
    const float scale = attn::round_to<T>(r);  // rms_norm casts the scale first
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float re = attn::round_to<T>(__fmul_rn(xr[i], scale));
      const float im = attn::round_to<T>(__fmul_rn(xi[i], scale));
      yr[i] = __fsub_rn(__fmul_rn(re, c[i]), __fmul_rn(im, sn[i]));
      yi[i] = __fadd_rn(__fmul_rn(re, sn[i]), __fmul_rn(im, c[i]));
    }
  } else {
    float dr[V], di[V];
#pragma unroll
    for (int i = 0; i < V; ++i) dr[i] = di[i] = 0.0f;
    if (live) {
      const T* dp = attn::row_ptr<T>(a.dy, b, h, s);
      Vec<T>::load(dp + j0, dr);
      Vec<T>::load(dp + F + j0, di);
    }
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float nr = dr[i] * c[i] + di[i] * sn[i];   // rotation by -theta
      const float ni = -dr[i] * sn[i] + di[i] * c[i];
      dr[i] = nr;
      di[i] = ni;
      dot += nr * xr[i] + ni * xi[i];
    }
    const float k = r * r * r * (row_sum<TPR>(dot) / static_cast<float>(D));
#pragma unroll
    for (int i = 0; i < V; ++i) {
      yr[i] = r * dr[i] - xr[i] * k;
      yi[i] = r * di[i] - xi[i] * k;
    }
  }
  if (live) {
    T* op = attn::row_ptr<T>(a.out, b, h, s);
    Vec<T>::store(op + j0, yr);
    Vec<T>::store(op + F + j0, yi);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const Args& a, bool backward, cudaStream_t stream) {
  constexpr int TPR = D / 2 / Vec<T>::N;
  const long long threads = static_cast<long long>(a.B) * a.H * a.S * TPR;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (blocks == 0) return cudaSuccess;
  if (backward) {
    qk_prep_kernel<T, D, true><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    qk_prep_kernel<T, D, false><<<blocks, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int D, bool backward, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_typed<T, 32>(a, backward, stream);
    case 64: return launch_typed<T, 64>(a, backward, stream);
    case 128: return launch_typed<T, 128>(a, backward, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(const Args& a, int D, int is_bf16, bool backward, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, D, backward, st) : launch<float>(a, D, backward, st);
}

}  // namespace qk_prep

extern "C" int qk_prep_fwd(
    const void* x, long long sxb, long long sxh, long long sxs,
    const float* cos, const float* sin,
    void* out, long long sob, long long soh, long long sos,
    int B, int H, int S, int D, int is_bf16, float eps, void* stream) {
  qk_prep::Args a{{x, sxb, sxh, sxs}, {nullptr, 0, 0, 0}, {out, sob, soh, sos},
                  cos, sin, B, H, S, eps};
  return static_cast<int>(qk_prep::run(a, D, is_bf16, false, stream));
}

extern "C" int qk_prep_bwd(
    const void* x, long long sxb, long long sxh, long long sxs,
    const void* dy, long long syb, long long syh, long long sys,
    const float* cos, const float* sin,
    void* dx, long long sdb, long long sdh, long long sds,
    int B, int H, int S, int D, int is_bf16, float eps, void* stream) {
  qk_prep::Args a{{x, sxb, sxh, sxs}, {dy, syb, syh, sys}, {dx, sdb, sdh, sds},
                  cos, sin, B, H, S, eps};
  return static_cast<int>(qk_prep::run(a, D, is_bf16, true, stream));
}
