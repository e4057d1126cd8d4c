// Shared definitions of the attention kernels (qk_prep.cu, flash_attn_fwd.cu,
// flash_attn_bwd.cu): element types, loads that convert to fp32, stores that
// round from fp32, and rounding to the input type.
//
// Tensors are [B, H, S, D] views given by element strides of their first
// three axes; the last axis (D) has unit stride. The wrappers check that every
// stride and base address allows the vector loads used here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

// A [B, H, S, D] view with unit stride on D.
struct View {
  const void* p;
  long long sb, sh, ss;
};

struct MutView {
  void* p;
  long long sb, sh, ss;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const View& v, int b, int h, int s) {
  return static_cast<const T*>(v.p) + b * v.sb + h * v.sh + s * v.ss;
}

template <typename T>
__device__ __forceinline__ T* row_ptr(const MutView& v, int b, int h, int s) {
  return static_cast<T*>(v.p) + b * v.sb + h * v.sh + s * v.ss;
}

// x rounded to T and back: the points where the JAX kernels cast to the input
// dtype (a no-op for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Four consecutive elements, converted to fp32 (16 bytes of fp32, 8 of bf16).
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* out);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float* in);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, const float* in) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(in[0], in[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(in[2], in[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory a block may use without opting in.
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
