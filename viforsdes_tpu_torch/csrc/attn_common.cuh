// Shared definitions of the attention kernels (qk_prep.cu, flash_attn_fwd.cu,
// flash_attn_bwd.cu): element types, the store that rounds from fp32,
// rounding to the input type, and the shared-memory opt-in.
//
// Tensors are [B, H, S, D] views given by element strides of their first
// three axes; the last axis (D) has unit stride. The wrappers check that every
// stride and base address allows the kernels' vector loads and TMA.
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

// Two consecutive elements, rounded from fp32.
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
