// Shared definitions of the fused path-sampler kernels (sde_sampler_fwd.cu,
// sde_sampler_bwd.cu). Streams are time-major fp32, row-major:
//   gates_const [T, B, 3H], eps [T, B, D], paths [T, B, D] (x_{t+1}),
//   raw [T, B, D + n_tril] (mu | raw tril, unclamped), h_all [T, B, L*H].
// Weights are stored [in, out] as in the JAX package (y = x @ W + b); the
// deeper GRU layers (1..L-1) are stacked along a leading [L-1] axis.
#pragma once

#include <cuda_runtime.h>

namespace sde_sampler {

// Batch rows one K1 block carries through the whole time loop. Each thread
// keeps ROWS accumulators per gate column, so the weight element it loads is
// used ROWS times. B=128 gives 32 blocks. (K2 takes its rows per block from
// the caller.)
constexpr int ROWS = 4;

// Shared memory a block may use without opting in.
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// One thread per gate column, at least two warps, at most 1024.
inline int threads_for(int gate_cols) {
  int n = ((gate_cols + 31) / 32) * 32;
  if (n < 64) n = 64;
  if (n > 1024) n = 1024;
  return n;
}

// 4 bytes global -> shared without holding the thread; zero-filled when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace sde_sampler
