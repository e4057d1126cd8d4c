// Shared definitions of the fused path-sampler kernels (sde_sampler_fwd.cu,
// sde_sampler_bwd.cu). Streams are time-major fp32, row-major:
//   gates_const [T, B, 3H], eps [T, B, D], paths [T, B, D] (x_{t+1}),
//   raw [T, B, D + n_tril] (mu | raw tril, unclamped), h_all [T, B, L*H].
// Weights are stored [in, out] as in the JAX package (y = x @ W + b); the
// deeper GRU layers (1..L-1) are stacked along a leading [L-1] axis.
#pragma once

#include <cuda_runtime.h>

namespace sde_sampler {

// Shared memory a block may use without opting in.
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Row stride of a packed matrix of n columns: at least n and 8 mod 32, so the
// four parts of a warp (rows 4*jj + part, columns 8 apart in lanes) read 32
// distinct banks.
inline int packed_ld(int n) { return n <= 8 ? 8 : ((n - 8 + 31) / 32) * 32 + 8; }

// ------------------------------------------------ the order of a gate's sum
//
// K1 computes the gates in its time loop and K2's gate pass recomputes them
// from the stashed h; both sum a gate column in this one order, so K2 sees
// K1's gates to the bit:
//  - kGateParts partials: part p chains the input rows i = p, p + kGateParts,
//    ... < n in increasing i by fmaf from 0;
//  - the partials close as a balanced tree, ((p0 + p1) + (p2 + p3)) + ...,
//    across the lanes part * kGateCols + c of a warp that own column c (xor
//    kGateCols pairs neighbouring parts, each further xor the pairs of the
//    level below; addition commutes, so all the column's lanes end with the
//    same bits);
//  - the bias, or gates_const for layer 0's input product, comes last:
//    base + sum.
// The lanes of a warp must all call it (dead columns with zero weights).

constexpr int kGateParts = 4;                // lanes per gate column
constexpr int kGateCols = 32 / kGateParts;   // gate columns a warp sums at once

// sum[q][r][g] = v[q][r, :n] . W_q[:n, column g], for NV products at once (a
// layer's input and hidden products share one loop), NR rows of each vector
// (stride ldv) and the NG columns whose weights of input row i `row(i, w)`
// loads into w[q][g].
template <int NV, int NR, int NG, typename Row>
__device__ __forceinline__ void gate_sums(float (&sum)[NV][NR][NG], const float* const (&v)[NV], int ldv,
                                          int n, Row row) {
  const int part = (threadIdx.x & 31) / kGateCols;
#pragma unroll
  for (int q = 0; q < NV; ++q)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int g = 0; g < NG; ++g) sum[q][r][g] = 0.0f;
#pragma unroll 4
  for (int i = part; i < n; i += kGateParts) {
    float w[NV][NG];
    row(i, w);
#pragma unroll
    for (int q = 0; q < NV; ++q)
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float x = v[q][r * ldv + i];
#pragma unroll
        for (int g = 0; g < NG; ++g) sum[q][r][g] = fmaf(x, w[q][g], sum[q][r][g]);
      }
  }
#pragma unroll
  for (int off = kGateCols; off < 32; off *= 2)
#pragma unroll
    for (int q = 0; q < NV; ++q)
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int g = 0; g < NG; ++g) sum[q][r][g] += __shfl_xor_sync(0xffffffffu, sum[q][r][g], off);
}

// r, z, n of one GRU unit (gate order r, z, n) from its input and hidden
// gate sums, in the one form both kernels use.
__device__ __forceinline__ void gru_gates(float gi_r, float gi_z, float gi_n,
                                          float gh_r, float gh_z, float gh_n,
                                          float& r, float& z, float& n) {
  r = sigmoidf_(gi_r + gh_r);
  z = sigmoidf_(gi_z + gh_z);
  n = tanhf(fmaf(r, gh_n, gi_n));
}

// ------------------------------------------------------------- cp.async

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

// The card's opt-in limit of dynamic shared memory per block.
inline cudaError_t optin_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace sde_sampler
