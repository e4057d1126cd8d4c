// Shared definitions of the fused path-sampler kernels (sde_sampler_fwd.cu,
// sde_sampler_bwd.cu). Streams are time-major fp32, row-major:
//   gates_const [T, B, 3H], eps [T, B, D], paths [T, B, D] (x_{t+1}),
//   raw [T, B, D + n_tril] (mu | raw tril, unclamped), h_all [T, B, L*H].
// Weights are stored [in, out] as in the JAX package (y = x @ W + b); the
// deeper GRU layers (1..L-1) are stacked along a leading [L-1] axis.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sde_sampler {

namespace cg = cooperative_groups;

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

// 16 bytes global -> shared (both 16-byte aligned); zero-filled when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------- clusters
//
// The cluster kernels (fwd_cluster_kernel, bptt_cluster_kernel) split every
// product of a step by its output columns over the C CTAs of a thread-block
// cluster, so that each CTA holds 1/C of the weights in its shared memory:
//  - hidden units: CTA c owns units [c*uc, (c+1)*uc), uc = H / C, a multiple
//    of 8 (its warps' unit groups);
//  - state entries: entry i belongs to CTA `entry_owner(i, C)`, dealt out in
//    a snake (0, 1, .., C-1, C-1, .., 0, 0, ..) so that the rows of the tril
//    table, i + 1 values long, balance; a CTA's output columns are, entry by
//    entry in increasing i, mu_i and then row i of the tril values (its
//    "segment"), padded to `nop` columns, a multiple of 32.
// What a CTA computes that others need travels through distributed shared
// memory (stores into the peers' buffers), one exchange (below) per
// dependent phase. At C = 1 the same kernel runs on a cluster of one CTA.
// Where D < C, some CTAs own no state entry (their entry slots hold -1) and
// only compute their units and share the products.
//
// Clusters of up to 8 CTAs are portable on Hopper; 16 is not, and a kernel
// is launched or queried at 16 only after it allows it (`allow_cluster`).

constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;

// Threads of a cluster kernel's CTA, at most: 24 warps leave ptxas 85
// registers a thread (at 1024 the rows' accumulators spilled).
constexpr int kClusterThreads = 768;

__host__ __device__ inline int entry_owner(int i, int C) {
  const int q = i % (2 * C);
  return q < C ? q : 2 * C - 1 - q;
}

// tril values in row i of the Cholesky factor
__host__ __device__ inline int row_values(int i, int diag) { return diag ? 1 : i + 1; }

// The output columns and state entries of CTA c: `cols` = sum of 1 + row
// values over its entries, `entries` = how many it owns.
inline void cta_columns(int D, int diag, int C, int c, int* cols, int* entries) {
  *cols = 0;
  *entries = 0;
  for (int i = 0; i < D; ++i)
    if (entry_owner(i, C) == c) {
      *cols += 1 + row_values(i, diag);
      *entries += 1;
    }
}

// The widest CTA's columns, padded to whole warps, and the most entries a CTA
// owns.
inline void cluster_columns(int D, int diag, int C, int* nop, int* slots) {
  int most = 0, entries = 0;
  *slots = 0;
  for (int c = 0; c < C; ++c) {
    int cols = 0;
    cta_columns(D, diag, C, c, &cols, &entries);
    most = cols > most ? cols : most;
    *slots = entries > *slots ? entries : *slots;
  }
  *nop = (most + 31) / 32 * 32;
}

// Ints of one CTA's row of the layout the caller passes (`cluster_layout`
// in ops/sde_sampler.py): ocol[nop] (the global output column of each local
// column, -1 past its own), erow[slots] (its state entries, -1 past its
// own), eseg[slots] (the local column of each one's mu), mslot[nop] and
// mj[nop] (each local column's entry slot and tril column j, -1 for mu),
// jslot[D] (the slot of every state entry in the CTA that owns it).
__host__ __device__ inline int layout_width(int D, int nop, int slots) { return 3 * nop + 2 * slots + D; }

// Rows a cluster (or a lone block) carries: 1, 2, 4 or a multiple of 4.
inline int round_rows(int rows) {
  if (rows <= 2) return rows < 1 ? 1 : rows;
  if (rows <= 4) return 4;
  return (rows + 3) / 4 * 4;
}

// The largest of those not above `rows`.
inline int floor_rows(int rows) {
  if (rows >= 4) return rows / 4 * 4;
  return rows >= 2 ? 2 : 1;
}

// The row rule (`cluster_rows` in ops/sde_sampler.py): the fewest rows a
// cluster (a lone block on the one-block paths) that keep the clusters of a
// batch of B within one wave of the `per_wave` clusters the card runs at
// once; where `max_rows` (what shared memory and the threads allow) cannot,
// the fewest waves, with the rows spread evenly over them.
inline int cluster_waves(int B, int per_wave, int max_rows) {
  per_wave = per_wave > 0 ? per_wave : 1;
  return (B + per_wave * max_rows - 1) / (per_wave * max_rows);
}

inline int cluster_rows(int B, int per_wave, int max_rows) {
  per_wave = per_wave > 0 ? per_wave : 1;
  const int waves = cluster_waves(B, per_wave, max_rows);
  const int rows = round_rows((B + per_wave * waves - 1) / (per_wave * waves));
  return rows < max_rows ? rows : max_rows;
}

// The card's multiprocessors.
inline cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

// A barrier of every thread of the cluster that orders the stores into the
// peers' shared memory before it against the reads after it (a block barrier
// at C = 1).
__device__ __forceinline__ void cluster_barrier(int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// ------------------------------------------------------------- exchanges
//
// Inside the time loops a value goes to a peer (or to the CTA itself) by
// st.async: the store into the peer's shared memory counts its 4 bytes on
// an mbarrier there, and each CTA waits on its own mbarrier until the bytes
// it expects from the whole cluster have landed. A cluster barrier would
// order the same stores, but its arrival fences all of the thread's memory
// traffic at GPU scope (MEMBAR.ALL.GPU: about 1000 cycles an arrival in K1
// at H=128) and its wait invalidates L1; an exchange makes no one wait but
// the reader, for the bytes it reads. Exchanges count their bytes on two
// mbarriers in turn (exchange k on mbarrier k & 1, phase k / 2), and thread
// 0 posts the bytes of exchange k + 2 once it has seen exchange k complete:
// a peer sends into exchange k + 2 only once it holds all of exchange
// k + 1, and every CTA sends its part of k + 1 only after all of its
// threads have seen k complete (every warp sends into an exchange that
// follows a wait without a block barrier between, and a warp leaves the
// wait together), so no byte lands in the wrong phase and no buffer is
// overwritten while it is read.

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of the same offset in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Static shared memory of a cluster kernel: the exchanges' two mbarriers. A
// plan's dynamic shared memory fits `optin` less these.
constexpr size_t kExchangeSmem = 2 * sizeof(uint64_t);

struct Exchanges {
  uint64_t* bar;  // [2] mbarriers in shared memory
  int done;       // exchanges completed

  // Thread 0, before the cluster's first barrier: both mbarriers, and the
  // bytes of the first two exchanges.
  __device__ void init(uint32_t bytes0, uint32_t bytes1) {
    done = 0;
    if (threadIdx.x != 0) return;
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(shared_addr(bar + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect(0, bytes0);
    expect(1, bytes1);
  }

  __device__ void expect(int i, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(shared_addr(bar + i)), "r"(bytes) : "memory");
  }

  // v into buf[idx] of CTA `rank`, counted on that CTA's mbarrier of the
  // current exchange.
  __device__ __forceinline__ void send(float* buf, size_t idx, int rank, float v) const {
    const uint32_t dst = peer_addr(shared_addr(buf + idx), rank);
    const uint32_t mbar = peer_addr(shared_addr(bar + (done & 1)), rank);
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                 :: "r"(dst), "r"(__float_as_uint(v)), "r"(mbar) : "memory");
  }

  // Every thread: wait until the current exchange has landed here (a wait
  // that never ends traps after 2^26 polls, seconds beyond any real one,
  // instead of hanging the card); thread 0 then posts the bytes of the
  // exchange two later, `bytes_next2`.
  __device__ void finish(uint32_t bytes_next2) {
    const uint32_t mbar = shared_addr(bar + (done & 1)), parity = (done >> 1) & 1;
    for (uint32_t polls = 0;; ++polls) {
      uint32_t ok;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(ok) : "r"(mbar), "r"(parity) : "memory");
      if (ok) break;
      if (polls == (1u << 26)) __trap();
    }
    __syncwarp();  // no lane sends into the next exchange before its whole warp has seen this one
    if (threadIdx.x == 0) expect(done & 1, bytes_next2);
    ++done;
  }
};

// Clusters above kPortableCluster CTAs need the kernel's leave, before the
// occupancy query and before the launch.
template <typename Kernel>
inline cudaError_t allow_cluster(Kernel kernel, int C) {
  if (C <= kPortableCluster) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Launch `kernel` on `clusters` clusters of C CTAs.
template <typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Args...), int clusters, int C, int threads, size_t smem,
                                   cudaStream_t stream, Args... args) {
  cudaError_t err = allow_cluster(kernel, C);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// How many clusters of C CTAs of `kernel` (`threads`, `smem` bytes each) the
// card holds at once: at most n_sms / C, fewer where the multiprocessors of
// a GPC do not divide into whole clusters (30 clusters of 4 and 15 of 8 on
// an H100 SXM at one CTA a multiprocessor).
template <typename... Args>
inline cudaError_t max_active_clusters(void (*kernel)(Args...), int C, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = allow_cluster(kernel, C);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
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
