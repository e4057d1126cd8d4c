// K1: forward of the fused GRU path sampler.
//
// Replaces the TPU kernel `_fwd_kernel` of viforsdes_tpu/ops/pallas/sde_sampler.py
// (launched by `FusedPathSampler._forward`). Per step t and batch row:
//   layer-0 gates  = gates_const[t] + x_t @ W_x          (context/theta hoisted out)
//   L GRU layers   (gate order r, z, n), h kept on chip across the time loop
//   out            = h_top @ W_out + b_out = [mu | raw tril]
//   vals           = raw tril with the diagonal clamped at diag_min
//   x_{t+1}        = x_t + mu*dt + (L_t eps_t)*sqrt(dt), L_t eps_t from the
//                    tril row/col index tables (no D x D matrix)
// and writes paths, raw and (for training) h of every layer.
//
// Two kernels, chosen by shape in `make_fwd_plan`: `fwd_kernel`, one block
// per 1, 2 or 4 rows, where the weights fit one block's shared memory (the
// OU and Lorenz heads) or, streamed from device memory, where nothing else
// fits (H=256 at two layers); and `fwd_cluster_kernel` (below), a
// thread-block cluster of 2 to 16 CTAs holding the weights between them,
// where they fit a cluster (a 32-dimensional state, H=64 with three layers,
// H=96; H=128 at clusters of 8 or 16).
//
// What bounds it on an H100: not the roofline. At B=32, T=2000 it does 4.9
// GFLOP in 2000 dependent steps, so what counts is the latency of one step:
// a chain of dependent phases (each layer's gate sums and nonlinearities,
// the output projection, the Euler update) joined by block barriers. The
// matvecs themselves (the GRU's 3H x (in + H) per layer, read from shared
// memory) are the smaller part of it at H=64 (PERF.md, section 6).
//
// Design of fwd_kernel: one block per `R` batch rows (1, 2 or 4, chosen by
// the plan) runs the whole time loop; blocks are independent rows, so no
// cross-block order is needed.
//  - The weights, packed by the caller (`pack_forward_weights`) unit-major
//    (per input row, per hidden unit k: the float4 {r, z, n, 0} of columns
//    k, H+k, 2H+k, so the 8 units of a warp's part read one 128-byte row
//    segment; the biases as two more rows per layer; W_out^T with a padded
//    row stride), are staged in shared memory once per block when they
//    fit the card's opt-in limit (H=64, L=2: 206 KB). Otherwise, chosen by
//    shape in `make_fwd_plan`, the same loop reads them from device memory.
//  - gates_const[t+1] and eps[t+1] arrive by cp.async into a second stage
//    while step t computes.
//  - Unit-major split matvecs: each warp owns kUnitsPerWarp hidden units,
//    kGateParts lanes a unit (`gate_sums`, the order K2's gate pass shares;
//    a deeper layer's input and hidden products run in one loop). The lanes
//    of unit k hold all six of its gate sums, so the GRU update of h_k runs in
//    registers and one barrier per layer publishes the layer's new h (h is
//    double-buffered by step).
//  - The top layer's lanes fold the output projection into their phase
//    (per-warp partials over their units, by shuffles); one more warp
//    sums the partials, writes raw and runs the Euler update while the other
//    warps compute the next step's layer-0 hidden product, which depends
//    only on h_0(t). At H > 248 the 32 unit warps fill the block's 1024
//    threads: the last unit warp then runs the output phase itself, after
//    the top layer's barrier and before its own layer-0 hidden product
//    (the same sums in the same order, so the same bits).
//  - L + 1 barriers per step: one for the stage and x_t, one per layer.
// All arithmetic is plain fp32 FMA (no tensor cores, no TF32), no atomics:
// the result does not depend on R and is bitwise reproducible run to run.
// The ragged last block computes on zero rows and stores nothing for them.

#include "sde_sampler.cuh"

namespace sde_sampler {

struct FwdArgs {
  const float* x0;       // [B, D]
  const float* gc;       // [T, B, 3H]
  const float* eps;      // [T, B, D]
  const float* w;        // the packed weights (pack_forward_weights)
  const int* tril_rows;  // [n_tril]
  const int* tril_cols;  // [n_tril]
  float* paths;          // [T, B, D]
  float* raw;            // [T, B, D + n_tril]
  float* chol;           // [T, B, n_tril]  the tril values, diagonal clamped (the cluster path)
  float* h_all;          // [T, B, L*H] or nullptr
  const int* layout;     // the cluster path: per CTA its output columns and entries (cluster_layout)
  int B, T, D, H, L, n_tril, diag;
  float dt, sqrt_dt, diag_min;
};

constexpr int kUnitsPerWarp = kGateCols;  // hidden units a warp owns, kGateParts lanes each
// The kernel is built for two bounds on its threads: up to H=64 (8 warps of
// units and the output warp) it may take 224 registers a thread; the wide
// build, up to H=256 (32 warps of units), takes 64.
constexpr int kNarrowThreads = 32 * (64 / kUnitsPerWarp + 1);
constexpr int kWideThreads = 1024;
constexpr int kMaxHidden = kWideThreads / 32 * kUnitsPerWarp;  // 256

struct BlockFwdPlan {
  int units;        // H rounded up to 8 (the packed row length, in float4)
  int ld_out;       // row stride of the packed W_out^T
  int groups;       // warps that own hidden units
  int out_warp;     // the warp of the output phase: one more, or the last unit warp at H > 248
  int threads;
  int staged;       // 1: the packed weights live in shared memory
  size_t smem;      // dynamic shared memory at this plan
  size_t smem_staged, smem_streaming;
  size_t w_floats;  // floats of the packed weights
};

// float4 rows of layer l's packed block: its input rows, H hidden rows, the
// input and the hidden bias.
__host__ __device__ inline size_t layer_rows(int l, int D, int H) { return (l == 0 ? D : H) + H + 2; }

__host__ __device__ inline size_t layer_offset4(int l, int D, int H, int units) {
  return l == 0 ? 0 : units * (layer_rows(0, D, H) + (size_t)(l - 1) * layer_rows(1, D, H));
}

// The launch of fwd_kernel for a shape at `rows` batch rows per block: staged
// when the packed weights and the rest fit `optin` bytes of shared memory,
// unless `staged` is 0.
inline cudaError_t make_block_fwd_plan(int D, int H, int L, int n_tril, int rows, int staged, int optin,
                                       BlockFwdPlan* p) {
  const size_t NO = (size_t)D + n_tril, LH = (size_t)L * H;
  if (H > kMaxHidden) return cudaErrorInvalidValue;  // one warp per kUnitsPerWarp units
  p->groups = (H + kUnitsPerWarp - 1) / kUnitsPerWarp;
  const int warps = 32 * (p->groups + 1) <= kWideThreads ? p->groups + 1 : p->groups;
  p->out_warp = warps - 1;
  p->units = (H + 7) / 8 * 8;
  p->ld_out = packed_ld(p->units);  // the parts of a warp read one W_out^T row each
  p->threads = 32 * warps;
  const size_t out4 = (NO * p->ld_out + NO + 3) / 4;  // W_out^T and b_out, in float4
  p->w_floats = 4 * (layer_offset4(L, D, H, p->units) + out4);
  const size_t work = 2 * (size_t)rows * (3 * H + D) + 2 * rows * LH + rows * (size_t)D +
                      rows * NO + (size_t)p->groups * rows * NO + rows * (size_t)n_tril;
  p->smem_streaming = sizeof(float) * work + sizeof(int) * 2 * n_tril;
  p->smem_staged = p->smem_streaming + sizeof(float) * p->w_floats;
  const int fits = p->smem_staged <= (size_t)optin ? 1 : 0;
  if (staged == 1 && !fits) return cudaErrorInvalidValue;
  p->staged = staged == 0 ? 0 : fits;
  p->smem = p->staged ? p->smem_staged : p->smem_streaming;
  return cudaSuccess;
}

template <int R, bool kStaged, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) fwd_kernel(FwdArgs a, BlockFwdPlan p) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, G = 3 * a.H, L = a.L, D = a.D, LH = a.L * a.H, NT = a.n_tril;
  const int NO = a.D + a.n_tril, SR = G + a.D, U = p.units;
  float* w_s = smem;                                    // packed weights (staged)
  float* stage_s = smem + (kStaged ? p.w_floats : 0);   // [2][R][SR] gates_const | eps of a step
  float* h_s = stage_s + 2 * R * SR;                    // [2][R][LH] h(t-1) and h(t), by step parity
  float* x_s = h_s + 2 * R * LH;                        // [R][D]  x_t
  float* out_s = x_s + R * D;                           // [R][NO] mu | raw tril
  float* part_s = out_s + R * NO;                       // [groups][R][NO] output partials
  float* term_s = part_s + p.groups * R * NO;           // [R][NT] the terms of L eps
  int* trow_s = reinterpret_cast<int*>(term_s + R * NT);
  int* tcol_s = trow_s + NT;

  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int part = lane / kUnitsPerWarp;
  const int k = warp * kUnitsPerWarp + lane % kUnitsPerWarp;  // this lane's hidden unit
  const bool unit_warp = warp < p.groups;                     // owns hidden units
  const bool out_warp = warp == p.out_warp;                   // runs the output phase
  const bool live = unit_warp && k < H;
  const unsigned part_mask = ((1u << kUnitsPerWarp) - 1) << (kUnitsPerWarp * part);
  const int b0 = blockIdx.x * R;

  if (kStaged) {
    const float4* src = reinterpret_cast<const float4*>(a.w);
    float4* dst = reinterpret_cast<float4*>(w_s);
    for (size_t i = tid; i < p.w_floats / 4; i += nt) dst[i] = src[i];
  }
  for (int i = tid; i < R * LH; i += nt) h_s[i] = 0.0f;
  for (int i = tid; i < R * D; i += nt) {
    const int b = b0 + i / D;
    x_s[i] = b < a.B ? a.x0[(size_t)b * D + i % D] : 0.0f;
  }
  for (int i = tid; i < NT; i += nt) {
    trow_s[i] = a.tril_rows[i];
    tcol_s[i] = a.tril_cols[i];
  }
  const float* w_base = kStaged ? w_s : a.w;
  const float4* wp = reinterpret_cast<const float4*>(w_base);
  const float* w_oT = w_base + 4 * layer_offset4(L, D, H, U);  // [NO][ld_out]
  const float* b_out = w_oT + (size_t)NO * p.ld_out;

  // gates_const[t] and eps[t] of this block's rows into stage t & 1
  auto prefetch = [&](int t) {
    for (int i = tid; i < R * SR; i += nt) {
      const int r = i / SR, e = i % SR, b = b0 + r;
      const bool valid = b < a.B;
      const size_t row = (size_t)t * a.B + b;
      const float* src = e < G ? a.gc + row * G + e : a.eps + row * D + (e - G);
      cp_async4(stage_s + (size_t)(t & 1) * R * SR + i, valid ? src : a.gc, valid);
    }
    cp_async_commit();
  };

  // the float4 {r, z, n, 0} of this lane's unit in row i of layer l's block
  auto weights = [&](int l, int i) {
    return wp[layer_offset4(l, D, H, U) + (size_t)i * U + k];
  };

  // layer 0's hidden gate sums h_0 . W_hh0 + b_hh0 for this lane's unit
  auto hidden_gates0 = [&](const float* h, float (&gh)[R][3]) {
    float sum[1][R][3];
    const float* const v[1] = {h};
    gate_sums<1, R, 3>(sum, v, LH, H, [&](int i, float (&w)[1][3]) {
      const float4 q = weights(0, D + i);
      w[0][0] = q.x; w[0][1] = q.y; w[0][2] = q.z;
    });
    const float4 bh = weights(0, D + H + 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      gh[r][0] = bh.x + sum[0][r][0];
      gh[r][1] = bh.y + sum[0][r][1];
      gh[r][2] = bh.z + sum[0][r][2];
    }
  };

  prefetch(0);
  __syncthreads();  // weights, h_{-1} = 0, x_0, tables

  float gh0[R][3];  // layer 0's hidden gate sums of the coming step
  if (unit_warp) hidden_gates0(h_s, gh0);

  for (int t = 0; t < a.T; ++t) {
    const float* h_old = h_s + (t & 1) * R * LH;
    float* h_new = h_s + ((t + 1) & 1) * R * LH;
    const float* cur = stage_s + (t & 1) * R * SR;
    cp_async_wait_all();
    __syncthreads();  // step t's stage is in, x_t is written, step t-1 is done
    if (t + 1 < a.T) prefetch(t + 1);  // stage (t + 1) & 1 was last read in step t - 1

    for (int l = 0; l < L; ++l) {
      if (unit_warp) {
        float gi[R][3], gh[R][3];
        if (l == 0) {
          float sum[1][R][3];
          const float* const v[1] = {x_s};
          gate_sums<1, R, 3>(sum, v, D, D, [&](int i, float (&w)[1][3]) {
            const float4 q = weights(0, i);
            w[0][0] = q.x; w[0][1] = q.y; w[0][2] = q.z;
          });
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              gi[r][g] = (live ? cur[r * SR + g * H + k] : 0.0f) + sum[0][r][g];
              gh[r][g] = gh0[r][g];
            }
        } else {  // the input product (layer below, new h) and the hidden product in one loop
          float sum[2][R][3];
          const float* const v[2] = {h_new + (l - 1) * H, h_old + l * H};
          gate_sums<2, R, 3>(sum, v, LH, H, [&](int i, float (&w)[2][3]) {
            const float4 qi = weights(l, i), qh = weights(l, H + i);
            w[0][0] = qi.x; w[0][1] = qi.y; w[0][2] = qi.z;
            w[1][0] = qh.x; w[1][1] = qh.y; w[1][2] = qh.z;
          });
          const float4 bi = weights(l, 2 * H), bh = weights(l, 2 * H + 1);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            gi[r][0] = bi.x + sum[0][r][0];
            gi[r][1] = bi.y + sum[0][r][1];
            gi[r][2] = bi.z + sum[0][r][2];
            gh[r][0] = bh.x + sum[1][r][0];
            gh[r][1] = bh.y + sum[1][r][1];
            gh[r][2] = bh.z + sum[1][r][2];
          }
        }
        float hn[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float rg, zg, ng;
          gru_gates(gi[r][0], gi[r][1], gi[r][2], gh[r][0], gh[r][1], gh[r][2], rg, zg, ng);
          const float ho = live ? h_old[r * LH + l * H + k] : 0.0f;
          hn[r] = live ? fmaf(zg, ho, (1.0f - zg) * ng) : 0.0f;
          const int b = b0 + r;
          if (live && part == 0) h_new[r * LH + l * H + k] = hn[r];
          if (live && part == 1 && a.h_all != nullptr && b < a.B)
            a.h_all[((size_t)t * a.B + b) * LH + l * H + k] = hn[r];
        }
        if (l == L - 1) {  // this warp's share of h_top @ W_out: outputs o = part, part + kGateParts, ...
          for (int o = part; o < NO; o += kGateParts) {
            const float wo = w_oT[(size_t)o * p.ld_out + k];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float v = hn[r] * wo;
#pragma unroll
              for (int off = 1; off < kUnitsPerWarp; off *= 2) v += __shfl_xor_sync(part_mask, v, off);
              if (lane % kUnitsPerWarp == 0) part_s[(warp * R + r) * NO + o] = v;
            }
          }
        }
      }
      __syncthreads();  // layer l's h(t) (and at the top, the output partials) published
    }

    if (out_warp) {
      // out = b_out + the warps' partials in warp order; raw; each tril
      // value (diagonal clamped) times its eps
      for (int i = lane; i < R * NO; i += 32) {
        const int r = i / NO, o = i % NO, b = b0 + r;
        float acc = b_out[o];
        for (int g = 0; g < p.groups; ++g) acc += part_s[(g * R + r) * NO + o];
        out_s[i] = acc;
        if (b < a.B) a.raw[((size_t)t * a.B + b) * NO + o] = acc;
        if (o >= D) {
          const int j = o - D;
          const float v = trow_s[j] == tcol_s[j] ? fmaxf(acc, a.diag_min) : acc;
          term_s[r * NT + j] = v * cur[r * SR + G + tcol_s[j]];
        }
      }
      __syncwarp();
      // x_{t+1} = x_t + mu dt + (L eps) sqrt(dt), L eps summed by tril row
      for (int i = lane; i < R * D; i += 32) {
        const int r = i / D, d = i % D, b = b0 + r;
        float l_eps = 0.0f;
        for (int j = 0; j < NT; ++j)
          if (trow_s[j] == d) l_eps += term_s[r * NT + j];
        const float x_next = x_s[i] + out_s[r * NO + d] * a.dt + l_eps * a.sqrt_dt;
        x_s[i] = x_next;
        if (b < a.B) a.paths[((size_t)t * a.B + b) * D + d] = x_next;
      }
    }
    if (unit_warp && t + 1 < a.T) {
      hidden_gates0(h_new, gh0);  // h_0(t) is published: the next step's layer-0 hidden sums
    }
  }
}

template <int R>
cudaError_t launch_fwd(const FwdArgs& a, const BlockFwdPlan& p, cudaStream_t stream) {
  void (*kernel)(FwdArgs, BlockFwdPlan);
  if (p.threads <= kNarrowThreads) {
    kernel = p.staged ? fwd_kernel<R, true, kNarrowThreads> : fwd_kernel<R, false, kNarrowThreads>;
  } else {
    kernel = p.staged ? fwd_kernel<R, true, kWideThreads> : fwd_kernel<R, false, kWideThreads>;
  }
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.B + R - 1) / R, p.threads, p.smem, stream>>>(a, p);
  return cudaGetLastError();
}

// ------------------------------------------------------- the cluster path
//
// fwd_cluster_kernel: a cluster of C CTAs (sde_sampler.cuh, "clusters") runs
// the time loop for `rows` batch rows; each CTA holds its column slice of
// every product in shared memory, so no step reads a weight from device
// memory. Per step:
//  - each layer: the input gate sums of the CTA's units (`gate_sums`, K2's
//    order), rows spread over its warps (rw rows a warp, as few as the
//    threads allow: `cluster_fwd_rw`), the GRU update in registers; the new
//    h goes into every CTA's h buffer by st.async (one exchange, see
//    sde_sampler.cuh); while it lands, the next layer's hidden gate sums,
//    which read only h_{t-1};
//  - the output projection: every warp of the CTA owns whole dot products,
//    a lane an output column of the CTA's slice (its W_out^T columns held
//    k-major), over rw rows; raw is written from there;
//  - the Euler update of the CTA's state entries, L eps indexed by row
//    (entry i sums its own i + 1 tril values times eps[0..i], the diagonal
//    clamped; diag mode its one value); x_{t+1}[i] goes into every CTA (one
//    exchange); while it lands, the next step's layer-0 hidden sums.
// L + 1 exchanges and one block barrier a step, and no cluster barrier
// inside the loop. Each row's sums run in the same order whatever the rows
// a cluster, the warps or the cluster size, so the result depends on none
// of them (bitwise) and repeats run to run; no atomics. Plain fp32 FMA. At
// Lorenz r3's head (128 x 3, clusters of 8) the gate products take about
// half of a step, bound by shared-memory loads (PERF.md, section 6).

struct ClusterFwdPlan {
  int uc;           // hidden units a CTA owns (H / C)
  int nop;          // output columns a CTA owns, padded to 32
  int slots;        // state entries a CTA owns, at most
  int sr;           // floats of one row of a stage: gates_const (own columns) | eps, padded to 4
  int rw;           // rows a warp carries (1, 2 or 4: cluster_fwd_rw)
  size_t w_floats;  // floats of one CTA's packed weights
};

__host__ __device__ inline size_t cluster_w_floats(int D, int H, int L, int uc, int nop) {
  size_t rows = (size_t)(D + H + 2) + (size_t)(L - 1) * (2 * H + 2);
  return 4 * (size_t)uc * rows + (size_t)H * nop + nop;
}

inline size_t cluster_fwd_smem(int D, int H, int L, int rows, const ClusterFwdPlan& c) {
  const size_t floats = c.w_floats + 2 * (size_t)rows * c.sr + 2 * (size_t)rows * L * H + (size_t)rows * D +
                        (size_t)rows * c.nop;
  return sizeof(float) * floats + sizeof(int) * ((size_t)3 * c.nop + 2 * c.slots);
}

inline void make_cluster_fwd(int D, int H, int L, int diag, int C, ClusterFwdPlan* c) {
  c->uc = H / C;
  cluster_columns(D, diag, C, &c->nop, &c->slots);
  c->sr = (3 * c->uc + D + 3) / 4 * 4;
  c->w_floats = cluster_w_floats(D, H, L, c->uc, c->nop);
}

// Rows a warp carries at `rows` rows a cluster: the fewest (1, 2 or 4) whose
// warps the CTA's threads hold. One warp's share of a step is a chain of
// dependent shared-memory loads and sums, so a step takes about as long as
// its warps' longest share: fewer rows a warp, more warps, a shorter step.
inline int cluster_fwd_rw(int uc, int rows) {
  for (int rw = 1; rw < 4 && rw < rows; rw *= 2)
    if (32 * (uc / kUnitsPerWarp) * (rows / rw) <= kClusterThreads) return rw;
  return rows < 4 ? rows : 4;
}

// The most rows a cluster of C can carry: shared memory and kClusterThreads
// (at 4 rows a warp).
inline int cluster_fwd_max_rows(int D, int H, int L, int diag, int C, int optin) {
  ClusterFwdPlan c;
  make_cluster_fwd(D, H, L, diag, C, &c);
  const int groups = c.uc / 8;
  int best = 0;
  for (int r = 1; r <= 256; r = r < 4 ? 2 * r : r + 4) {
    const int rw = r < 4 ? r : 4;
    if (32 * groups * (r / rw) > kClusterThreads || cluster_fwd_smem(D, H, L, r, c) + kExchangeSmem > (size_t)optin)
      break;
    best = r;
  }
  return best;
}

inline bool cluster_shape_ok(int H, int C) { return C >= 1 && C <= kMaxCluster && H % (8 * C) == 0; }

template <int RW>
__global__ void __launch_bounds__(kClusterThreads, 1) fwd_cluster_kernel(FwdArgs a, ClusterFwdPlan p, int C, int R) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, L = a.L, D = a.D, LH = a.L * a.H, NO = a.D + a.n_tril;
  const int UC = p.uc, NOP = p.nop, S = p.slots, SR = p.sr;
  const int c = C == 1 ? 0 : (int)cg::this_cluster().block_rank();
  float* w_s = smem;                           // this CTA's packed weights
  float* stage_s = w_s + p.w_floats;           // [2][R][SR]  gates_const (own columns) | eps of a step
  float* h_s = stage_s + 2 * R * SR;           // [2][R][LH]  h(t-1) and h(t) of every unit, by step parity
  float* x_s = h_s + 2 * R * LH;               // [R][D]      x_t
  float* out_s = x_s + R * D;                  // [R][NOP]    this CTA's outputs
  int* ocol_s = reinterpret_cast<int*>(out_s + R * NOP);  // [NOP] global output column (-1: padding)
  int* erow_s = ocol_s + NOP;                  // [S] the state entries it owns (-1: none)
  int* eseg_s = erow_s + S;                    // [S] the local column of each one's mu
  int* mslot_s = eseg_s + S;                   // [NOP] each column's entry slot
  int* mj_s = mslot_s + NOP;                   // [NOP] each column's tril column j (-1: mu)

  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31, n_warps = nt >> 5;
  const int part = lane / kUnitsPerWarp;
  const int groups = UC / kUnitsPerWarp;
  const int ug = warp % groups, r0 = (warp / groups) * RW;  // this warp's units and rows
  const int u = ug * kUnitsPerWarp + lane % kUnitsPerWarp;  // this lane's unit, in the CTA
  const int k = c * UC + u;                                 // and in the layer
  const int b0 = (blockIdx.x / C) * R;
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  const float* w_oT = w_s + 4 * (size_t)UC * ((D + H + 2) + (size_t)(L - 1) * (2 * H + 2));  // [H][NOP]
  const float* b_out = w_oT + (size_t)H * NOP;

  {
    const float4* src = reinterpret_cast<const float4*>(a.w + (size_t)c * p.w_floats);
    float4* dst = reinterpret_cast<float4*>(w_s);
    for (size_t i = tid; i < p.w_floats / 4; i += nt) dst[i] = src[i];
    const int* lay = a.layout + (size_t)c * layout_width(D, NOP, S);
    for (int i = tid; i < 3 * NOP + 2 * S; i += nt) ocol_s[i] = lay[i];
  }
  for (int i = tid; i < 2 * R * LH; i += nt) h_s[i] = 0.0f;
  for (int i = tid; i < R * D; i += nt) {
    const int b = b0 + i / D;
    x_s[i] = b < a.B ? a.x0[(size_t)b * D + i % D] : 0.0f;
  }

  // gates_const[t] (this CTA's columns) and eps[t] of the cluster's rows into stage t & 1
  auto prefetch = [&](int t) {
    for (int i = tid; i < R * SR; i += nt) {
      const int r = i / SR, e = i % SR, b = b0 + r;
      const bool valid = b < a.B && e < 3 * UC + D;
      const size_t row = (size_t)t * a.B + b;
      const float* src = a.gc;
      if (valid)
        src = e < 3 * UC ? a.gc + row * 3 * H + (e / UC) * H + c * UC + e % UC : a.eps + row * D + (e - 3 * UC);
      cp_async4(stage_s + (size_t)(t & 1) * R * SR + i, src, valid);
    }
    cp_async_commit();
  };
  // the float4 {r, z, n, 0} of this lane's unit in row i of layer l's block
  auto weights = [&](int l, int i) {
    const size_t off = l == 0 ? 0 : (size_t)UC * ((D + H + 2) + (size_t)(l - 1) * (2 * H + 2));
    return w4[off + (size_t)i * UC + u];
  };
  // layer l's hidden gate sums h_l . W_hh + b_hh for this lane's unit (h: the
  // step's h_{t-1}, every layer; K2's gate pass sums each product on its own
  // in this order too)
  auto hidden_gates = [&](int l, const float* h, float (&gh)[RW][3]) {
    float sum[1][RW][3];
    const int n_in = l == 0 ? D : H;
    const float* const v[1] = {h + r0 * LH + l * H};
    gate_sums<1, RW, 3>(sum, v, LH, H, [&](int i, float (&w)[1][3]) {
      const float4 q = weights(l, n_in + i);
      w[0][0] = q.x; w[0][1] = q.y; w[0][2] = q.z;
    });
    const float4 bh = weights(l, n_in + H + 1);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      gh[r][0] = bh.x + sum[0][r][0];
      gh[r][1] = bh.y + sum[0][r][1];
      gh[r][2] = bh.z + sum[0][r][2];
    }
  };

  // a step's exchanges: each layer's h(t) (R rows of H units land in every
  // CTA), then x_{t+1} (R rows of D entries)
  __shared__ uint64_t exchange_s[2];
  Exchanges ex{exchange_s, 0};
  auto bytes = [&](int k) { return 4u * R * (k % (L + 1) < L ? H : D); };
  ex.init(bytes(0), bytes(1));

  prefetch(0);
  cluster_barrier(C);  // weights, tables, h_{-1} = 0, x_0 and the mbarriers in every CTA before any peer writes
  float gh[RW][3];  // the hidden gate sums of the coming layer
  hidden_gates(0, h_s, gh);

  for (int t = 0; t < a.T; ++t) {
    const float* h_old = h_s + (t & 1) * R * LH;
    float* h_new = h_s + ((t + 1) & 1) * R * LH;
    const float* cur = stage_s + (t & 1) * R * SR;
    cp_async_wait_all();
    __syncthreads();  // step t's stage is in
    if (t + 1 < a.T) prefetch(t + 1);  // stage (t + 1) & 1 was last read in step t - 1

    for (int l = 0; l < L; ++l) {
      float gi[RW][3];
      float sum[1][RW][3];
      const float* const v[1] = {l == 0 ? x_s + r0 * D : h_new + r0 * LH + (l - 1) * H};
      const int ldv = l == 0 ? D : LH, n_in = l == 0 ? D : H;
      gate_sums<1, RW, 3>(sum, v, ldv, n_in, [&](int i, float (&w)[1][3]) {
        const float4 q = weights(l, i);
        w[0][0] = q.x; w[0][1] = q.y; w[0][2] = q.z;
      });
      const float4 bi = l == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : weights(l, 2 * H);
      const float b_in[3] = {bi.x, bi.y, bi.z};
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          gi[r][g] = (l == 0 ? cur[(r0 + r) * SR + g * UC + u] : b_in[g]) + sum[0][r][g];
      float hn[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float rg, zg, ng;
        gru_gates(gi[r][0], gi[r][1], gi[r][2], gh[r][0], gh[r][1], gh[r][2], rg, zg, ng);
        const int idx = (r0 + r) * LH + l * H + k;
        hn[r] = fmaf(zg, h_old[idx], (1.0f - zg) * ng);
        // layer l's h(t) into every CTA: the four parts of a unit hold the
        // same bits, part q sends to CTAs q, q + kGateParts, ..
        for (int q = part; q < C; q += kGateParts) ex.send(h_new, idx, q, hn[r]);
      }
      if (part == kGateParts - 1 && a.h_all != nullptr)
#pragma unroll
        for (int r = 0; r < RW; ++r)
          if (b0 + r0 + r < a.B) a.h_all[((size_t)t * a.B + b0 + r0 + r) * LH + l * H + k] = hn[r];
      // the next layer's hidden product, which reads only h_{t-1}, while
      // layer l's h(t) lands
      if (l + 1 < L) hidden_gates(l + 1, h_old, gh);
      ex.finish(bytes(ex.done + 2));
    }

    // the output projection: a lane an output column, whole dot products over h_top(t)
    const float* h_top = h_new + (L - 1) * H;
    const int col_blocks = NOP / 32, tasks = col_blocks * (R / RW);
    for (int task = warp; task < tasks; task += n_warps) {
      const int m = (task % col_blocks) * 32 + lane, q0 = (task / col_blocks) * RW;
      float acc[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < H; i += 4) {
        const float w0 = w_oT[(size_t)i * NOP + m], w1 = w_oT[(size_t)(i + 1) * NOP + m];
        const float w2 = w_oT[(size_t)(i + 2) * NOP + m], w3 = w_oT[(size_t)(i + 3) * NOP + m];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(h_top + (q0 + r) * LH + i);
          acc[r] = fmaf(hv.x, w0, acc[r]);
          acc[r] = fmaf(hv.y, w1, acc[r]);
          acc[r] = fmaf(hv.z, w2, acc[r]);
          acc[r] = fmaf(hv.w, w3, acc[r]);
        }
      }
      const int o = ocol_s[m];
      const bool on_diag = o >= D && mj_s[m] == erow_s[mslot_s[m]];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float v = b_out[m] + acc[r];
        out_s[(q0 + r) * NOP + m] = v;
        const int b = b0 + q0 + r;
        if (o >= 0 && b < a.B) {
          const size_t row = (size_t)t * a.B + b;
          a.raw[row * NO + o] = v;
          if (o >= D) a.chol[row * a.n_tril + (o - D)] = on_diag ? fmaxf(v, a.diag_min) : v;
        }
      }
    }
    __syncthreads();  // this CTA's outputs

    // x_{t+1} = x_t + mu dt + (L eps) sqrt(dt) for this CTA's entries
    for (int i = tid; i < R * S; i += nt) {
      const int r = i / S, s = i % S, e = erow_s[s], b = b0 + r;
      if (e < 0) continue;
      const float* o = out_s + r * NOP + eseg_s[s];  // mu_e, then row e's tril values
      const float* eps = cur + r * SR + 3 * UC;
      float l_eps;
      if (a.diag) {
        l_eps = fmaxf(o[1], a.diag_min) * eps[e];
      } else {
        l_eps = 0.0f;
#pragma unroll 8
        for (int j = 0; j < e; ++j) l_eps = fmaf(o[1 + j], eps[j], l_eps);
        l_eps = fmaf(fmaxf(o[1 + e], a.diag_min), eps[e], l_eps);
      }
      const float x_next = x_s[r * D + e] + o[0] * a.dt + l_eps * a.sqrt_dt;
      for (int q = 0; q < C; ++q) ex.send(x_s, r * D + e, q, x_next);  // x_{t+1} into every CTA
      if (b < a.B) a.paths[((size_t)t * a.B + b) * D + e] = x_next;
    }
    // the next step's layer-0 hidden sums while x_{t+1} lands
    if (t + 1 < a.T) hidden_gates(0, h_new, gh);
    ex.finish(bytes(ex.done + 2));
  }
  cluster_barrier(C);  // no CTA leaves while a peer may still address it
}

template <int RW>
cudaError_t launch_cluster_fwd(const FwdArgs& a, const ClusterFwdPlan& p, int C, int R, int threads, size_t smem,
                               cudaStream_t stream) {
  void (*kernel)(FwdArgs, ClusterFwdPlan, int, int) = fwd_cluster_kernel<RW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return launch_clusters(kernel, (a.B + R - 1) / R, C, threads, smem, stream, a, p, C, R);
}

// Clusters of C the card runs at once at the cluster kernel's most rows
// (its most shared memory and threads): the slots of the row rule.
inline cudaError_t fwd_cluster_slots(int D, int H, int L, int diag, int C, int max_rows, int n_sms, int* slots) {
  ClusterFwdPlan c;
  make_cluster_fwd(D, H, L, diag, C, &c);
  const int rw = cluster_fwd_rw(c.uc, max_rows);
  const int threads = 32 * (c.uc / kUnitsPerWarp) * (max_rows / rw);
  void (*kernel)(FwdArgs, ClusterFwdPlan, int, int) =
      rw == 1 ? fwd_cluster_kernel<1> : rw == 2 ? fwd_cluster_kernel<2> : fwd_cluster_kernel<4>;
  int held = 0;
  cudaError_t err = max_active_clusters(kernel, C, threads, cluster_fwd_smem(D, H, L, max_rows, c), &held);
  if (err != cudaSuccess) return err;
  *slots = held < n_sms / C ? held : n_sms / C;
  return *slots > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------------------- plan

enum FwdPath { kStreaming = 0, kStaged = 1, kCluster = 2 };

struct FwdPlan {
  int path;      // FwdPath
  int cluster;   // CTAs a cluster (1 on the one-block paths)
  int rows;      // batch rows a block (the one-block paths) or a cluster
  int threads;
  size_t smem;
  size_t w_floats;  // floats of the packed weights (the cluster path: of each CTA)
  BlockFwdPlan block;
  ClusterFwdPlan clu;
};

// K1's launch for a shape, chosen by shape alone unless `path`, `cluster` or
// `rows` ask for one (-1, 0, 0: by shape):
//  - the one-block kernel with its weights staged in shared memory where
//    they fit one block (at the rows `cluster_rows` gives, at most 4);
//  - else the cluster kernel at the cluster (2, 4, 8 or 16) whose slices
//    fit in the fewest waves of clusters (the smaller on a tie), at the rows
//    `cluster_rows` gives a cluster with the clusters the card runs at once
//    (`fwd_cluster_slots`);
//  - else the one-block kernel streaming its weights from device memory.
// `ops/sde_sampler.py` mirrors it (`plan_forward`).
inline cudaError_t make_fwd_plan(int D, int H, int L, int n_tril, int diag, int B, int path, int cluster, int rows,
                                 int n_sms, int optin, FwdPlan* p) {
  if (H > kMaxHidden || L < 1 || B < 1) return cudaErrorInvalidValue;
  const int block_rows = path != kCluster && rows > 0 ? rows : cluster_rows(B, n_sms, 4);
  cudaError_t err = make_block_fwd_plan(D, H, L, n_tril, block_rows, -1, optin, &p->block);
  if (err != cudaSuccess) return err;
  if (path < 0) {
    path = p->block.staged ? kStaged : kStreaming;
    int best = 0;
    for (int C = 2; path != kStaged && C <= kMaxCluster; C *= 2) {
      const int max_rows = cluster_shape_ok(H, C) ? cluster_fwd_max_rows(D, H, L, diag, C, optin) : 0;
      int slots = 0;
      if (max_rows > 0 && (err = fwd_cluster_slots(D, H, L, diag, C, max_rows, n_sms, &slots)) != cudaSuccess)
        return err;
      const int waves = max_rows > 0 ? cluster_waves(B, slots, max_rows) : 0;
      if (waves > 0 && (best == 0 || waves < best)) {
        path = kCluster;
        cluster = C;
        best = waves;
      }
    }
  }
  p->path = path;
  if (path == kCluster) {
    if (cluster <= 0)
      for (cluster = 1; cluster <= kMaxCluster; cluster *= 2)
        if (cluster_shape_ok(H, cluster) && cluster_fwd_max_rows(D, H, L, diag, cluster, optin) > 0) break;
    if (!cluster_shape_ok(H, cluster)) return cudaErrorInvalidValue;
    const int max_rows = cluster_fwd_max_rows(D, H, L, diag, cluster, optin);
    if (max_rows < 1) return cudaErrorInvalidValue;
    if (rows <= 0) {
      int slots = 0;
      err = fwd_cluster_slots(D, H, L, diag, cluster, max_rows, n_sms, &slots);
      if (err != cudaSuccess) return err;
      rows = cluster_rows(B, slots, max_rows);
    }
    if (rows > max_rows || rows != round_rows(rows)) return cudaErrorInvalidValue;
    make_cluster_fwd(D, H, L, diag, cluster, &p->clu);
    p->clu.rw = cluster_fwd_rw(p->clu.uc, rows);
    p->cluster = cluster;
    p->rows = rows;
    p->threads = 32 * (p->clu.uc / kUnitsPerWarp) * (rows / p->clu.rw);
    p->smem = cluster_fwd_smem(D, H, L, rows, p->clu);
    p->w_floats = p->clu.w_floats;
    return cudaSuccess;
  }
  if (path != kStaged && path != kStreaming) return cudaErrorInvalidValue;
  if (path == kStaged && !p->block.staged) return cudaErrorInvalidValue;
  if (p->block.smem_streaming > (size_t)optin) return cudaErrorInvalidValue;  // not even the work buffers fit
  p->block.staged = path == kStaged ? 1 : 0;
  p->block.smem = p->block.staged ? p->block.smem_staged : p->block.smem_streaming;
  p->cluster = 1;
  p->rows = block_rows;
  p->threads = p->block.threads;
  p->smem = p->block.smem;
  p->w_floats = p->block.w_floats;
  p->clu = ClusterFwdPlan{};
  return cudaSuccess;
}

inline cudaError_t device_limits(int* n_sms, int* optin) {
  cudaError_t err = sm_count(n_sms);
  return err != cudaSuccess ? err : optin_smem(optin);
}

}  // namespace sde_sampler

// K1's plan for a shape (see make_fwd_plan): out = {path, cluster, rows,
// threads, smem bytes, packed floats (per CTA on the cluster path), the
// one-block layout's units and W_out^T row stride, the cluster layout's uc,
// nop, slots, rows a warp}. The caller packs the weights with these.
extern "C" int sde_sampler_fwd_plan(int D, int H, int L, int n_tril, int diag, int B, int path, int cluster,
                                    int rows, long long* out) {
  using namespace sde_sampler;
  int n_sms = 0, optin = 0;
  cudaError_t err = device_limits(&n_sms, &optin);
  if (err != cudaSuccess) return (int)err;
  FwdPlan p;
  err = make_fwd_plan(D, H, L, n_tril, diag, B, path, cluster, rows, n_sms, optin, &p);
  if (err != cudaSuccess) return (int)err;
  const long long vals[12] = {p.path, p.cluster, p.rows, p.threads, (long long)p.smem, (long long)p.w_floats,
                              p.block.units, p.block.ld_out, p.clu.uc, p.clu.nop, p.clu.slots, p.clu.rw};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}

// `path`, `cluster`, `rows`: -1, 0, 0 for the plan by shape, or what to ask
// for (make_fwd_plan). `w` holds the weights packed for that plan, `layout`
// the cluster layout (the cluster path only).
extern "C" int sde_sampler_fwd(
    const float* x0, const float* gc, const float* eps, const float* w, const int* layout,
    const int* tril_rows, const int* tril_cols,
    float* paths, float* raw, float* chol, float* h_all,
    int B, int T, int D, int H, int L, int n_tril, int diag, int path, int cluster, int rows,
    float dt, float sqrt_dt, float diag_min, void* stream) {
  using namespace sde_sampler;
  FwdArgs a{x0, gc, eps, w, tril_rows, tril_cols, paths, raw, chol, h_all, layout,
            B, T, D, H, L, n_tril, diag, dt, sqrt_dt, diag_min};
  if (B == 0 || T == 0) return 0;
  int n_sms = 0, optin = 0;
  cudaError_t err = device_limits(&n_sms, &optin);
  if (err != cudaSuccess) return (int)err;
  FwdPlan p;
  err = make_fwd_plan(D, H, L, n_tril, diag, B, path, cluster, rows, n_sms, optin, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.path == kCluster) {
    switch (p.clu.rw) {
      case 1: return (int)launch_cluster_fwd<1>(a, p.clu, p.cluster, p.rows, p.threads, p.smem, st);
      case 2: return (int)launch_cluster_fwd<2>(a, p.clu, p.cluster, p.rows, p.threads, p.smem, st);
      case 4: return (int)launch_cluster_fwd<4>(a, p.clu, p.cluster, p.rows, p.threads, p.smem, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (p.rows) {
    case 1: err = launch_fwd<1>(a, p.block, st); break;
    case 2: err = launch_fwd<2>(a, p.block, st); break;
    case 4: err = launch_fwd<4>(a, p.block, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// Clusters of C CTAs of fwd_cluster_kernel (rw rows a warp, `threads`,
// `smem` bytes) the card holds at once: cudaOccupancyMaxActiveClusters.
extern "C" int sde_sampler_fwd_max_clusters(int C, int rw, int threads, long long smem, int* out) {
  using namespace sde_sampler;
  void (*kernel)(FwdArgs, ClusterFwdPlan, int, int) =
      rw == 1 ? fwd_cluster_kernel<1> : rw == 2 ? fwd_cluster_kernel<2> : fwd_cluster_kernel<4>;
  return (int)max_active_clusters(kernel, C, threads, (size_t)smem, out);
}
