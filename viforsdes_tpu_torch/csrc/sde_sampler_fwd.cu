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
// What bounds it on an H100: not the roofline. At B=32, T=2000 it does 4.9
// GFLOP in 2000 dependent steps, so what counts is the latency of one step:
// a chain of dependent phases (each layer's gate sums and nonlinearities,
// the output projection, the Euler update) joined by block barriers. The
// matvecs themselves (the GRU's 3H x (in + H) per layer, read from shared
// memory) are the smaller part of it at H=64 (PERF.md, section 6).
//
// Design: one block per `R` batch rows (1, 2 or 4, chosen by the caller) runs
// the whole time loop; blocks are independent rows, so no cross-block order
// is needed.
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
  float* h_all;          // [T, B, L*H] or nullptr
  int B, T, D, H, L, n_tril;
  float dt, sqrt_dt, diag_min;
};

constexpr int kUnitsPerWarp = kGateCols;  // hidden units a warp owns, kGateParts lanes each
// The kernel is built for two bounds on its threads: up to H=64 (8 warps of
// units and the output warp) it may take 224 registers a thread; the wide
// build, up to H=256 (32 warps of units), takes 64.
constexpr int kNarrowThreads = 32 * (64 / kUnitsPerWarp + 1);
constexpr int kWideThreads = 1024;
constexpr int kMaxHidden = kWideThreads / 32 * kUnitsPerWarp;  // 256

struct FwdPlan {
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

// The launch of fwd_kernel for a shape at `rows` batch rows per block, chosen
// by shape alone: staged when the packed weights and the rest fit the card's
// opt-in shared memory, unless `staged` is 0.
inline cudaError_t make_fwd_plan(int D, int H, int L, int n_tril, int rows, int staged, FwdPlan* p) {
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
  int optin = 0;
  cudaError_t err = optin_smem(&optin);
  if (err != cudaSuccess) return err;
  const int fits = p->smem_staged <= (size_t)optin ? 1 : 0;
  if (staged == 1 && !fits) return cudaErrorInvalidValue;
  p->staged = staged == 0 ? 0 : fits;
  p->smem = p->staged ? p->smem_staged : p->smem_streaming;
  return cudaSuccess;
}

template <int R, bool kStaged, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) fwd_kernel(FwdArgs a, FwdPlan p) {
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
cudaError_t launch_fwd(const FwdArgs& a, const FwdPlan& p, cudaStream_t stream) {
  void (*kernel)(FwdArgs, FwdPlan);
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

}  // namespace sde_sampler

// The fwd_kernel launch for a shape at `rows` rows per block: out = {staged,
// threads, smem bytes staged, smem bytes streaming, packed floats, W_out^T
// row stride, units per packed row}. The caller packs the weights with these.
extern "C" int sde_sampler_fwd_plan(int D, int H, int L, int n_tril, int rows, long long* out) {
  using namespace sde_sampler;
  FwdPlan p;
  cudaError_t err = make_fwd_plan(D, H, L, n_tril, rows, -1, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.staged; out[1] = p.threads;
  out[2] = (long long)p.smem_staged; out[3] = (long long)p.smem_streaming;
  out[4] = (long long)p.w_floats; out[5] = p.ld_out; out[6] = p.units;
  return 0;
}

// `staged`: 1 or 0 to ask for that plan (1 fails where it does not fit), -1
// for the plan by shape.
extern "C" int sde_sampler_fwd(
    const float* x0, const float* gc, const float* eps, const float* w,
    const int* tril_rows, const int* tril_cols,
    float* paths, float* raw, float* h_all,
    int B, int T, int D, int H, int L, int n_tril, int rows, int staged,
    float dt, float sqrt_dt, float diag_min, void* stream) {
  using namespace sde_sampler;
  FwdArgs a{x0, gc, eps, w, tril_rows, tril_cols, paths, raw, h_all,
            B, T, D, H, L, n_tril, dt, sqrt_dt, diag_min};
  if (B == 0 || T == 0) return 0;
  FwdPlan p;
  cudaError_t err = make_fwd_plan(D, H, L, n_tril, rows, staged, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: err = launch_fwd<1>(a, p, st); break;
    case 2: err = launch_fwd<2>(a, p, st); break;
    case 4: err = launch_fwd<4>(a, p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
