// K2: backward (reverse-time BPTT) of the fused GRU path sampler.
//
// Replaces the TPU kernel `_bwd_kernel` of viforsdes_tpu/ops/pallas/sde_sampler.py
// (launched by `FusedPathSampler._backward`). It recomputes each layer's gates
// from the stashed h (no activation stash in the forward), walks t = T-1 .. 0
// back-propagating the Euler update and the output projection, applies the
// lower_bound rule to the SUMMED Cholesky cotangent (pass iff raw >= diag_min
// or the cotangent is negative), runs each GRU layer's BPTT, and emits
// d_gates_const, d_eps, dx0 and every weight gradient.
//
// What bounds it on an H100: not the roofline. At B=32, T=2000 it does 14.5
// GFLOP (0.22 ms at the fp32 peak) in 2000 dependent steps, so what counts is
// the latency of one step's chain: a few small matvecs, the gate
// nonlinearities and the block barriers between dependent phases. The cost of
// a step does not depend on the batch.
//
// Design, four launches in one call:
//  1. gates_kernel: the gate recompute does not depend on the reverse chain
//     (it reads h_{t-1}, h_t, x_t and gates_const[t], all known from the
//     forward), so it runs first over all T*B rows in parallel, 32 rows a
//     block (16 or 8 where 32 rows' tiles exceed the shared memory, H > 227),
//     kGateParts lanes per gate column, and writes r, z, n and n_hh of every
//     step and layer to `acts` [L, T, B, 4H]. Its sums and nonlinearities are
//     K1's (`gate_sums`, `gru_gates` in sde_sampler.cuh), so the gates are
//     K1's to the bit.
//  2. the BPTT loop, by shape in `make_bwd_plan`: bptt_cluster_kernel
//     (below: a cluster of 2 to 16 CTAs holding the matrices between them,
//     K1's column split) where the matrices fit a cluster and not a block
//     (a 32-dimensional state, H=64 with three layers, H=96, H=128); else
//     bptt_kernel, one block per `rows` batch rows, which walks the reverse
//     steps as follows.
//     - The matrices the loop reads (per layer, W_hh^T beside W_ih^T or
//       W_x^T, packed by the caller with a padded row stride) are staged in
//       shared memory once per block when they fit the block's opt-in limit
//       (H=64, L=2: 160 KB). Otherwise, chosen by shape in `make_plan`, the
//       same loop reads them from global memory (the streaming path).
//     - The next step's streams (acts, h_{t-1}, d_paths, d_means, eps,
//       d_cholv, raw) arrive by cp.async into a second stage while this step
//       computes: their addresses do not depend on the chain.
//     - Each 3H-deep transposed matvec is split over 4 lanes per output
//       column (rows j = 4*jj + part of the packed matrix, which the padding
//       puts on distinct banks) and reduced by two shuffles in a fixed order.
//     - 2L + 1 barriers per step: one for the stage and the Euler/output
//       backward, one after each layer's elementwise phase, one after each
//       matvec but the last. The output projection's transpose is folded
//       into the top layer's elementwise phase.
//     It writes the per-step gate cotangents (d_gi, d_gh per layer, d_out).
//  3. weight_grad (called by the wrapper per matrix) forms every dW = A^T . G
//     (and db as a row of ones in A) as a tiled reduction over the T*B rows,
//     split over row ranges into a [n_split, K, N] scratch that a second
//     small kernel sums in a fixed order.
// No atomics anywhere: the result is bitwise reproducible run to run, as the
// TPU kernel's sequential accumulation is. All arithmetic is plain fp32 FMA.

#include "sde_sampler.cuh"

namespace sde_sampler {

struct BwdArgs {
  const float* gc;        // [T, B, 3H]
  const float* eps;       // [T, B, D]
  const float* x_in;      // [T, B, D]   state entering step t (x0, paths[:-1])
  const float* h_all;     // [T, B, L*H]
  const float* raw;       // [T, B, D + n_tril]
  const float* d_paths;   // [T, B, D]   cotangent of x_{t+1}
  const float* d_means;   // [T, B, D]
  const float* d_cholv;   // [T, B, n_tril]
  const float* w_x;       // [D, 3H]     the gate weights as K1 takes them
  const float* w_hh0;     // [H, 3H]
  const float* b_hh0;     // [3H]
  const float* w_ih_st;   // [L-1, H, 3H]
  const float* w_hh_st;   // [L-1, H, 3H]
  const float* b_ih_st;   // [L-1, 3H]
  const float* b_hh_st;   // [L-1, 3H]
  const float* w_bptt;    // layer 0 [3H][ld0]: W_hh0^T | W_x^T; layers 1.. [3H][ld1]: W_hh^T | W_ih^T
  const float* w_outT;    // [D + n_tril, H]
  const int* tril_rows;
  const int* tril_cols;
  const float* w_clu;     // the cluster path: each CTA's packed slices (pack_bptt_weights)
  const int* layout;      // the cluster path: per CTA its columns and entries (cluster_layout)
  float* acts;            // [L, T, B, 4H]  r, z, n, n_hh (scratch)
  float* d_gc;            // [T, B, 3H]   (= d_gi of layer 0)
  float* d_eps;           // [T, B, D]
  float* d_x0;            // [B, D]       without the direct d_paths[:, 0] term
  float* d_gh;            // [L, T, B, 3H]
  float* d_gi;            // [L-1, T, B, 3H]
  float* d_out;           // [T, B, D + n_tril]
  int B, T, D, H, L, n_tril, diag;
  float dt, sqrt_dt, diag_min;
};

// ------------------------------------------------------------- gate pass

constexpr int kGateWarps = 24;  // at most

// Shared memory of a gate-pass block of `rows` (t, b) rows.
inline size_t gate_smem(int rows, int D, int H) {
  return sizeof(float) * rows * ((size_t)(D > H ? D : H) + 7 * (size_t)H);
}

// kGateRows (t, b) rows a block: each row's sums run in their own chain, so
// the result does not depend on it.
template <int kGateRows>
__global__ void __launch_bounds__(32 * kGateWarps) gates_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, G = 3 * a.H, L = a.L, D = a.D, LH = a.L * a.H;
  const int IN = D > H ? D : H;
  const int TB = a.T * a.B;
  float* in_s = smem;                  // [RB][IN]  x_t (layer 0) or h_t of the layer below
  float* hp_s = in_s + kGateRows * IN; // [RB][H]   h_{t-1} of this layer
  float* gi_s = hp_s + kGateRows * H;  // [RB][G]
  float* gh_s = gi_s + kGateRows * G;  // [RB][G]
  const int R0 = blockIdx.x * kGateRows;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, n_warps = nt >> 5;

  for (int l = 0; l < L; ++l) {
    const int in_dim = l == 0 ? D : H;
    for (int i = tid; i < kGateRows * in_dim; i += nt) {
      const int r = i / in_dim, k = i % in_dim, R = R0 + r;
      float v = 0.0f;
      if (R < TB) v = l == 0 ? a.x_in[(size_t)R * D + k] : a.h_all[(size_t)R * LH + (l - 1) * H + k];
      in_s[r * IN + k] = v;
    }
    for (int i = tid; i < kGateRows * H; i += nt) {
      const int r = i / H, k = i % H, R = R0 + r;  // row R - B is step t - 1
      hp_s[i] = R < TB && R >= a.B ? a.h_all[(size_t)(R - a.B) * LH + l * H + k] : 0.0f;
    }
    __syncthreads();

    const float* w_in = l == 0 ? a.w_x : a.w_ih_st + (size_t)(l - 1) * H * G;
    const float* w_h = l == 0 ? a.w_hh0 : a.w_hh_st + (size_t)(l - 1) * H * G;
    const float* b_h = l == 0 ? a.b_hh0 : a.b_hh_st + (size_t)(l - 1) * G;
    // kGateCols gate columns a warp, kGateParts lanes a column (K1's order)
    for (int c0 = warp * kGateCols; c0 < G; c0 += n_warps * kGateCols) {
      const int j = c0 + lane % kGateCols;
      const bool live = j < G;
      const bool writer = live && lane < kGateCols;
      float acc[1][kGateRows][1];
      const float* const in_v[1] = {in_s};
      gate_sums<1, kGateRows, 1>(acc, in_v, IN, in_dim, [&](int i, float (&w)[1][1]) {
        w[0][0] = live ? w_in[(size_t)i * G + j] : 0.0f;
      });
      if (writer) {
        const float bi = l == 0 ? 0.0f : a.b_ih_st[(size_t)(l - 1) * G + j];
#pragma unroll
        for (int r = 0; r < kGateRows; ++r) {
          const int R = R0 + r;
          const float base = l == 0 ? (R < TB ? a.gc[(size_t)R * G + j] : 0.0f) : bi;
          gi_s[r * G + j] = base + acc[0][r][0];
        }
      }
      const float* const hp_v[1] = {hp_s};
      gate_sums<1, kGateRows, 1>(acc, hp_v, H, H, [&](int i, float (&w)[1][1]) {
        w[0][0] = live ? w_h[(size_t)i * G + j] : 0.0f;
      });
      if (writer) {
        const float bh = b_h[j];
#pragma unroll
        for (int r = 0; r < kGateRows; ++r) gh_s[r * G + j] = bh + acc[0][r][0];
      }
    }
    __syncthreads();

    for (int i = tid; i < kGateRows * H; i += nt) {
      const int r = i / H, k = i % H, R = R0 + r;
      if (R >= TB) continue;
      const float* gi = gi_s + r * G;
      const float* gh = gh_s + r * G;
      float rg, zg, ng;
      gru_gates(gi[k], gi[H + k], gi[2 * H + k], gh[k], gh[H + k], gh[2 * H + k], rg, zg, ng);
      float* out = a.acts + ((size_t)l * TB + R) * 4 * H;
      out[k] = rg; out[H + k] = zg; out[2 * H + k] = ng; out[3 * H + k] = gh[2 * H + k];
    }
    __syncthreads();  // before the next layer overwrites the tiles
  }
}

// ------------------------------------------------------------ BPTT loop

constexpr int kParts = 4;  // lanes per output column of a transposed matvec

struct Plan {
  int ld0, ld1;   // row strides of the packed layer-0 and deeper matrices
  int staged;     // 1: the packed matrices live in shared memory
  int threads;
  size_t smem;    // dynamic shared memory of bptt_kernel
  size_t smem_staged, smem_streaming;
  size_t w_floats;  // floats of the packed matrices (the caller's w_bptt)
};

// Floats of one stage row: acts (L*4H), h_{t-1} (L*H), d_paths, d_means, eps
// (D each), d_cholv (n_tril), raw (D + n_tril).
__host__ __device__ inline int stage_row(int D, int H, int L, int n_tril) {
  return 5 * L * H + 4 * D + 2 * n_tril;
}

// The launch of bptt_kernel for a shape at `rows` rows a block: staged when
// the packed matrices and the rest fit `optin` bytes of shared memory.
inline cudaError_t make_plan(int D, int H, int L, int n_tril, int rows, int optin, Plan* p) {
  const size_t G = 3 * (size_t)H, NO = (size_t)D + n_tril, LH = (size_t)L * H;
  p->ld0 = packed_ld(H + D);
  p->ld1 = packed_ld(2 * H);
  p->w_floats = G * (p->ld0 + (size_t)(L - 1) * p->ld1);
  const size_t work = 2 * (size_t)rows * stage_row(D, H, L, n_tril) +
                      rows * (LH + 2 * G + 2 * (size_t)H + NO + D);
  const size_t base = sizeof(float) * work + sizeof(int) * 2 * n_tril;
  const size_t staged = base + sizeof(float) * (p->w_floats + NO * H);
  p->smem_staged = staged;
  p->smem_streaming = base;
  p->staged = staged <= (size_t)optin ? 1 : 0;
  p->smem = p->staged ? staged : base;
  const int cols = H + (L > 1 ? H : D);  // outputs of the widest matvec
  int n = 32 * ((cols + 7) / 8);          // 8 columns x kParts lanes per warp
  const int per_row = D + n_tril + D > H ? D + n_tril + D : H;  // widest elementwise phase
  if (n < rows * per_row) n = ((rows * per_row + 31) / 32) * 32;
  if (n < 64) n = 64;
  if (n > 1024) n = 1024;
  p->threads = n;
  return cudaSuccess;
}

template <int R, bool kStaged>
__global__ void __launch_bounds__(1024) bptt_kernel(BwdArgs a, Plan plan) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, G = 3 * a.H, L = a.L, D = a.D, LH = a.L * a.H, NT = a.n_tril;
  const int NO = a.D + a.n_tril;
  const int RS = stage_row(D, H, L, NT);
  // offsets within a stage row
  const int o_hp = 4 * L * H, o_dp = o_hp + LH, o_dm = o_dp + D, o_eps = o_dm + D;
  const int o_dc = o_eps + D, o_raw = o_dc + NT;
  float* stage_s = smem;                // [2][R][RS]  this step's streams, the next's in flight
  float* dh_s = stage_s + 2 * R * RS;   // [R][LH]  dL/dh_t per layer (carried)
  float* dgi_s = dh_s + R * LH;         // [R][G]
  float* dgh_s = dgi_s + R * G;         // [R][G]
  float* dfa_s = dgh_s + R * G;         // [R][H]   cotangent from the layer above
  float* dir_s = dfa_s + R * H;         // [R][H]   z * d_h (direct path to h_{t-1})
  float* dout_s = dir_s + R * H;        // [R][NO]
  float* dx_s = dout_s + R * NO;        // [R][D]   dL/dx_t (carried)
  int* trow_s = reinterpret_cast<int*>(dx_s + R * D);  // [NT]
  int* tcol_s = trow_s + NT;                           // [NT]
  float* w_s = reinterpret_cast<float*>(tcol_s + NT);  // packed matrices, then W_out^T (staged)

  const int b0 = blockIdx.x * R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = nt / 32;
  const size_t TB = (size_t)a.T * a.B;

  for (int i = tid; i < R * LH; i += nt) dh_s[i] = 0.0f;
  for (int i = tid; i < R * D; i += nt) dx_s[i] = 0.0f;
  for (int i = tid; i < NT; i += nt) {
    trow_s[i] = a.tril_rows[i];
    tcol_s[i] = a.tril_cols[i];
  }
  if (kStaged) {
    for (size_t i = tid; i < plan.w_floats; i += nt) w_s[i] = a.w_bptt[i];
    for (int i = tid; i < NO * H; i += nt) w_s[plan.w_floats + i] = a.w_outT[i];
  }
  const float* w_pk = kStaged ? w_s : a.w_bptt;
  const float* w_oT = kStaged ? w_s + plan.w_floats : a.w_outT;

  // the streams of step t for this block's rows into one stage
  auto prefetch = [&](int t, float* st) {
    for (int i = tid; i < R * RS; i += nt) {
      const int r = i / RS, e = i % RS, b = b0 + r;
      const size_t row = (size_t)t * a.B + b;
      bool valid = b < a.B;
      const float* src;
      if (e < o_hp) {
        const int l = e / (4 * H), k = e % (4 * H);
        src = a.acts + ((size_t)l * TB + row) * 4 * H + k;
      } else if (e < o_dp) {
        valid = valid && t > 0;  // h_{-1} = 0
        src = a.h_all + (row - a.B) * LH + (e - o_hp);
      } else if (e < o_dm) {
        src = a.d_paths + row * D + (e - o_dp);
      } else if (e < o_eps) {
        src = a.d_means + row * D + (e - o_dm);
      } else if (e < o_dc) {
        src = a.eps + row * D + (e - o_eps);
      } else if (e < o_raw) {
        src = a.d_cholv + row * NT + (e - o_dc);
      } else {
        src = a.raw + row * NO + (e - o_raw);
      }
      cp_async4(st + i, valid ? src : a.raw, valid);
    }
  };

  prefetch(a.T - 1, stage_s);
  cp_async_commit();

  for (int t = a.T - 1; t >= 0; --t) {
    float* cur = stage_s + ((a.T - 1 - t) & 1) * R * RS;
    float* nxt = stage_s + ((a.T - t) & 1) * R * RS;
    cp_async_wait_all();
    __syncthreads();  // step t's streams are in; every thread is done with step t+1
    if (t > 0) prefetch(t - 1, nxt);
    cp_async_commit();

    // ---- Euler update + output projection backward, and d_eps -------------
    for (int i = tid; i < R * (NO + D); i += nt) {
      if (i < R * NO) {
        const int r = i / NO, o = i % NO, b = b0 + r;
        const float* s = cur + r * RS;
        float dv = 0.0f;
        if (b < a.B) {
          const size_t row = (size_t)t * a.B + b;
          if (o < D) {
            dv = s[o_dm + o] + (s[o_dp + o] + dx_s[r * D + o]) * a.dt;
          } else {
            const int k = o - D, rk = trow_s[k], ck = tcol_s[k];
            dv = s[o_dc + k] + (s[o_dp + rk] + dx_s[r * D + rk]) * s[o_eps + ck] * a.sqrt_dt;
            if (rk == ck && !(s[o_raw + o] >= a.diag_min || dv < 0.0f)) dv = 0.0f;
          }
          a.d_out[row * NO + o] = dv;
        }
        dout_s[i] = dv;
      } else {
        const int i2 = i - R * NO, r = i2 / D, c = i2 % D, b = b0 + r;
        if (b >= a.B) continue;
        const float* s = cur + r * RS;
        float acc = 0.0f;
        for (int k = 0; k < NT; ++k) {
          if (tcol_s[k] != c) continue;
          float v = s[o_raw + D + k];
          if (trow_s[k] == c) v = fmaxf(v, a.diag_min);
          acc = fmaf(s[o_dp + trow_s[k]] + dx_s[r * D + trow_s[k]], v, acc);
        }
        a.d_eps[((size_t)t * a.B + b) * D + c] = acc * a.sqrt_dt;
      }
    }
    __syncthreads();

    // ---- GRU BPTT, top layer down -----------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      for (int i = tid; i < R * H; i += nt) {
        const int r = i / H, k = i % H, b = b0 + r;
        const float* s = cur + r * RS;
        float dfa;
        if (l == L - 1) {  // the output projection's transpose
          dfa = 0.0f;
          for (int o = 0; o < NO; ++o) dfa = fmaf(dout_s[r * NO + o], w_oT[o * H + k], dfa);
        } else {
          dfa = dfa_s[i];
        }
        const float* act = s + l * 4 * H;
        const float rg = act[k], zg = act[H + k], ng = act[2 * H + k], n_hh = act[3 * H + k];
        const float h_prev = s[o_hp + l * H + k];
        const float d_h = dh_s[r * LH + l * H + k] + dfa;
        const float dn = d_h * (1.0f - zg);
        const float dz = d_h * (h_prev - ng);
        const float da_n = dn * (1.0f - ng * ng);
        const float d_r = da_n * n_hh;
        const float d_gh_n = da_n * rg;
        const float da_r = d_r * rg * (1.0f - rg);
        const float da_z = dz * zg * (1.0f - zg);
        dir_s[i] = d_h * zg;
        float* dgi = dgi_s + r * G;
        float* dgh = dgh_s + r * G;
        dgi[k] = da_r; dgi[H + k] = da_z; dgi[2 * H + k] = da_n;
        dgh[k] = da_r; dgh[H + k] = da_z; dgh[2 * H + k] = d_gh_n;
        if (b < a.B) {
          const size_t row = (size_t)t * a.B + b;
          float* out_gh = a.d_gh + ((size_t)l * TB + row) * G;
          out_gh[k] = da_r; out_gh[H + k] = da_z; out_gh[2 * H + k] = d_gh_n;
          float* out_gi = l == 0 ? a.d_gc + row * G : a.d_gi + ((size_t)(l - 1) * TB + row) * G;
          out_gi[k] = da_r; out_gi[H + k] = da_z; out_gi[2 * H + k] = da_n;
        }
      }
      __syncthreads();

      // dh_{t-1} of this layer (columns 0..H-1: d_gh . W_hh^T + z * d_h), then
      // the cotangent sent down (columns H..: d_gi . W_ih^T to the layer
      // below, or d_gi . W_x^T + dL/dx_{t+1} to x_t for layer 0)
      const int n_cols = H + (l == 0 ? D : H);
      const int ld = l == 0 ? plan.ld0 : plan.ld1;
      const float* w = w_pk + (l == 0 ? 0 : (size_t)G * plan.ld0 + (size_t)(l - 1) * G * plan.ld1);
      const int part = lane >> 3;
      for (int c0 = warp * 8; c0 < n_cols; c0 += n_warps * 8) {
        const int c = c0 + (lane & 7);
        const bool live = c < n_cols;
        const float* vec = c < H ? dgh_s : dgi_s;
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        if (live) {
#pragma unroll 4
          for (int j = part; j < G; j += kParts) {
            const float wv = w[(size_t)j * ld + c];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = fmaf(vec[r * G + j], wv, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 8);
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 16);
        }
        if (live && part == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (c < H) {
              dh_s[r * LH + l * H + c] = dir_s[r * H + c] + acc[r];
            } else if (l > 0) {
              dfa_s[r * H + c - H] = acc[r];
            } else {
              const int d = c - H;
              dx_s[r * D + d] = (cur[r * RS + o_dp + d] + dx_s[r * D + d]) + acc[r];
            }
          }
        }
      }
      if (l > 0) __syncthreads();
    }
  }
  __syncthreads();

  for (int i = tid; i < R * D; i += nt) {
    const int b = b0 + i / D;
    if (b < a.B) a.d_x0[(size_t)b * D + i % D] = dx_s[i];
  }
}

template <int R>
cudaError_t launch_bptt(const BwdArgs& a, const Plan& p, cudaStream_t stream) {
  void (*kernel)(BwdArgs, Plan) = p.staged ? bptt_kernel<R, true> : bptt_kernel<R, false>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.B + R - 1) / R, p.threads, p.smem, stream>>>(a, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight gradients: out[k, j] = sum_r A(r, k) * Gm[r, j] over n_rows rows, with
//   A(r, k) = a[(r - a_shift) * lda + k] for r >= a_shift (0 before it), k < ka,
//   A(r, ka) = 1 (the bias row, only when db != nullptr).
// Tiles of 32 x 32 outputs; grid.z splits the rows into n_split ranges whose
// partial sums land in `partial` [n_split, ka (+1), nj]; wgrad_sum adds them in
// split order.

constexpr int WG_TILE = 32;
constexpr int WG_THREADS = 256;  // 32 x 8: each thread owns 4 outputs

__global__ void wgrad_partial(const float* a, int lda, int a_shift, int ka, int kt,
                              const float* g, int ldg, int nj, int n_rows,
                              int rows_per_split, float* partial) {
  __shared__ float as[WG_TILE][WG_TILE + 1];
  __shared__ float gs[WG_TILE][WG_TILE + 1];
  const int j0 = blockIdx.x * WG_TILE, k0 = blockIdx.y * WG_TILE, s = blockIdx.z;
  const int tx = threadIdx.x % WG_TILE, ty = threadIdx.x / WG_TILE;
  const int r_begin = s * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int rb = r_begin; rb < r_end; rb += WG_TILE) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rr = ty + 8 * q, r = rb + rr;
      const int k = k0 + tx, j = j0 + tx;
      float av = 0.0f;
      if (r < r_end) {
        if (k < ka) av = r >= a_shift ? a[(size_t)(r - a_shift) * lda + k] : 0.0f;
        else if (k < kt) av = 1.0f;
      }
      as[rr][tx] = av;
      gs[rr][tx] = (r < r_end && j < nj) ? g[(size_t)r * ldg + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < WG_TILE; ++rr) {
      const float gv = gs[rr][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(as[rr][ty + 8 * q], gv, acc[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + ty + 8 * q, j = j0 + tx;
    if (k < kt && j < nj) partial[((size_t)s * kt + k) * nj + j] = acc[q];
  }
}

__global__ void wgrad_sum(const float* partial, int n_split, int ka, int kt, int nj,
                          float* dw, float* db) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kt * nj) return;
  float acc = 0.0f;
  for (int s = 0; s < n_split; ++s) acc += partial[(size_t)s * kt * nj + idx];
  const int k = idx / nj, j = idx % nj;
  if (k < ka) dw[idx] = acc;
  else db[j] = acc;
}

// ------------------------------------------------------- the cluster BPTT
//
// bptt_cluster_kernel: the reverse-time loop on a cluster of C CTAs that
// split every product by the columns K1's cluster path gives them
// (sde_sampler.cuh, "clusters"): CTA c owns hidden units c*uc .. and the
// output columns of its state entries, and holds, per layer, the rows of
// W_hh and of W_x / W_ih that its units' gate columns read ([uc][H + in] of
// float4 {r, z, n, 0}), and the rows of W_out for its output columns
// ([nop][H]). A transposed product is then a sum over the CTAs: each CTA
// forms its part, over its own units or columns, of every output (a lane an
// output, whole dot products over rw rows), sends it into the owner's
// shared memory by st.async (one exchange, see sde_sampler.cuh), and once
// the exchange has landed the owner adds the C parts in CTA order. Per
// reverse step:
//  - output phase: d_out of the CTA's columns (the Euler update's and the
//    lower_bound rule's backward), its part of d_eps (its rows of L times
//    the cotangent, summed along its entries' tril rows) and of
//    dL/dh_top = d_out W_out^T; one exchange;
//  - each layer, top down: the GRU backward of its units (gate cotangents
//    written out for the weight gradients), its parts of dh_{t-1} = d_gh
//    W_hh^T and of the cotangent sent down (d_gi W_ih^T, or d_gi W_x^T for
//    layer 0); one exchange; the owners add the parts.
// Parts are double-buffered by the parity of the exchange count, so a fast
// CTA's next parts never land on ones still being added. The streams a
// CTA's units and entries read (acts and h_{t-1} in 16-byte pieces,
// d_paths, eps) arrive by cp.async into one stage, refilled for the next
// step once layer 0's backward has read it; raw and the direct cotangents
// are read from device memory where they are used. Each row's sums run in
// one order whatever the rows a cluster or the warps, so the result does
// not depend on them and repeats run to run; no atomics. Plain fp32 FMA
// (PERF.md, section 6).

constexpr int kLoads = 4;  // device-memory loads a thread issues together in the output phase

struct ClusterBwdPlan {
  int uc, nop, slots;
  int sr;           // floats of one row of the stage
  int rw;           // rows a warp carries (1, 2 or 4: cluster_bwd_launch)
  size_t w_floats;  // floats of one CTA's packed slices
};

inline size_t cluster_bwd_w_floats(int D, int H, int L, int uc, int nop) {
  return 4 * (size_t)uc * ((size_t)(H + D) + (size_t)(L - 1) * 2 * H) + (size_t)nop * H;
}

inline void make_cluster_bwd(int D, int H, int L, int diag, int C, ClusterBwdPlan* c) {
  c->uc = H / C;
  cluster_columns(D, diag, C, &c->nop, &c->slots);
  c->sr = (5 * L * c->uc + c->slots + D + 3) / 4 * 4;
  c->w_floats = cluster_bwd_w_floats(D, H, L, c->uc, c->nop);
}

inline size_t cluster_bwd_smem(int D, int L, int C, int rows, const ClusterBwdPlan& c) {
  const size_t R = rows, uc = c.uc, S = c.slots;
  const size_t floats = c.w_floats + R * c.sr + R * L * uc + 2 * R * S + R * c.nop + R * uc * 4 + R * uc +
                        2 * 2 * (size_t)C * R * uc + 2 * (size_t)C * R * S;
  return sizeof(float) * floats + sizeof(int) * (size_t)layout_width(D, c.nop, c.slots);
}

inline int cluster_bwd_threads(int rows, int uc) {
  int n = (rows * uc + 31) / 32 * 32;
  return n < 128 ? 128 : n > kClusterThreads ? kClusterThreads : n;
}

constexpr int kTasksPerWarp = 2;  // product tasks a warp takes, at most, where the tasks outnumber the warps

// The rows a warp carries and the CTA's threads at `rows` rows a cluster:
// the fewest rows a warp (1, 2 or 4) at which each task of a layer's
// products (32 output columns of rw rows) has a warp of its own within
// kClusterThreads, and the threads that takes (at least those of the
// elementwise phases); where even 4 rows a warp leave more tasks than
// kClusterThreads has warps, 4 (or the rows) and enough warps for
// kTasksPerWarp tasks each, within kClusterThreads. A product task re-reads
// the CTA's weight slice from shared memory for its rows; more rows a warp
// read it fewer times, more warps shorten the phase (at highdim r5, 40
// rows on clusters of 16: 320 threads 13.1 ms, 768 threads 11.3 ms).
inline void cluster_bwd_launch(int D, int H, int L, int uc, int rows, int* rw, int* threads) {
  const int widest = H + D > (L > 1 ? 2 * H : 0) ? H + D : 2 * H;  // a layer's most output columns
  const int blocks = (widest + 31) / 32;
  *threads = cluster_bwd_threads(rows, uc);
  *rw = rows < 4 ? rows : 4;
  for (int r = 1; r <= *rw; r *= 2)
    if (32 * blocks * (rows / r) <= kClusterThreads) {
      *rw = r;
      if (32 * blocks * (rows / r) > *threads) *threads = 32 * blocks * (rows / r);
      return;
    }
  const int tasks = blocks * (rows / *rw), warps = (tasks + kTasksPerWarp - 1) / kTasksPerWarp;
  if (32 * warps > *threads) *threads = 32 * warps < kClusterThreads ? 32 * warps : kClusterThreads;
}

inline int cluster_bwd_max_rows(int D, int H, int L, int diag, int C, int optin) {
  ClusterBwdPlan c;
  make_cluster_bwd(D, H, L, diag, C, &c);
  int best = 0;
  for (int r = 1; r <= 256; r = r < 4 ? 2 * r : r + 4) {
    if (cluster_bwd_smem(D, L, C, r, c) + kExchangeSmem > (size_t)optin) break;
    best = r;
  }
  return best;
}

template <int RW>
__global__ void __launch_bounds__(kClusterThreads, 1) bptt_cluster_kernel(BwdArgs a, ClusterBwdPlan p, int C, int R) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, G = 3 * a.H, L = a.L, D = a.D, NO = a.D + a.n_tril;
  const int UC = p.uc, NOP = p.nop, S = p.slots, SR = p.sr;
  const size_t TB = (size_t)a.T * a.B;
  const int c = C == 1 ? 0 : (int)cg::this_cluster().block_rank();
  float* w_s = smem;                              // this CTA's packed slices
  float* stage_s = w_s + p.w_floats;              // [R][SR] acts [L][4][UC] | h_{t-1} [L][UC] | d_paths [S] | eps [D]
  float4* dg_s = reinterpret_cast<float4*>(stage_s + R * SR);  // [R][UC] {da_r, da_z, da_n, da_n * r}
  float* dh_s = reinterpret_cast<float*>(dg_s + R * UC);       // [R][L][UC] dL/dh_t of its units (carried)
  float* dir_s = dh_s + R * L * UC;               // [R][UC]    z * d_h
  float* dout_s = dir_s + R * UC;                 // [R][NOP]   d_out of its columns
  float* pfa_s = dout_s + R * NOP;                // [2][C][R][UC] parts of the cotangent into h (by parity)
  float* pdh_s = pfa_s + 2 * C * R * UC;          // [2][C][R][UC] parts of dh_{t-1}
  float* dx_s = pdh_s + 2 * C * R * UC;           // [R][S]     dL/dx_{t+1} of its entries (carried)
  float* dxn_s = dx_s + R * S;                    // [R][S]     d_paths + dx: the cotangent of x_{t+1}
  float* pdx_s = dxn_s + R * S;                   // [C][R][S]  parts of d_gi0 W_x^T
  float* pep_s = pdx_s + C * R * S;               // [C][R][S]  parts of d_eps
  int* ocol_s = reinterpret_cast<int*>(pep_s + C * R * S);
  int* erow_s = ocol_s + NOP;
  int* eseg_s = erow_s + S;
  int* mslot_s = eseg_s + S;
  int* mj_s = mslot_s + NOP;
  int* jslot_s = mj_s + NOP;
  const int o_hp = 4 * L * UC, o_dp = o_hp + L * UC, o_eps = o_dp + S;  // offsets within a stage row

  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31, n_warps = nt >> 5;
  const int b0 = (blockIdx.x / C) * R;
  const int in0 = H + D, in1 = 2 * H;  // columns of a layer's packed rows
  auto layer_w = [&](int l) {
    return reinterpret_cast<const float4*>(w_s) + (l == 0 ? 0 : (size_t)UC * (in0 + (size_t)(l - 1) * in1));
  };
  const float* w_o = w_s + 4 * (size_t)UC * (in0 + (size_t)(L - 1) * in1);  // [NOP][H]

  {
    const float4* src = reinterpret_cast<const float4*>(a.w_clu + (size_t)c * p.w_floats);
    float4* dst = reinterpret_cast<float4*>(w_s);
    for (size_t i = tid; i < p.w_floats / 4; i += nt) dst[i] = src[i];
    const int lw = layout_width(D, NOP, S);
    const int* lay = a.layout + (size_t)c * lw;
    for (int i = tid; i < lw; i += nt) ocol_s[i] = lay[i];
  }
  for (int i = tid; i < R * L * UC; i += nt) dh_s[i] = 0.0f;
  for (int i = tid; i < R * S; i += nt) dx_s[i] = 0.0f;
  __syncthreads();  // the tables

  // a step's exchanges: the output phase's parts (of dL/dh_top for its
  // units, of d_eps for its entries), then each layer's (of dh_{t-1} for its
  // units, and of the cotangent sent down: for its units, or at layer 0 of
  // x_t's for its entries), C parts of each in every owner
  int n_own = 0;
  for (int s = 0; s < S; ++s) n_own += erow_s[s] >= 0;
  const uint32_t unit_parts = 4u * C * R * UC, entry_parts = 4u * C * R * n_own;
  auto bytes = [&](int k) {
    const int i = k % (L + 1);  // 0: the output phase; else layer L - i
    return unit_parts + (i == 0 || i == L ? entry_parts : unit_parts);
  };
  __shared__ uint64_t exchange_s[2];
  Exchanges ex{exchange_s, 0};
  ex.init(bytes(0), bytes(1));

  // the streams of step t for the cluster's rows into the stage: acts and
  // h_{t-1} of its units in 16-byte pieces (UC is a multiple of 8; acts and
  // h_all are 16-byte aligned), d_paths of its entries and eps a float each
  const int pieces = UC / 4, row_pieces = 5 * L * pieces, singles = S + D;
  auto prefetch = [&](int t) {
    for (int i = tid; i < R * row_pieces; i += nt) {
      const int r = i / row_pieces, seg = (i % row_pieces) / pieces, u = 4 * (i % pieces), b = b0 + r;
      const size_t row = (size_t)t * a.B + b;
      bool valid = b < a.B;
      const float* src;
      if (seg < 4 * L) {  // acts [l][g][u] of its units, from [L, T, B, 4H]
        src = a.acts + ((size_t)(seg / 4) * TB + row) * 4 * H + (seg % 4) * H + c * UC + u;
      } else {  // h_{t-1} [l][u] of its units
        valid = valid && t > 0;
        src = a.h_all + (row - a.B) * (size_t)(L * H) + (seg - 4 * L) * H + c * UC + u;
      }
      cp_async16(stage_s + r * SR + seg * UC + u, valid ? src : a.acts, valid);
    }
    for (int i = tid; i < R * singles; i += nt) {
      const int r = i / singles, e = i % singles, b = b0 + r;
      const size_t row = (size_t)t * a.B + b;
      bool valid = b < a.B;
      const float* src = a.eps;
      if (e < S) {  // d_paths of its entries
        const int en = erow_s[e];
        valid = valid && en >= 0;
        src = a.d_paths + row * D + (en < 0 ? 0 : en);
      } else {
        src = a.eps + row * D + (e - S);
      }
      cp_async4(stage_s + r * SR + o_dp + e, valid ? src : a.eps, valid);
    }
    cp_async_commit();
  };
  // v into buf[idx] of the owner (CTA `owner`), in the current exchange
  auto put = [&](float* buf, int owner, size_t idx, float v) { ex.send(buf, idx, owner, v); };

  prefetch(a.T - 1);
  cluster_barrier(C);  // every CTA's tables, buffers and mbarriers before any peer writes
  const int& phase = ex.done;  // exchanges done; parts use buffer phase & 1

  for (int t = a.T - 1; t >= 0; --t) {
    cp_async_wait_all();
    __syncthreads();  // step t's stage; last step's sums
    for (int i = tid; i < R * S; i += nt) {
      const int r = i / S, s = i % S;
      dxn_s[i] = erow_s[s] < 0 ? 0.0f : stage_s[r * SR + o_dp + s] + dx_s[i];
    }
    __syncthreads();

    // ---- output phase: d_out of its columns, its parts of d_eps --------------
    // d_out of its columns, kLoads items a thread at a time: their loads from
    // device memory (the direct cotangent, raw on the diagonal) go out together
    for (int i0 = tid; i0 < R * NOP; i0 += kLoads * nt) {
      float direct[kLoads], raw_v[kLoads];
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int i = i0 + q * nt, r = i / NOP, m = i % NOP, b = b0 + r;
        const int o = i < R * NOP ? ocol_s[m] : -1;
        const size_t row = (size_t)t * a.B + b;
        direct[q] = raw_v[q] = 0.0f;
        if (o >= 0 && b < a.B) {
          direct[q] = o < D ? __ldg(a.d_means + row * D + o) : __ldg(a.d_cholv + row * a.n_tril + (o - D));
          if (o >= D && erow_s[mslot_s[m]] == mj_s[m]) raw_v[q] = __ldg(a.raw + row * NO + o);
        }
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int i = i0 + q * nt, r = i / NOP, m = i % NOP, b = b0 + r;
        if (i >= R * NOP) break;
        const int o = ocol_s[m];
        float dv = 0.0f;
        if (o >= 0 && b < a.B) {
          const float dxn = dxn_s[r * S + mslot_s[m]];
          if (o < D) {
            dv = direct[q] + dxn * a.dt;
          } else {
            const int j = mj_s[m];
            dv = direct[q] + dxn * stage_s[r * SR + o_eps + j] * a.sqrt_dt;
            if (erow_s[mslot_s[m]] == j && !(raw_v[q] >= a.diag_min || dv < 0.0f)) dv = 0.0f;
          }
          a.d_out[((size_t)t * a.B + b) * NO + o] = dv;
        }
        dout_s[r * NOP + m] = dv;
      }
    }
    // its parts of d_eps[j]: over its entries e >= j (diag: e == j), dxn_e
    // times L_ej (the diagonal clamped), kLoads entries' raw loaded together
    for (int i = tid; i < R * D; i += nt) {
      const int r = i / D, j = i % D, b = b0 + r;
      const size_t row = (size_t)t * a.B + b;
      float acc = 0.0f;
      for (int s0 = 0; s0 < S && b < a.B; s0 += kLoads) {
        float v[kLoads];
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int s = s0 + q, e = s < S ? erow_s[s] : -1;
          const bool on = e >= 0 && (a.diag ? e == j : e >= j);
          v[q] = on ? __ldg(a.raw + row * NO + ocol_s[eseg_s[s] + 1 + (a.diag ? 0 : j)]) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int s = s0 + q, e = s < S ? erow_s[s] : -1;
          if (e < 0 || (a.diag ? e != j : e < j)) continue;
          acc = fmaf(dxn_s[r * S + s], e == j ? fmaxf(v[q], a.diag_min) : v[q], acc);
        }
      }
      put(pep_s, entry_owner(j, C), ((size_t)c * R + r) * S + jslot_s[j], acc);
    }
    __syncthreads();
    // its part of dL/dh_top = d_out W_out^T: a lane a unit of the layer, whole dot products
    {
      const int kb = (H + 31) / 32, tasks = kb * (R / RW);
      float* dst_base = pfa_s + (size_t)(phase & 1) * C * R * UC;
      for (int task = warp; task < tasks; task += n_warps) {
        const int k = (task % kb) * 32 + lane, q0 = (task / kb) * RW;
        if (k >= H) continue;
        float acc[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[r] = 0.0f;
#pragma unroll 8
        for (int m = 0; m < NOP; ++m) {
          const float wv = w_o[(size_t)m * H + k];
#pragma unroll
          for (int r = 0; r < RW; ++r) acc[r] = fmaf(dout_s[(q0 + r) * NOP + m], wv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) put(dst_base, k / UC, ((size_t)c * R + q0 + r) * UC + k % UC, acc[r]);
      }
    }
    ex.finish(bytes(ex.done + 2));
    // the owners' d_eps: the C parts in CTA order
    for (int i = tid; i < R * S; i += nt) {
      const int r = i / S, s = i % S, e = erow_s[s], b = b0 + r;
      if (e < 0 || b >= a.B) continue;
      float acc = 0.0f;
      for (int q = 0; q < C; ++q) acc += pep_s[((size_t)q * R + r) * S + s];
      a.d_eps[((size_t)t * a.B + b) * D + e] = acc * a.sqrt_dt;
    }

    // ---- GRU BPTT, top layer down ---------------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      const float* pfa = pfa_s + (size_t)((phase - 1) & 1) * C * R * UC;  // the cotangent into h_l, in parts
      for (int i = tid; i < R * UC; i += nt) {
        const int r = i / UC, u = i % UC, b = b0 + r, k = c * UC + u;
        const float* st = stage_s + r * SR;
        float dfa = 0.0f;
        for (int q = 0; q < C; ++q) dfa += pfa[((size_t)q * R + r) * UC + u];
        const float* act = st + l * 4 * UC;
        const float rg = act[u], zg = act[UC + u], ng = act[2 * UC + u], n_hh = act[3 * UC + u];
        const float h_prev = st[o_hp + l * UC + u];
        const float d_h = dh_s[(r * L + l) * UC + u] + dfa;
        const float dn = d_h * (1.0f - zg);
        const float dz = d_h * (h_prev - ng);
        const float da_n = dn * (1.0f - ng * ng);
        const float d_r = da_n * n_hh;
        const float d_gh_n = da_n * rg;
        const float da_r = d_r * rg * (1.0f - rg);
        const float da_z = dz * zg * (1.0f - zg);
        dir_s[i] = d_h * zg;
        dg_s[i] = make_float4(da_r, da_z, da_n, d_gh_n);
        if (b < a.B) {
          const size_t row = (size_t)t * a.B + b;
          float* out_gh = a.d_gh + ((size_t)l * TB + row) * G;
          out_gh[k] = da_r; out_gh[H + k] = da_z; out_gh[2 * H + k] = d_gh_n;
          float* out_gi = l == 0 ? a.d_gc + row * G : a.d_gi + ((size_t)(l - 1) * TB + row) * G;
          out_gi[k] = da_r; out_gi[H + k] = da_z; out_gi[2 * H + k] = da_n;
        }
      }
      __syncthreads();  // its gate cotangents
      if (l == 0 && t > 0) prefetch(t - 1);  // layer 0 was the stage's last reader

      // its parts of dh_{t-1} (columns 0..H-1, through W_hh) and of the
      // cotangent sent down (columns H..: through W_ih, or W_x for layer 0)
      const int n_cols = H + (l == 0 ? D : H), n_in = l == 0 ? in0 : in1;
      const float4* wl = layer_w(l);
      const int cb = (n_cols + 31) / 32, tasks = cb * (R / RW);
      float* pdh = pdh_s + (size_t)(phase & 1) * C * R * UC;
      float* pfa_next = pfa_s + (size_t)(phase & 1) * C * R * UC;
      for (int task = warp; task < tasks; task += n_warps) {
        const int col = (task % cb) * 32 + lane, q0 = (task / cb) * RW;
        if (col >= n_cols) continue;
        const bool hidden = col < H;
        float acc[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[r] = 0.0f;
#pragma unroll 4
        for (int u = 0; u < UC; ++u) {
          const float4 wv = wl[(size_t)u * n_in + col];
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const float4 g = dg_s[(q0 + r) * UC + u];
            acc[r] = fmaf(g.x, wv.x, acc[r]);
            acc[r] = fmaf(g.y, wv.y, acc[r]);
            acc[r] = fmaf(hidden ? g.w : g.z, wv.z, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const size_t q = (size_t)c * R + q0 + r;
          if (hidden) {
            put(pdh, col / UC, q * UC + col % UC, acc[r]);
          } else if (l > 0) {
            put(pfa_next, (col - H) / UC, q * UC + (col - H) % UC, acc[r]);
          } else {
            put(pdx_s, entry_owner(col - H, C), q * S + jslot_s[col - H], acc[r]);
          }
        }
      }
      ex.finish(bytes(ex.done + 2));
      // the owners add the parts: dh_{t-1} = z d_h + d_gh W_hh^T; x_t's cotangent
      const float* pdh_in = pdh_s + (size_t)((phase - 1) & 1) * C * R * UC;
      for (int i = tid; i < R * UC; i += nt) {
        const int r = i / UC, u = i % UC;
        float acc = 0.0f;
        for (int q = 0; q < C; ++q) acc += pdh_in[((size_t)q * R + r) * UC + u];
        dh_s[(r * L + l) * UC + u] = dir_s[i] + acc;
      }
      if (l == 0) {
        for (int i = tid; i < R * S; i += nt) {
          const int r = i / S, s = i % S;
          float acc = 0.0f;
          for (int q = 0; q < C; ++q) acc += pdx_s[((size_t)q * R + r) * S + s];
          dx_s[i] = dxn_s[i] + acc;
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * S; i += nt) {
    const int r = i / S, s = i % S, e = erow_s[s], b = b0 + r;
    if (e >= 0 && b < a.B) a.d_x0[(size_t)b * D + e] = dx_s[i];
  }
  cluster_barrier(C);  // no CTA leaves while a peer may still address it
}

template <int RW>
cudaError_t launch_cluster_bptt(const BwdArgs& a, const ClusterBwdPlan& p, int C, int R, int threads, size_t smem,
                                cudaStream_t stream) {
  void (*kernel)(BwdArgs, ClusterBwdPlan, int, int) = bptt_cluster_kernel<RW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return launch_clusters(kernel, (a.B + R - 1) / R, C, threads, smem, stream, a, p, C, R);
}

// Clusters of C the card runs at once at the cluster BPTT's most rows.
inline cudaError_t bwd_cluster_slots(int D, int H, int L, int diag, int C, int max_rows, int n_sms, int* slots) {
  ClusterBwdPlan c;
  make_cluster_bwd(D, H, L, diag, C, &c);
  int rw = 0, threads = 0;
  cluster_bwd_launch(D, H, L, c.uc, max_rows, &rw, &threads);
  void (*kernel)(BwdArgs, ClusterBwdPlan, int, int) =
      rw == 1 ? bptt_cluster_kernel<1> : rw == 2 ? bptt_cluster_kernel<2> : bptt_cluster_kernel<4>;
  int held = 0;
  cudaError_t err = max_active_clusters(kernel, C, threads, cluster_bwd_smem(D, L, C, max_rows, c), &held);
  if (err != cudaSuccess) return err;
  *slots = held < n_sms / C ? held : n_sms / C;
  return *slots > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------------------- plan

enum BwdPath { kBwdStreaming = 0, kBwdStaged = 1, kBwdCluster = 2 };

struct BwdPlan {
  int path, cluster, rows, threads;
  size_t smem, w_floats;
  Plan block;
  ClusterBwdPlan clu;
};

// K2's BPTT launch for a shape, by shape alone unless `path`, `cluster` or
// `rows` ask for one (-1, 0, 0), by K1's rule (make_fwd_plan): the
// one-block kernel with its matrices staged where they fit a block; else the
// cluster kernel at the cluster (2, 4, 8 or 16) that takes the fewest waves; else
// the one-block kernel streaming them. Mirrored by `plan_backward` in
// ops/sde_sampler.py.
inline cudaError_t make_bwd_plan(int D, int H, int L, int n_tril, int diag, int B, int path, int cluster, int rows,
                                 int n_sms, int optin, BwdPlan* p) {
  if (L < 1 || B < 1) return cudaErrorInvalidValue;
  const int block_rows = path != kBwdCluster && rows > 0 ? rows : cluster_rows(B, n_sms, 4);
  cudaError_t err = make_plan(D, H, L, n_tril, block_rows, optin, &p->block);
  if (err != cudaSuccess) return err;
  if (path < 0) {
    path = p->block.staged ? kBwdStaged : kBwdStreaming;
    int best = 0;
    for (int C = 2; path != kBwdStaged && C <= kMaxCluster; C *= 2) {
      const int max_rows = H % (8 * C) == 0 ? cluster_bwd_max_rows(D, H, L, diag, C, optin) : 0;
      int slots = 0;
      if (max_rows > 0 && (err = bwd_cluster_slots(D, H, L, diag, C, max_rows, n_sms, &slots)) != cudaSuccess)
        return err;
      const int waves = max_rows > 0 ? cluster_waves(B, slots, max_rows) : 0;
      if (waves > 0 && (best == 0 || waves < best)) {
        path = kBwdCluster;
        cluster = C;
        best = waves;
      }
    }
  }
  p->path = path;
  if (path == kBwdCluster) {
    if (cluster <= 0)
      for (cluster = 1; cluster <= kMaxCluster; cluster *= 2)
        if (H % (8 * cluster) == 0 && cluster_bwd_max_rows(D, H, L, diag, cluster, optin) > 0) break;
    if (cluster > kMaxCluster || H % (8 * cluster) != 0) return cudaErrorInvalidValue;
    const int max_rows = cluster_bwd_max_rows(D, H, L, diag, cluster, optin);
    if (max_rows < 1) return cudaErrorInvalidValue;
    if (rows <= 0) {
      int slots = 0;
      err = bwd_cluster_slots(D, H, L, diag, cluster, max_rows, n_sms, &slots);
      if (err != cudaSuccess) return err;
      rows = cluster_rows(B, slots, max_rows);
    }
    if (rows > max_rows || rows != round_rows(rows)) return cudaErrorInvalidValue;
    make_cluster_bwd(D, H, L, diag, cluster, &p->clu);
    cluster_bwd_launch(D, H, L, p->clu.uc, rows, &p->clu.rw, &p->threads);
    p->cluster = cluster;
    p->rows = rows;
    p->smem = cluster_bwd_smem(D, L, cluster, rows, p->clu);
    p->w_floats = p->clu.w_floats;
    return cudaSuccess;
  }
  if (path != kBwdStaged && path != kBwdStreaming) return cudaErrorInvalidValue;
  if (path == kBwdStaged && !p->block.staged) return cudaErrorInvalidValue;
  if (p->block.smem_streaming > (size_t)optin) return cudaErrorInvalidValue;
  p->block.staged = path == kBwdStaged ? 1 : 0;
  p->block.smem = p->block.staged ? p->block.smem_staged : p->block.smem_streaming;
  p->cluster = 1;
  p->rows = block_rows;
  p->threads = p->block.threads;
  p->smem = p->block.smem;
  p->w_floats = p->block.w_floats;
  p->clu = ClusterBwdPlan{};
  return cudaSuccess;
}

inline cudaError_t bwd_limits(int* n_sms, int* optin) {
  cudaError_t err = sm_count(n_sms);
  return err != cudaSuccess ? err : optin_smem(optin);
}

}  // namespace sde_sampler

// K2's BPTT plan for a shape (make_bwd_plan): out = {path, cluster, rows,
// threads, smem bytes, packed floats (per CTA on the cluster path), the
// one-block layout's ld0 and ld1, the cluster layout's uc, nop, slots, rows
// a warp}. The caller packs w_bptt with these.
extern "C" int sde_sampler_bwd_plan(int D, int H, int L, int n_tril, int diag, int B, int path, int cluster,
                                    int rows, long long* out) {
  using namespace sde_sampler;
  int n_sms = 0, optin = 0;
  cudaError_t err = bwd_limits(&n_sms, &optin);
  if (err != cudaSuccess) return (int)err;
  BwdPlan p;
  err = make_bwd_plan(D, H, L, n_tril, diag, B, path, cluster, rows, n_sms, optin, &p);
  if (err != cudaSuccess) return (int)err;
  const long long vals[12] = {p.path, p.cluster, p.rows, p.threads, (long long)p.smem, (long long)p.w_floats,
                              p.block.ld0, p.block.ld1, p.clu.uc, p.clu.nop, p.clu.slots, p.clu.rw};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}

// `path`, `cluster`, `rows`: -1, 0, 0 for the plan by shape, or what to ask
// for (make_bwd_plan). `w_bptt` holds the matrices packed for that plan
// (the one-block paths), `w_clu` and `layout` the cluster path's.
extern "C" int sde_sampler_bwd(
    const float* gc, const float* eps, const float* x_in, const float* h_all, const float* raw,
    const float* d_paths, const float* d_means, const float* d_cholv,
    const float* w_x, const float* w_hh0, const float* b_hh0,
    const float* w_ih_st, const float* w_hh_st, const float* b_ih_st, const float* b_hh_st,
    const float* w_bptt, const float* w_outT, const int* tril_rows, const int* tril_cols,
    const float* w_clu, const int* layout,
    float* acts, float* d_gc, float* d_eps, float* d_x0, float* d_gh, float* d_gi, float* d_out,
    int B, int T, int D, int H, int L, int n_tril, int diag, int path, int cluster, int rows,
    float dt, float sqrt_dt, float diag_min, void* stream) {
  using namespace sde_sampler;
  BwdArgs a{gc, eps, x_in, h_all, raw, d_paths, d_means, d_cholv,
            w_x, w_hh0, b_hh0, w_ih_st, w_hh_st, b_ih_st, b_hh_st,
            w_bptt, w_outT, tril_rows, tril_cols, w_clu, layout,
            acts, d_gc, d_eps, d_x0, d_gh, d_gi, d_out,
            B, T, D, H, L, n_tril, diag, dt, sqrt_dt, diag_min};
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_sms = 0, optin = 0;
  cudaError_t err = bwd_limits(&n_sms, &optin);
  if (err != cudaSuccess) return (int)err;
  BwdPlan p;
  err = make_bwd_plan(D, H, L, n_tril, diag, B, path, cluster, rows, n_sms, optin, &p);
  if (err != cudaSuccess) return (int)err;

  int gate_rows = 32;  // the most rows whose tiles fit the block's shared memory
  while (gate_rows > 8 && gate_smem(gate_rows, D, H) > (size_t)optin) gate_rows /= 2;
  const size_t smem_g = gate_smem(gate_rows, D, H);
  if (smem_g > (size_t)optin) return (int)cudaErrorInvalidValue;
  void (*gates)(BwdArgs) = gate_rows == 32 ? gates_kernel<32> : gate_rows == 16 ? gates_kernel<16> : gates_kernel<8>;
  err = allow_smem(gates, smem_g);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = T * B;
  const int gate_warps = (3 * H + kGateCols - 1) / kGateCols;
  const int gate_threads = 32 * (gate_warps < kGateWarps ? gate_warps : kGateWarps);
  gates<<<(n_rows + gate_rows - 1) / gate_rows, gate_threads, smem_g, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (p.path == kBwdCluster) {
    switch (p.clu.rw) {
      case 1: return (int)launch_cluster_bptt<1>(a, p.clu, p.cluster, p.rows, p.threads, p.smem, st);
      case 2: return (int)launch_cluster_bptt<2>(a, p.clu, p.cluster, p.rows, p.threads, p.smem, st);
      case 4: return (int)launch_cluster_bptt<4>(a, p.clu, p.cluster, p.rows, p.threads, p.smem, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (p.rows) {
    case 1: err = launch_bptt<1>(a, p.block, st); break;
    case 2: err = launch_bptt<2>(a, p.block, st); break;
    case 4: err = launch_bptt<4>(a, p.block, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" int sde_sampler_weight_grad(
    const float* a, int lda, int a_shift, int ka,
    const float* g, int ldg, int nj, int n_rows,
    float* partial, int n_split, float* dw, float* db, void* stream) {
  using namespace sde_sampler;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kt = ka + (db != nullptr ? 1 : 0);
  const int rows_per_split = (n_rows + n_split - 1) / n_split;
  const dim3 grid((nj + WG_TILE - 1) / WG_TILE, (kt + WG_TILE - 1) / WG_TILE, n_split);
  wgrad_partial<<<grid, WG_THREADS, 0, s>>>(a, lda, a_shift, ka, kt, g, ldg, nj, n_rows,
                                            rows_per_split, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = kt * nj;
  wgrad_sum<<<(n + 255) / 256, 256, 0, s>>>(partial, n_split, ka, kt, nj, dw, db);
  return (int)cudaGetLastError();
}

// Clusters of C CTAs of bptt_cluster_kernel the card holds at once.
extern "C" int sde_sampler_bwd_max_clusters(int C, int rw, int threads, long long smem, int* out) {
  using namespace sde_sampler;
  void (*kernel)(BwdArgs, ClusterBwdPlan, int, int) =
      rw == 1 ? bptt_cluster_kernel<1> : rw == 2 ? bptt_cluster_kernel<2> : bptt_cluster_kernel<4>;
  return (int)max_active_clusters(kernel, C, threads, (size_t)smem, out);
}
