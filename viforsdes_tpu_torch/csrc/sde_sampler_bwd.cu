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
//  2. bptt_kernel: one block per `rows` batch rows walks the reverse steps.
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
  float* acts;            // [L, T, B, 4H]  r, z, n, n_hh (scratch)
  float* d_gc;            // [T, B, 3H]   (= d_gi of layer 0)
  float* d_eps;           // [T, B, D]
  float* d_x0;            // [B, D]       without the direct d_paths[:, 0] term
  float* d_gh;            // [L, T, B, 3H]
  float* d_gi;            // [L-1, T, B, 3H]
  float* d_out;           // [T, B, D + n_tril]
  int B, T, D, H, L, n_tril;
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
  size_t w_floats;  // floats of the packed matrices (the caller's w_bptt)
};

// Floats of one stage row: acts (L*4H), h_{t-1} (L*H), d_paths, d_means, eps
// (D each), d_cholv (n_tril), raw (D + n_tril).
__host__ __device__ inline int stage_row(int D, int H, int L, int n_tril) {
  return 5 * L * H + 4 * D + 2 * n_tril;
}

// The launch of bptt_kernel for a shape, chosen by shape alone: staged when
// the packed matrices and the rest fit the card's opt-in shared memory.
inline cudaError_t make_plan(int D, int H, int L, int n_tril, int rows, Plan* p) {
  const size_t G = 3 * (size_t)H, NO = (size_t)D + n_tril, LH = (size_t)L * H;
  p->ld0 = packed_ld(H + D);
  p->ld1 = packed_ld(2 * H);
  p->w_floats = G * (p->ld0 + (size_t)(L - 1) * p->ld1);
  const size_t work = 2 * (size_t)rows * stage_row(D, H, L, n_tril) +
                      rows * (LH + 2 * G + 2 * (size_t)H + NO + D);
  const size_t base = sizeof(float) * work + sizeof(int) * 2 * n_tril;
  const size_t staged = base + sizeof(float) * (p->w_floats + NO * H);
  int optin = 0;
  cudaError_t err = optin_smem(&optin);
  if (err != cudaSuccess) return err;
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

}  // namespace sde_sampler

// The bptt_kernel launch for a shape: out = {ld0, ld1, staged, threads, smem
// bytes, packed floats}. The caller packs w_bptt with these row strides.
extern "C" int sde_sampler_bwd_plan(int D, int H, int L, int n_tril, int rows, long long* out) {
  using namespace sde_sampler;
  Plan p;
  cudaError_t err = make_plan(D, H, L, n_tril, rows, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.ld0; out[1] = p.ld1; out[2] = p.staged; out[3] = p.threads;
  out[4] = (long long)p.smem; out[5] = (long long)p.w_floats;
  return 0;
}

extern "C" int sde_sampler_bwd(
    const float* gc, const float* eps, const float* x_in, const float* h_all, const float* raw,
    const float* d_paths, const float* d_means, const float* d_cholv,
    const float* w_x, const float* w_hh0, const float* b_hh0,
    const float* w_ih_st, const float* w_hh_st, const float* b_ih_st, const float* b_hh_st,
    const float* w_bptt, const float* w_outT, const int* tril_rows, const int* tril_cols,
    float* acts, float* d_gc, float* d_eps, float* d_x0, float* d_gh, float* d_gi, float* d_out,
    int B, int T, int D, int H, int L, int n_tril, int rows,
    float dt, float sqrt_dt, float diag_min, void* stream) {
  using namespace sde_sampler;
  BwdArgs a{gc, eps, x_in, h_all, raw, d_paths, d_means, d_cholv,
            w_x, w_hh0, b_hh0, w_ih_st, w_hh_st, b_ih_st, b_hh_st,
            w_bptt, w_outT, tril_rows, tril_cols,
            acts, d_gc, d_eps, d_x0, d_gh, d_gi, d_out,
            B, T, D, H, L, n_tril, dt, sqrt_dt, diag_min};
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  cudaError_t err = make_plan(D, H, L, n_tril, rows, &p);
  if (err != cudaSuccess) return (int)err;

  int optin = 0;
  err = optin_smem(&optin);
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

  switch (rows) {
    case 1: err = launch_bptt<1>(a, p, st); break;
    case 2: err = launch_bptt<2>(a, p, st); break;
    case 4: err = launch_bptt<4>(a, p, st); break;
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
