// K2: backward (reverse-time BPTT) of the fused GRU path sampler.
//
// Replaces the TPU kernel `_bwd_kernel` of viforsdes_tpu/ops/pallas/sde_sampler.py
// (launched by `FusedPathSampler._backward`). Walking t = T-1 .. 0 it recomputes
// each layer's gates from the stashed h_{t-1} (no activation stash), back-
// propagates the Euler update and the output projection, applies the
// lower_bound rule to the SUMMED Cholesky cotangent (pass iff raw >= diag_min
// or the cotangent is negative), and emits d_gates_const, d_eps and dx0.
//
// What bounds it on an H100: like K1, a serial time loop of small matvecs
// (recompute: ~2L gate matvecs; BPTT: 2L transposed matvecs) with a block
// barrier between dependent phases; at B=128 only 32 blocks run. The weight
// gradients are the other cost: each is a sum over all T*B rows of an outer
// product (h^T . dgates), 3H*H fp32 per GRU matrix, 48 KB each at H=64. They
// cannot live in registers, and per-block shared-memory copies of all of them
// would exceed a block's 227 KB at three layers.
//
// Design: the BPTT kernel writes the per-step gate cotangents (d_gi, d_gh per
// layer, d_out) as streams; `weight_grad` then forms every dW = A^T . G (and db
// as a row of ones in A) as a tiled reduction over the T*B rows, split over
// row ranges into a [n_split, K, N] scratch that a second small kernel sums in
// a fixed order. No atomics: the result is bitwise reproducible run to run,
// as the TPU kernel's sequential accumulation is. The weight reads of the
// transposed matvecs use W^T copies made by the caller, so they coalesce.

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
  const float* w_x;       // [D, 3H]
  const float* w_hh0;     // [H, 3H]
  const float* b_hh0;     // [3H]
  const float* w_ih_st;   // [L-1, H, 3H]
  const float* w_hh_st;   // [L-1, H, 3H]
  const float* b_ih_st;   // [L-1, 3H]
  const float* b_hh_st;   // [L-1, 3H]
  const float* w_xT;      // [3H, D]
  const float* w_hh0T;    // [3H, H]
  const float* w_ih_stT;  // [L-1, 3H, H]
  const float* w_hh_stT;  // [L-1, 3H, H]
  const float* w_outT;    // [D + n_tril, H]
  const int* tril_rows;
  const int* tril_cols;
  float* d_gc;            // [T, B, 3H]   (= d_gi of layer 0)
  float* d_eps;           // [T, B, D]
  float* d_x0;            // [B, D]       without the direct d_paths[:, 0] term
  float* d_gh;            // [L, T, B, 3H]
  float* d_gi;            // [L-1, T, B, 3H]
  float* d_out;           // [T, B, D + n_tril]
  int B, T, D, H, L, n_tril;
  float dt, sqrt_dt, diag_min;
};

__global__ void bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, G = 3 * a.H, L = a.L, D = a.D, LH = a.L * a.H;
  const int NO = a.D + a.n_tril;
  float* dh_s = smem;                 // [ROWS][LH]  dL/dh_t per layer (carried)
  float* hp_s = dh_s + ROWS * LH;     // [ROWS][LH]  h_{t-1}
  float* hc_s = hp_s + ROWS * LH;     // [ROWS][LH]  h_t
  float* gi_s = hc_s + ROWS * LH;     // [L][ROWS][G] recomputed input gates
  float* gh_s = gi_s + L * ROWS * G;  // [L][ROWS][G] recomputed hidden gates
  float* dgi_s = gh_s + L * ROWS * G; // [ROWS][G]
  float* dgh_s = dgi_s + ROWS * G;    // [ROWS][G]
  float* dfa_s = dgh_s + ROWS * G;    // [ROWS][H]   cotangent from the layer above
  float* dir_s = dfa_s + ROWS * H;    // [ROWS][H]   z * d_h (direct path to h_{t-1})
  float* dout_s = dir_s + ROWS * H;   // [ROWS][NO]
  float* dx_s = dout_s + ROWS * NO;   // [ROWS][D]   dL/dx_t (carried)
  float* dxn_s = dx_s + ROWS * D;     // [ROWS][D]   dL/dx_{t+1} in this step
  float* xt_s = dxn_s + ROWS * D;     // [ROWS][D]

  const int b0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t TB = (size_t)a.T * a.B;

  for (int i = tid; i < ROWS * LH; i += nt) dh_s[i] = 0.0f;
  for (int i = tid; i < ROWS * D; i += nt) dx_s[i] = 0.0f;
  __syncthreads();

  for (int t = a.T - 1; t >= 0; --t) {
    // ---- load h_{t-1}, h_t, x_t ------------------------------------------
    for (int i = tid; i < ROWS * LH; i += nt) {
      const int b = b0 + i / LH, c = i % LH;
      const bool ok = b < a.B;
      hc_s[i] = ok ? a.h_all[((size_t)t * a.B + b) * LH + c] : 0.0f;
      hp_s[i] = ok && t > 0 ? a.h_all[((size_t)(t - 1) * a.B + b) * LH + c] : 0.0f;
    }
    for (int i = tid; i < ROWS * D; i += nt) {
      const int b = b0 + i / D, d = i % D;
      const bool ok = b < a.B;
      xt_s[i] = ok ? a.x_in[((size_t)t * a.B + b) * D + d] : 0.0f;
      dxn_s[i] = (ok ? a.d_paths[((size_t)t * a.B + b) * D + d] : 0.0f) + dx_s[i];
    }
    __syncthreads();

    // ---- recompute every layer's gate pre-activations (independent) -------
    for (int l = 0; l < L; ++l) {
      const float* w_in = l == 0 ? a.w_x : a.w_ih_st + (size_t)(l - 1) * H * G;
      const float* in_s = l == 0 ? xt_s : hc_s + (l - 1) * H;
      const int in_dim = l == 0 ? D : H;
      const int in_ld = l == 0 ? D : LH;
      const float* w_h = l == 0 ? a.w_hh0 : a.w_hh_st + (size_t)(l - 1) * H * G;
      const float* b_h = l == 0 ? a.b_hh0 : a.b_hh_st + (size_t)(l - 1) * G;
      for (int j = tid; j < G; j += nt) {
        float ai[ROWS], ah[ROWS];
        const float bh = b_h[j];
        const float bi = l == 0 ? 0.0f : a.b_ih_st[(size_t)(l - 1) * G + j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int b = b0 + r;
          ai[r] = l == 0 ? (b < a.B ? a.gc[((size_t)t * a.B + b) * G + j] : 0.0f) : bi;
          ah[r] = bh;
        }
        for (int k = 0; k < in_dim; ++k) {
          const float w = w_in[(size_t)k * G + j];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) ai[r] = fmaf(in_s[r * in_ld + k], w, ai[r]);
        }
        for (int k = 0; k < H; ++k) {
          const float w = w_h[(size_t)k * G + j];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) ah[r] = fmaf(hp_s[r * LH + l * H + k], w, ah[r]);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          gi_s[(l * ROWS + r) * G + j] = ai[r];
          gh_s[(l * ROWS + r) * G + j] = ah[r];
        }
      }
    }

    // ---- Euler update + output projection backward ------------------------
    for (int i = tid; i < ROWS * NO; i += nt) {
      const int r = i / NO, o = i % NO, b = b0 + r;
      float dv = 0.0f;
      if (b < a.B) {
        const size_t row = (size_t)t * a.B + b;
        if (o < D) {
          dv = a.d_means[row * D + o] + dxn_s[r * D + o] * a.dt;
        } else {
          const int k = o - D, rk = a.tril_rows[k], ck = a.tril_cols[k];
          dv = a.d_cholv[row * a.n_tril + k] +
               dxn_s[r * D + rk] * a.eps[row * D + ck] * a.sqrt_dt;
          const float raw = a.raw[row * NO + o];
          if (rk == ck && !(raw >= a.diag_min || dv < 0.0f)) dv = 0.0f;
        }
        a.d_out[row * NO + o] = dv;
      }
      dout_s[i] = dv;
    }
    for (int i = tid; i < ROWS * D; i += nt) {
      const int r = i / D, c = i % D, b = b0 + r;
      if (b >= a.B) continue;
      const size_t row = (size_t)t * a.B + b;
      float acc = 0.0f;
      for (int k = 0; k < a.n_tril; ++k) {
        if (a.tril_cols[k] != c) continue;
        float v = a.raw[row * NO + D + k];
        if (a.tril_rows[k] == c) v = fmaxf(v, a.diag_min);
        acc = fmaf(dxn_s[r * D + a.tril_rows[k]], v, acc);
      }
      a.d_eps[row * D + c] = acc * a.sqrt_dt;
    }
    __syncthreads();
    for (int i = tid; i < ROWS * H; i += nt) {
      const int r = i / H, k = i % H;
      float acc = 0.0f;
      for (int o = 0; o < NO; ++o) acc = fmaf(dout_s[r * NO + o], a.w_outT[(size_t)o * H + k], acc);
      dfa_s[i] = acc;
    }
    __syncthreads();

    // ---- GRU BPTT, top layer down -----------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      for (int i = tid; i < ROWS * H; i += nt) {
        const int r = i / H, k = i % H, b = b0 + r;
        const float* gi = gi_s + (l * ROWS + r) * G;
        const float* gh = gh_s + (l * ROWS + r) * G;
        const float rg = sigmoidf_(gi[k] + gh[k]);
        const float zg = sigmoidf_(gi[H + k] + gh[H + k]);
        const float n_hh = gh[2 * H + k];
        const float ng = tanhf(gi[2 * H + k] + rg * n_hh);
        const float h_prev = hp_s[r * LH + l * H + k];
        const float d_h = dh_s[r * LH + l * H + k] + dfa_s[i];
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
      // dh_{t-1} of this layer (columns 0..H-1), then the cotangent sent down:
      // to the layer below (H columns) or to x_t (D columns) for layer 0.
      const float* w_hT = l == 0 ? a.w_hh0T : a.w_hh_stT + (size_t)(l - 1) * G * H;
      const int n_down = l == 0 ? D : H;
      for (int c = tid; c < H + n_down; c += nt) {
        float acc[ROWS];
        if (c < H) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] = dir_s[r * H + c];
          for (int j = 0; j < G; ++j) {
            const float w = w_hT[(size_t)j * H + c];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(dgh_s[r * G + j], w, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) dh_s[r * LH + l * H + c] = acc[r];
        } else if (l > 0) {
          const int k = c - H;
          const float* w_iT = a.w_ih_stT + (size_t)(l - 1) * G * H;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
          for (int j = 0; j < G; ++j) {
            const float w = w_iT[(size_t)j * H + k];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(dgi_s[r * G + j], w, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) dfa_s[r * H + k] = acc[r];
        } else {
          const int d = c - H;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] = dxn_s[r * D + d];
          for (int j = 0; j < G; ++j) {
            const float w = a.w_xT[(size_t)j * D + d];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(dgi_s[r * G + j], w, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) dx_s[r * D + d] = acc[r];
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < ROWS * D; i += nt) {
    const int b = b0 + i / D;
    if (b < a.B) a.d_x0[(size_t)b * D + i % D] = dx_s[i];
  }
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

extern "C" int sde_sampler_bwd(
    const float* gc, const float* eps, const float* x_in, const float* h_all, const float* raw,
    const float* d_paths, const float* d_means, const float* d_cholv,
    const float* w_x, const float* w_hh0, const float* b_hh0,
    const float* w_ih_st, const float* w_hh_st, const float* b_ih_st, const float* b_hh_st,
    const float* w_xT, const float* w_hh0T, const float* w_ih_stT, const float* w_hh_stT,
    const float* w_outT, const int* tril_rows, const int* tril_cols,
    float* d_gc, float* d_eps, float* d_x0, float* d_gh, float* d_gi, float* d_out,
    int B, int T, int D, int H, int L, int n_tril,
    float dt, float sqrt_dt, float diag_min, void* stream) {
  using namespace sde_sampler;
  BwdArgs a{gc, eps, x_in, h_all, raw, d_paths, d_means, d_cholv,
            w_x, w_hh0, b_hh0, w_ih_st, w_hh_st, b_ih_st, b_hh_st,
            w_xT, w_hh0T, w_ih_stT, w_hh_stT, w_outT, tril_rows, tril_cols,
            d_gc, d_eps, d_x0, d_gh, d_gi, d_out,
            B, T, D, H, L, n_tril, dt, sqrt_dt, diag_min};
  const size_t LH = (size_t)L * H, G = 3 * (size_t)H, NO = (size_t)D + n_tril;
  const size_t smem = sizeof(float) * ROWS *
                      (3 * LH + 2 * L * G + 2 * G + 2 * (size_t)H + NO + 3 * (size_t)D);
  cudaError_t err = allow_smem(bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + ROWS - 1) / ROWS);
  bwd_kernel<<<grid, threads_for(3 * H), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
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
