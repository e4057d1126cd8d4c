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
// What bounds it on an H100: the time loop is serial, and each step is a few
// [ROWS, H] x [H, 3H] matvecs whose weights (3H*H*4 bytes each, 48 KB at H=64)
// are re-read every step, plus a block barrier between dependent phases. At
// the main path's B=128 it is latency-bound: 32 blocks on 132 SMs, each
// walking 100 dependent steps.
//
// Design: one block per ROWS batch rows runs the whole time loop (the TPU grid's
// sequential time axis becomes a loop inside the block; blocks are independent
// rows, so no cross-block order is needed). One thread per gate column keeps
// ROWS fp32 accumulators, reads its weight column coalesced through L1/L2, and
// reads h as a shared-memory broadcast. All arithmetic is plain fp32 FMA (no
// tensor cores, no TF32) so the kernel agrees with the fp32 reference.
// The ragged last tile computes on zero rows and stores nothing for them.

#include "sde_sampler.cuh"

namespace sde_sampler {

struct FwdArgs {
  const float* x0;       // [B, D]
  const float* gc;       // [T, B, 3H]
  const float* eps;      // [T, B, D]
  const float* w_x;      // [D, 3H]
  const float* w_hh0;    // [H, 3H]
  const float* b_hh0;    // [3H]
  const float* w_ih_st;  // [L-1, H, 3H]
  const float* w_hh_st;  // [L-1, H, 3H]
  const float* b_ih_st;  // [L-1, 3H]
  const float* b_hh_st;  // [L-1, 3H]
  const float* w_out;    // [H, D + n_tril]
  const float* b_out;    // [D + n_tril]
  const int* tril_rows;  // [n_tril]
  const int* tril_cols;  // [n_tril]
  float* paths;          // [T, B, D]
  float* raw;            // [T, B, D + n_tril]
  float* h_all;          // [T, B, L*H] or nullptr
  int B, T, D, H, L, n_tril;
  float dt, sqrt_dt, diag_min;
};

__global__ void fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, G = 3 * a.H, L = a.L, D = a.D, LH = a.L * a.H;
  const int NO = a.D + a.n_tril;
  float* h_s = smem;              // [ROWS][LH]  h of every layer
  float* x_s = h_s + ROWS * LH;   // [ROWS][D]   x_t
  float* gi_s = x_s + ROWS * D;   // [ROWS][G]   input gates of the current layer
  float* gh_s = gi_s + ROWS * G;  // [ROWS][G]   hidden gates of the current layer
  float* out_s = gh_s + ROWS * G; // [ROWS][NO]  mu | raw tril

  const int b0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < ROWS * LH; i += nt) h_s[i] = 0.0f;
  for (int i = tid; i < ROWS * D; i += nt) {
    const int b = b0 + i / D;
    x_s[i] = b < a.B ? a.x0[(size_t)b * D + i % D] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    for (int l = 0; l < L; ++l) {
      const float* w_in = l == 0 ? a.w_x : a.w_ih_st + (size_t)(l - 1) * H * G;
      const float* in_s = l == 0 ? x_s : h_s + (l - 1) * H;  // layer below, new h
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
          for (int r = 0; r < ROWS; ++r) ah[r] = fmaf(h_s[r * LH + l * H + k], w, ah[r]);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          gi_s[r * G + j] = ai[r];
          gh_s[r * G + j] = ah[r];
        }
      }
      __syncthreads();
      for (int i = tid; i < ROWS * H; i += nt) {
        const int r = i / H, k = i % H;
        const float* gi = gi_s + r * G;
        const float* gh = gh_s + r * G;
        const float rg = sigmoidf_(gi[k] + gh[k]);
        const float zg = sigmoidf_(gi[H + k] + gh[H + k]);
        const float ng = tanhf(gi[2 * H + k] + rg * gh[2 * H + k]);
        float* hp = h_s + r * LH + l * H + k;
        *hp = (1.0f - zg) * ng + zg * (*hp);
      }
      __syncthreads();
    }

    const float* h_top = h_s + (L - 1) * H;
    for (int i = tid; i < ROWS * NO; i += nt) {
      const int r = i / NO, o = i % NO;
      float acc = a.b_out[o];
      for (int k = 0; k < H; ++k) acc = fmaf(h_top[r * LH + k], a.w_out[(size_t)k * NO + o], acc);
      out_s[i] = acc;
    }
    __syncthreads();

    for (int i = tid; i < ROWS * D; i += nt) {
      const int r = i / D, d = i % D, b = b0 + r;
      float l_eps = 0.0f;
      if (b < a.B) {
        const float* eps_t = a.eps + ((size_t)t * a.B + b) * D;
        for (int k = 0; k < a.n_tril; ++k) {
          if (a.tril_rows[k] != d) continue;
          float v = out_s[r * NO + D + k];
          if (a.tril_cols[k] == d) v = fmaxf(v, a.diag_min);
          l_eps = fmaf(v, eps_t[a.tril_cols[k]], l_eps);
        }
      }
      const float x_next = x_s[i] + out_s[r * NO + d] * a.dt + l_eps * a.sqrt_dt;
      x_s[i] = x_next;
      if (b < a.B) a.paths[((size_t)t * a.B + b) * D + d] = x_next;
    }
    for (int i = tid; i < ROWS * NO; i += nt) {
      const int b = b0 + i / NO;
      if (b < a.B) a.raw[((size_t)t * a.B + b) * NO + i % NO] = out_s[i];
    }
    if (a.h_all != nullptr) {
      for (int i = tid; i < ROWS * LH; i += nt) {
        const int b = b0 + i / LH;
        if (b < a.B) a.h_all[((size_t)t * a.B + b) * LH + i % LH] = h_s[i];
      }
    }
    __syncthreads();
  }
}

}  // namespace sde_sampler

extern "C" int sde_sampler_fwd(
    const float* x0, const float* gc, const float* eps,
    const float* w_x, const float* w_hh0, const float* b_hh0,
    const float* w_ih_st, const float* w_hh_st, const float* b_ih_st, const float* b_hh_st,
    const float* w_out, const float* b_out, const int* tril_rows, const int* tril_cols,
    float* paths, float* raw, float* h_all,
    int B, int T, int D, int H, int L, int n_tril,
    float dt, float sqrt_dt, float diag_min, void* stream) {
  using namespace sde_sampler;
  FwdArgs a{x0, gc, eps, w_x, w_hh0, b_hh0, w_ih_st, w_hh_st, b_ih_st, b_hh_st,
            w_out, b_out, tril_rows, tril_cols, paths, raw, h_all,
            B, T, D, H, L, n_tril, dt, sqrt_dt, diag_min};
  const size_t smem = sizeof(float) * ROWS * ((size_t)L * H + D + 6 * H + D + n_tril);
  cudaError_t err = allow_smem(fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + ROWS - 1) / ROWS);
  fwd_kernel<<<grid, threads_for(3 * H), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
