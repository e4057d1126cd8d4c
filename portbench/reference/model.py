"""The plain reference of the model: the observation encoder (a SiT over the
time grid), the GRU transition head rolled step by step, and the Gaussian
posterior over theta.

Plain PyTorch in float32, written from the model's equations for this
benchmark: no kernel, no graph, no fused op, no import of the program. The
parameters are one flat dict ``{path: tensor}`` whose paths are the
program's leaf paths (``encoder/sit/blocks/0/attn/qkv_proj/w``), weights
stored ``[in, out]`` (``y = x @ W + b``).

Per SiT block (adaLN-Zero): ``x + gate * f((1 + scale) * LN(x) + shift)``
for the attention and the SwiGLU branch, the six modulations from
``SiLU(cond) @ W``. Attention: fused QKV, per-head RMSNorm on q and k, RoPE
in the real/imaginary-halves layout, softmax attention over the whole grid,
a sigmoid gate of the head's width, value mixing ``lam v + (1 - lam) v0``
with block 0's values from block 1 on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from portbench.reference.precision import Precision

TRUNC_STD = 0.02
ROPE_THETA = 10000.0
DIAG_MIN = 1e-2
QK_NORM_EPS = 1e-6
NORM_EPS = 1e-5


@dataclass(frozen=True)
class Shapes:
    """The sizes of one configuration."""

    obs_dim: int
    state_dim: int
    param_dim: int
    hidden: int
    cond: int
    heads: int
    depth: int
    mlp_hidden: int
    head_hidden: int
    head_layers: int
    n_grid: int

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def n_tril(self) -> int:
        return self.state_dim * (self.state_dim + 1) // 2

    @property
    def n_out(self) -> int:
        return self.state_dim + self.n_tril


# ------------------------------------------------------------------ leaves


def leaf_specs(s: Shapes) -> list[tuple[str, tuple[int, ...], str, float]]:
    """Every parameter as ``(path, shape, kind, arg)``: ``uniform`` in
    ``[-arg, arg)``, ``normal`` and ``trunc`` (truncated at two standard
    deviations) with standard deviation ``arg``, ``const`` equal to ``arg``,
    ``chol_bias`` (the head's output bias: 1 on the Cholesky diagonal).

    The program's init scheme, except that the projections it initializes
    to zero (the adaLN modulations, the attention gates, the head's output)
    are drawn like the other projections: a state past the first steps, in
    which every leaf has a gradient at step 1. From the zero init the head's
    output cuts the encoder off from the loss for the first step, and its
    gradients stay near rounding for the next two."""
    out: list[tuple[str, tuple[int, ...], str, float]] = []

    def lin(path: str, n_in: int, n_out: int, kind: str, arg: float, bias: str = "zero") -> None:
        out.append((f"{path}/w", (n_in, n_out), kind, arg))
        if bias == "zero":
            out.append((f"{path}/b", (n_out,), "const", 0.0))
        else:
            out.append((f"{path}/b", (n_out,), kind, arg))

    h, c = s.hidden, s.cond
    out.append(("encoder/bridge_token", (h,), "normal", 1.0))
    lin("encoder/obs_proj", s.obs_dim, h, "uniform", s.obs_dim ** -0.5, bias="same")
    for i, n_in in enumerate((s.param_dim, c, c)):
        lin(f"encoder/sde_param_proj/{i}", n_in, c, "uniform", n_in ** -0.5, bias="same")
    lin("encoder/sit/input_proj", h, h, "trunc", TRUNC_STD)
    lin("encoder/sit/output_proj", h, h, "trunc", TRUNC_STD)
    for i in range(s.depth):
        b = f"encoder/sit/blocks/{i}"
        lin(f"{b}/cond/net", c, 6 * h, "trunc", TRUNC_STD)
        lin(f"{b}/attn/qkv_proj", h, 3 * h, "trunc", TRUNC_STD)
        lin(f"{b}/attn/out_proj", h, h, "trunc", TRUNC_STD)
        lin(f"{b}/attn/gate_proj", h, s.head_dim, "trunc", TRUNC_STD)
        if i > 0:
            out.append((f"{b}/attn/v_residual_lambda", (), "const", 0.5))
        lin(f"{b}/mlp/input_proj", h, 2 * s.mlp_hidden, "trunc", TRUNC_STD)
        lin(f"{b}/mlp/output_proj", s.mlp_hidden, h, "trunc", TRUNC_STD)
    hh = s.head_hidden
    for layer in range(s.head_layers):
        n_in = s.state_dim + h + s.param_dim if layer == 0 else hh
        g = f"head/gru/{layer}"
        out.append((f"{g}/w_ih", (n_in, 3 * hh), "uniform", hh ** -0.5))
        out.append((f"{g}/w_hh", (hh, 3 * hh), "uniform", hh ** -0.5))
        out.append((f"{g}/b_ih", (3 * hh,), "uniform", hh ** -0.5))
        out.append((f"{g}/b_hh", (3 * hh,), "uniform", hh ** -0.5))
    out.append(("head/out_proj/w", (hh, s.n_out), "trunc", TRUNC_STD))
    out.append(("head/out_proj/b", (s.n_out,), "chol_bias", 1.0))
    return out


def theta_specs(param_dim: int, init_std: float) -> list[tuple[str, tuple[int, ...], str, float]]:
    """The full-covariance theta posterior: mean 0, log std ``log(init_std)``,
    strictly lower coupling 0."""
    return [
        ("theta/log_std", (param_dim,), "const", math.log(init_std)),
        ("theta/mean", (param_dim,), "const", 0.0),
        ("theta/tril", (param_dim, param_dim), "const", 0.0),
    ]


def chol_bias(state_dim: int, device: torch.device | str) -> Tensor:
    """The head's output bias at init: ``mu`` 0, the Cholesky diagonal 1."""
    b = torch.zeros(state_dim + state_dim * (state_dim + 1) // 2, device=device)
    for k in range(state_dim):
        b[state_dim + k * (k + 3) // 2] = 1.0
    return b


# ----------------------------------------------------------------- encoder


def linear(p: dict, path: str, x: Tensor, prec: Precision | None = None) -> Tensor:
    w = p[f"{path}/w"]
    if prec is not None:
        x, w = prec.q(x), prec.q(w)
    y = x @ w
    b = p.get(f"{path}/b")
    return y if b is None else y + b


def sinusoidal(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rope_tables(head_dim: int, n: int, device: torch.device | str) -> tuple[Tensor, Tensor]:
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32)
    inv_freq = ROPE_THETA ** (-idx / head_dim)
    angles = torch.outer(torch.arange(n, dtype=torch.float32), inv_freq)
    return torch.cos(angles).to(device), torch.sin(angles).to(device)


def rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Rotate ``x [B, S, heads, D]`` by position; first half real, second
    half imaginary."""
    f = cos.shape[-1]
    re, im = x[..., :f], x[..., f:2 * f]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([re * c - im * s, re * s + im * c, x[..., 2 * f:]], dim=-1)


def rms_norm(x: Tensor) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + QK_NORM_EPS)


def layer_norm(x: Tensor) -> Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + NORM_EPS)


def attention(p: dict, b: str, s: Shapes, x: Tensor, rot: tuple[Tensor, Tensor], v0: Tensor | None,
              prec: Precision) -> tuple[Tensor, Tensor]:
    bsz, n, _ = x.shape
    q, k, v = torch.chunk(linear(p, f"{b}/qkv_proj", x, prec), 3, dim=-1)
    q, k, v = (t.reshape(bsz, n, s.heads, s.head_dim) for t in (q, k, v))
    q = rope(rms_norm(q), *rot)
    k = rope(rms_norm(k), *rot)
    if v0 is not None:
        lam = p[f"{b}/v_residual_lambda"]
        v = lam * v + (1.0 - lam) * v0
    logits = torch.einsum("bshd,bthd->bhst", prec.q(q), prec.q(k)) / math.sqrt(s.head_dim)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", prec.q(probs), prec.q(v))
    gate = torch.sigmoid(linear(p, f"{b}/gate_proj", x, prec))
    out = out * gate[:, :, None, :]
    return linear(p, f"{b}/out_proj", out.reshape(bsz, n, s.hidden), prec), v


def encoder(p: dict, s: Shapes, obs_slots: Tensor, grid_times: Tensor, obs_values: Tensor,
            theta: Tensor, prec: Precision) -> Tensor:
    """``theta [B, P] -> context [B, n_grid, hidden]``."""
    bsz = theta.shape[0]
    h = p["encoder/bridge_token"].expand(s.n_grid, s.hidden)
    h = h.index_put((obs_slots,), linear(p, "encoder/obs_proj", obs_values))
    h = h + sinusoidal(grid_times, s.hidden)
    h = h[None].expand(bsz, s.n_grid, s.hidden)
    c = F.silu(linear(p, "encoder/sde_param_proj/0", theta))
    c = F.silu(linear(p, "encoder/sde_param_proj/1", c))
    c = linear(p, "encoder/sde_param_proj/2", c)

    rot = rope_tables(s.head_dim, s.n_grid, theta.device)
    x = linear(p, "encoder/sit/input_proj", h, prec)
    v0 = None
    for i in range(s.depth):
        b = f"encoder/sit/blocks/{i}"
        mods = torch.chunk(linear(p, f"{b}/cond/net", F.silu(c), prec), 6, dim=-1)
        scale_a, shift_a, gate_a, scale_m, shift_m, gate_m = (m[:, None, :] for m in mods)
        y, v = attention(p, f"{b}/attn", s, (1 + scale_a) * layer_norm(x) + shift_a, rot, v0, prec)
        x = x + gate_a * y
        if v0 is None:
            v0 = v
        z = (1 + scale_m) * layer_norm(x) + shift_m
        left, right = torch.chunk(linear(p, f"{b}/mlp/input_proj", z, prec), 2, dim=-1)
        x = x + gate_m * linear(p, f"{b}/mlp/output_proj", F.silu(left) * right, prec)
    return linear(p, "encoder/sit/output_proj", x, prec)


# -------------------------------------------------------------------- head


class _LowerBound(torch.autograd.Function):
    """``max(x, bound)``; the gradient passes where ``x >= bound`` or where
    it is negative (it may push a clamped value back up)."""

    @staticmethod
    def forward(ctx, x: Tensor, bound: float) -> Tensor:
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g: Tensor):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g, torch.zeros_like(g)), None


def gru_cell(gi: Tensor, h: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tensor:
    """GRU cell, gate order r, z, n (PyTorch's)."""
    gh = h @ w_hh + b_hh
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def sample_paths(p: dict, s: Shapes, z0: Tensor, context: Tensor, theta: Tensor, eps: Tensor,
                 dt: float) -> tuple[Tensor, Tensor, Tensor]:
    """Roll ``z_{t+1} = z_t + mu_t dt + L_t eps_t sqrt(dt)`` over ``context
    [B, T, hidden]`` and time-major ``eps [T, B, D]``; returns the paths
    ``[B, T + 1, D]``, the means ``[B, T, D]`` and the Cholesky factors
    ``[B, T, D, D]`` (diagonal clamped at ``DIAG_MIN``)."""
    d, hh = s.state_dim, s.head_hidden
    rows, cols = np.tril_indices(d)
    rows_t = torch.as_tensor(rows, device=z0.device)
    cols_t = torch.as_tensor(cols, device=z0.device)
    diag = rows_t == cols_t
    w_ih0 = p["head/gru/0/w_ih"]
    # the input product of the context and theta rows, for all steps at once
    gc = (torch.einsum("btc,ch->tbh", context, w_ih0[d:d + s.hidden])
          + (theta @ w_ih0[d + s.hidden:])[None] + p["head/gru/0/b_ih"])
    w_x = w_ih0[:d]
    bsz = z0.shape[0]
    x = z0
    hs = [z0.new_zeros((bsz, hh)) for _ in range(s.head_layers)]
    paths, means, chols = [z0], [], []
    for t in range(gc.shape[0]):
        h_in = gru_cell(gc[t] + x @ w_x, hs[0], p["head/gru/0/w_hh"], p["head/gru/0/b_hh"])
        new = [h_in]
        for layer in range(1, s.head_layers):
            g = f"head/gru/{layer}"
            h_in = gru_cell(h_in @ p[f"{g}/w_ih"] + p[f"{g}/b_ih"], hs[layer], p[f"{g}/w_hh"], p[f"{g}/b_hh"])
            new.append(h_in)
        hs = new
        out = h_in @ p["head/out_proj/w"] + p["head/out_proj/b"]
        mu, raw = out[:, :d], out[:, d:]
        vals = torch.where(diag, _LowerBound.apply(raw, DIAG_MIN), raw)
        chol = _tril(vals, rows_t, cols_t, d)
        x = x + mu * dt + torch.einsum("bij,bj->bi", chol, eps[t]) * math.sqrt(dt)
        paths.append(x)
        means.append(mu)
        chols.append(chol)
    return torch.stack(paths, 1), torch.stack(means, 1), torch.stack(chols, 1)


def _tril(vals: Tensor, rows: Tensor, cols: Tensor, d: int) -> Tensor:
    """``[B, n_tril] -> [B, D, D]`` lower triangular."""
    out = vals.new_zeros((vals.shape[0], d * d))
    return out.index_add(1, rows * d + cols, vals).reshape(-1, d, d)


# ------------------------------------------------------------------- theta


def theta_scale_tril(p: dict) -> Tensor:
    return torch.diag(torch.exp(p["theta/log_std"])) + torch.tril(p["theta/tril"], diagonal=-1)


def theta_rsample(p: dict, positive: Tensor, eps: Tensor) -> Tensor:
    z = p["theta/mean"] + eps @ theta_scale_tril(p).T
    return torch.where(positive, torch.exp(z), z)


def theta_log_prob(p: dict, positive: Tensor, theta: Tensor) -> Tensor:
    """Density of theta: a Gaussian in the unconstrained space, with the
    exp transform's Jacobian on the positive dims."""
    safe = torch.where(positive, torch.clamp(theta, min=1e-38), torch.ones_like(theta))
    log_theta = torch.log(safe)
    z = torch.where(positive, log_theta, theta)
    L = theta_scale_tril(p)
    y = torch.linalg.solve_triangular(L.expand(z.shape[:-1] + L.shape), (z - p["theta/mean"])[..., None],
                                      upper=False)[..., 0]
    mvn = (-0.5 * torch.sum(y * y, -1) - torch.sum(p["theta/log_std"])
           - 0.5 * theta.shape[-1] * math.log(2 * math.pi))
    return mvn - torch.sum(torch.where(positive, log_theta, torch.zeros_like(log_theta)), -1)
