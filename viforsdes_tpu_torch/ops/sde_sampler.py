"""Fused GRU path sampler: hand-written CUDA kernels, their plain PyTorch
versions, and the autograd bridge.

PyTorch counterpart of ``viforsdes_tpu/ops/pallas/sde_sampler.py``. The
sampler rolls the head's L-layer GRU and the Euler recurrence
``x_{t+1} = x_t + mu_t*dt + (L_t eps_t)*sqrt(dt)`` over time-major streams:

- ``sampler_forward`` (K1, ``csrc/sde_sampler_fwd.cu``): paths, raw outputs,
  clamped Cholesky values and (for training) h of every layer;
- ``sampler_backward`` (K2, ``csrc/sde_sampler_bwd.cu``): a parallel pass that
  recomputes every step's gates from the stashed h, then reverse-time BPTT
  that applies the ``lower_bound`` rule to the summed Cholesky cotangent, and
  the weight gradients; returns d_gates_const, d_eps, dx0 and every weight
  gradient;
- ``FusedPathSampler``: the ``torch.autograd.Function`` joining the two.

Each wrapper launches its kernel for CUDA tensors and takes its plain version
(``_forward_plain`` / ``_backward_plain``) only for CPU tensors; any other
device raises. The plain forward is also the head's ``sampler="scan"`` path:
differentiated by autograd, it is the reference both kernels are held to.
The context/theta input projections are hoisted out by the head
(``gates_const``), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from viforsdes_tpu_torch.ops.bounds import lower_bound
from viforsdes_tpu_torch.ops.kernel_build import SDE_SAMPLER, LaunchCounter, raise_on


class SamplerSpec(NamedTuple):
    """Static configuration of one sampler instantiation."""

    state_dim: int
    hidden_dim: int
    num_layers: int
    time_step: float
    diag_min: float
    # "full" = lower-triangular Cholesky (d(d+1)/2 values); "diag" = diagonal
    # scale (d values). Both run the same index-generic code: diag mode is the
    # row/col tables of the diagonal with every entry clamped.
    cholesky: str = "full"

    @property
    def n_tril(self) -> int:
        if self.cholesky == "diag":
            return self.state_dim
        return self.state_dim * (self.state_dim + 1) // 2

    @property
    def n_out(self) -> int:
        return self.state_dim + self.n_tril


def tril_indices(d: int, cholesky: str = "full") -> tuple[np.ndarray, np.ndarray]:
    """Row and column of each Cholesky value (diag mode: the diagonal)."""
    if cholesky == "diag":
        return np.arange(d), np.arange(d)
    return np.tril_indices(d)


class SamplerWeights(NamedTuple):
    """The head's parameters packed as the kernels take them (fp32)."""

    w_x: Tensor      # [D, 3H]  state rows of layer-0 w_ih
    w_hh0: Tensor    # [H, 3H]
    b_hh0: Tensor    # [3H]
    w_ih_st: Tensor  # [L-1, H, 3H]  deeper layers, stacked
    w_hh_st: Tensor  # [L-1, H, 3H]
    b_ih_st: Tensor  # [L-1, 3H]
    b_hh_st: Tensor  # [L-1, 3H]
    w_out: Tensor    # [H, D + n_tril]
    b_out: Tensor    # [D + n_tril]


def prep_weights(spec: SamplerSpec, head_params: dict) -> SamplerWeights:
    """Pack the head's param tree into kernel operands (differentiable: the
    slices and stacks route gradients back to the tree's leaves)."""
    d, h = spec.state_dim, spec.hidden_dim
    p0 = head_params["gru"][0]
    deeper = head_params["gru"][1:]

    def stack(name: str, shape: tuple[int, ...]) -> Tensor:
        if deeper:
            return torch.stack([p[name].float() for p in deeper])
        return p0["w_hh"].new_zeros((0, *shape), dtype=torch.float32)

    return SamplerWeights(
        w_x=p0["w_ih"].float()[:d],
        w_hh0=p0["w_hh"].float(),
        b_hh0=p0["b_hh"].float(),
        w_ih_st=stack("w_ih", (h, 3 * h)),
        w_hh_st=stack("w_hh", (h, 3 * h)),
        b_ih_st=stack("b_ih", (3 * h,)),
        b_hh_st=stack("b_hh", (3 * h,)),
        w_out=head_params["out_proj"]["w"].float(),
        b_out=head_params["out_proj"]["b"].float(),
    )


class SamplerOutputs(NamedTuple):
    """Time-major sampler streams."""

    paths: Tensor      # [T, B, D]  x_{t+1}
    raw: Tensor        # [T, B, D + n_tril]  mu | unclamped tril
    chol_vals: Tensor  # [T, B, n_tril]  tril with the diagonal clamped
    h_all: Tensor | None  # [T, B, L*H] when saved for the backward


class SamplerGrads(NamedTuple):
    d_gc: Tensor
    d_eps: Tensor
    d_x0: Tensor  # through the recurrence only; the caller adds d_paths[:, 0]
    weights: SamplerWeights


@functools.lru_cache(maxsize=None)
def index_tables(
    d: int, cholesky: str, device: torch.device, dtype: torch.dtype
) -> tuple[Tensor, Tensor]:
    """Tril row/col tables, built once per device: a host-to-device copy on
    every step would stall the host on the stream."""
    rows, cols = tril_indices(d, cholesky)
    return (
        torch.as_tensor(rows, dtype=dtype, device=device),
        torch.as_tensor(cols, dtype=dtype, device=device),
    )


def _tables(spec: SamplerSpec, device: torch.device) -> tuple[Tensor, Tensor, Tensor]:
    rows, cols = index_tables(spec.state_dim, spec.cholesky, device, torch.long)
    return rows, cols, rows == cols


def _gru_cell(gi: Tensor, h: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tensor:
    """PyTorch-semantics GRU cell, gate order r, z, n."""
    gh = h @ w_hh + b_hh
    gi_r, gi_z, gi_n = torch.chunk(gi, 3, dim=-1)
    gh_r, gh_z, gh_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(gi_r + gh_r)
    z = torch.sigmoid(gi_z + gh_z)
    n = torch.tanh(gi_n + r * gh_n)
    return (1.0 - z) * n + z * h


# ------------------------------------------------------------- plain versions


def _forward_plain(
    spec: SamplerSpec, w: SamplerWeights, x0: Tensor, gc: Tensor, eps: Tensor,
    *, save_h: bool,
) -> SamplerOutputs:
    """Plain PyTorch forward, differentiable by autograd (the ``"scan"``
    sampler and K1's reference). One clamp per step feeds both the path and
    the returned Cholesky values, so autograd sums their cotangents before the
    ``lower_bound`` rule, as K2 does."""
    d, h, n_layers = spec.state_dim, spec.hidden_dim, spec.num_layers
    dt = spec.time_step
    sqrt_dt = spec.time_step**0.5
    rows, cols, diag = _tables(spec, x0.device)
    batch = x0.shape[0]
    x = x0
    hs = [x0.new_zeros((batch, h)) for _ in range(n_layers)]
    paths, raws, vals_all, h_all = [], [], [], []
    for t in range(gc.shape[0]):
        h_in = _gru_cell(gc[t] + x @ w.w_x, hs[0], w.w_hh0, w.b_hh0)
        new_hs = [h_in]
        for li in range(n_layers - 1):
            gi = h_in @ w.w_ih_st[li] + w.b_ih_st[li]
            h_in = _gru_cell(gi, hs[li + 1], w.w_hh_st[li], w.b_hh_st[li])
            new_hs.append(h_in)
        hs = new_hs
        out = h_in @ w.w_out + w.b_out
        mu, raw_tril = out[:, :d], out[:, d:]
        vals = torch.where(diag, lower_bound(raw_tril, spec.diag_min), raw_tril)
        l_eps = x.new_zeros((batch, d)).index_add(1, rows, vals * eps[t][:, cols])
        x = x + mu * dt + l_eps * sqrt_dt
        paths.append(x)
        raws.append(out)
        vals_all.append(vals)
        if save_h:
            h_all.append(torch.cat(hs, dim=-1))
    return SamplerOutputs(
        paths=torch.stack(paths),
        raw=torch.stack(raws),
        chol_vals=torch.stack(vals_all),
        h_all=torch.stack(h_all) if save_h else None,
    )


def _backward_plain(
    spec: SamplerSpec,
    w: SamplerWeights,
    x0: Tensor,
    gc: Tensor,
    eps: Tensor,
    fwd: SamplerOutputs,
    d_paths: Tensor,
    d_means: Tensor,
    d_cholv: Tensor,
) -> SamplerGrads:
    """Plain PyTorch version of K2, step for step: the same recompute, the same
    per-step gate cotangents, and the weight gradients as sums over all rows
    of ``A^T . dgates``. All streams time-major ``[T, B, .]``."""
    d, h, n_layers = spec.state_dim, spec.hidden_dim, spec.num_layers
    dt = spec.time_step
    sqrt_dt = spec.time_step**0.5
    rows, cols, diag = _tables(spec, x0.device)
    n_steps, batch = gc.shape[:2]
    h_all = fwd.h_all
    x_in = torch.cat([x0[None], fwd.paths[:-1]])
    h_prev_all = torch.cat([torch.zeros_like(h_all[:1]), h_all[:-1]])
    w_hh = [w.w_hh0, *w.w_hh_st]
    b_hh = [w.b_hh0, *w.b_hh_st]

    dx = x0.new_zeros((batch, d))
    dh = [x0.new_zeros((batch, h)) for _ in range(n_layers)]
    d_gc = torch.empty_like(gc)
    d_eps = torch.empty_like(eps)
    d_out_all = torch.empty_like(fwd.raw)
    d_gh_all = [torch.empty_like(gc) for _ in range(n_layers)]
    d_gi_all = [d_gc] + [torch.empty_like(gc) for _ in range(n_layers - 1)]

    for t in range(n_steps - 1, -1, -1):
        hp, hc = h_prev_all[t], h_all[t]
        acts = []
        for layer in range(n_layers):
            if layer == 0:
                gi = gc[t] + x_in[t] @ w.w_x
            else:
                gi = hc[:, (layer - 1) * h : layer * h] @ w.w_ih_st[layer - 1] + w.b_ih_st[layer - 1]
            gh = hp[:, layer * h : (layer + 1) * h] @ w_hh[layer] + b_hh[layer]
            r = torch.sigmoid(gi[:, :h] + gh[:, :h])
            z = torch.sigmoid(gi[:, h : 2 * h] + gh[:, h : 2 * h])
            n_hh = gh[:, 2 * h :]
            n = torch.tanh(gi[:, 2 * h :] + r * n_hh)
            acts.append((r, z, n, n_hh))

        d_x_next = d_paths[t] + dx
        raw_tril = fwd.raw[t][:, d:]
        dx_r = d_x_next[:, rows]
        d_total = d_cholv[t] + dx_r * eps[t][:, cols] * sqrt_dt
        vals = torch.where(diag, torch.clamp(raw_tril, min=spec.diag_min), raw_tril)
        d_eps[t] = x0.new_zeros((batch, d)).index_add(1, cols, dx_r * vals) * sqrt_dt
        passes = (raw_tril >= spec.diag_min) | (d_total < 0)
        d_tril = torch.where(diag & ~passes, torch.zeros_like(d_total), d_total)
        d_out = torch.cat([d_means[t] + d_x_next * dt, d_tril], dim=-1)
        d_out_all[t] = d_out
        d_from_above = d_out @ w.w_out.T

        for layer in range(n_layers - 1, -1, -1):
            r, z, n, n_hh = acts[layer]
            h_prev = hp[:, layer * h : (layer + 1) * h]
            d_h = dh[layer] + d_from_above
            da_n = d_h * (1.0 - z) * (1.0 - n * n)
            da_r = da_n * n_hh * r * (1.0 - r)
            da_z = d_h * (h_prev - n) * z * (1.0 - z)
            d_gi = torch.cat([da_r, da_z, da_n], dim=-1)
            d_gh = torch.cat([da_r, da_z, da_n * r], dim=-1)
            dh[layer] = d_h * z + d_gh @ w_hh[layer].T
            d_gh_all[layer][t] = d_gh
            d_gi_all[layer][t] = d_gi
            if layer == 0:
                dx = d_x_next + d_gi @ w.w_x.T
            else:
                d_from_above = d_gi @ w.w_ih_st[layer - 1].T

    def wgrad(a: Tensor, g: Tensor) -> Tensor:
        return torch.einsum("tbk,tbj->kj", a, g)

    def stack(items: list[Tensor], like: Tensor) -> Tensor:
        return torch.stack(items) if items else torch.zeros_like(like)

    layer_cols = [slice(l * h, (l + 1) * h) for l in range(n_layers)]
    grads = SamplerWeights(
        w_x=wgrad(x_in, d_gc),
        w_hh0=wgrad(h_prev_all[..., layer_cols[0]], d_gh_all[0]),
        b_hh0=d_gh_all[0].sum((0, 1)),
        w_ih_st=stack([wgrad(h_all[..., layer_cols[l - 1]], d_gi_all[l]) for l in range(1, n_layers)], w.w_ih_st),
        w_hh_st=stack([wgrad(h_prev_all[..., layer_cols[l]], d_gh_all[l]) for l in range(1, n_layers)], w.w_hh_st),
        b_ih_st=stack([d_gi_all[l].sum((0, 1)) for l in range(1, n_layers)], w.b_ih_st),
        b_hh_st=stack([d_gh_all[l].sum((0, 1)) for l in range(1, n_layers)], w.b_hh_st),
        w_out=wgrad(h_all[..., layer_cols[-1]], d_out_all),
        b_out=d_out_all.sum((0, 1)),
    )
    return SamplerGrads(d_gc=d_gc, d_eps=d_eps, d_x0=dx, weights=grads)


# ----------------------------------------------------------- CUDA kernels


FORWARD_LAUNCHES = LaunchCounter()
BACKWARD_LAUNCHES = LaunchCounter()


def _check(name: str, t: Tensor, shape: tuple[int, ...], device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_weights(spec: SamplerSpec, w: SamplerWeights, device: torch.device) -> None:
    d, h, l1 = spec.state_dim, spec.hidden_dim, spec.num_layers - 1
    g = 3 * h
    shapes = SamplerWeights(
        w_x=(d, g), w_hh0=(h, g), b_hh0=(g,), w_ih_st=(l1, h, g), w_hh_st=(l1, h, g),
        b_ih_st=(l1, g), b_hh_st=(l1, g), w_out=(h, spec.n_out), b_out=(spec.n_out,),
    )
    for name, t, shape in zip(SamplerWeights._fields, w, shapes):
        _check(name, t, shape, device)


def _ptr(t: Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _int_tables(spec: SamplerSpec, device: torch.device) -> tuple[Tensor, Tensor]:
    return index_tables(spec.state_dim, spec.cholesky, device, torch.int32)


def _scalars(spec: SamplerSpec) -> tuple[float, float, float]:
    return float(spec.time_step), math.sqrt(spec.time_step), float(spec.diag_min)


class ForwardPlan(NamedTuple):
    """How K1 runs for a shape (``sde_sampler_fwd_plan``): whether the packed
    weights are staged in shared memory (else read from device memory: the
    streaming path), threads and shared memory per block for either, and the
    packed layout (floats, ``W_out^T`` row stride, units per packed row)."""

    staged: bool
    threads: int
    smem_staged: int
    smem_streaming: int
    packed_floats: int
    ld_out: int
    units: int

    @property
    def smem_bytes(self) -> int:
        return self.smem_staged if self.staged else self.smem_streaming


@functools.lru_cache(maxsize=None)
def forward_plan(spec: SamplerSpec, rows: int, device_index: int) -> ForwardPlan:
    """K1's launch for ``spec`` at ``rows`` batch rows per block, chosen by
    shape alone: staged when the packed weights fit the card's opt-in shared
    memory. K1 takes at most 31 warps of 8 hidden units (H <= 248)."""
    out = (ctypes.c_longlong * 7)()
    with torch.cuda.device(device_index):
        err = SDE_SAMPLER.get().sde_sampler_fwd_plan(
            spec.state_dim, spec.hidden_dim, spec.num_layers, spec.n_tril, rows, ctypes.addressof(out))
    raise_on(err, f"sde_sampler_fwd_plan (H={spec.hidden_dim}; K1 takes H <= 248)")
    staged, threads, smem_staged, smem_streaming, floats, ld_out, units = out
    return ForwardPlan(bool(staged), threads, smem_staged, smem_streaming, floats, ld_out, units)


def pack_forward_weights(spec: SamplerSpec, w: SamplerWeights, plan: ForwardPlan) -> Tensor:
    """K1's weights, unit-major: per layer a ``[in + H + 2, units, 4]`` block
    whose row i holds, for hidden unit k, the float4 ``{r, z, n, 0}`` of
    columns ``k, H+k, 2H+k`` of ``W_in`` (rows ``0..in-1``; ``W_x`` for layer
    0), then of ``W_hh`` (H rows), then of the input bias (zero for layer 0)
    and the hidden bias; zero past unit H. Then ``W_out^T`` with row stride
    ``plan.ld_out`` and ``b_out``, padded to whole float4s."""
    h, n_out = spec.hidden_dim, spec.n_out
    blocks = []
    for layer in range(spec.num_layers):
        w_in = w.w_x if layer == 0 else w.w_ih_st[layer - 1]
        w_hh = w.w_hh0 if layer == 0 else w.w_hh_st[layer - 1]
        b_in = torch.zeros_like(w.b_hh0) if layer == 0 else w.b_ih_st[layer - 1]
        b_hh = w.b_hh0 if layer == 0 else w.b_hh_st[layer - 1]
        rows = torch.cat([w_in, w_hh, b_in[None], b_hh[None]])  # [in + H + 2, 3H]
        block = rows.new_zeros((rows.shape[0], plan.units, 4))
        block[:, :h, :3] = rows.reshape(-1, 3, h).transpose(1, 2)
        blocks.append(block.reshape(-1))
    out = w.w_out.new_zeros((n_out, plan.ld_out))
    out[:, :h] = w.w_out.t()
    blocks.append(out.reshape(-1))
    blocks.append(torch.cat([w.b_out, w.b_out.new_zeros(-n_out % 4)]))
    packed = torch.cat(blocks)
    if packed.numel() != plan.packed_floats:
        raise ValueError(f"packed K1 weights: {packed.numel()} floats, the plan wants {plan.packed_floats}")
    return packed


def _forward_cuda(
    spec: SamplerSpec, w: SamplerWeights, x0: Tensor, gc: Tensor, eps: Tensor,
    *, save_h: bool, rows: int | None = None, staged: bool | None = None,
) -> SamplerOutputs:
    """K1 at ``rows`` batch rows per block (default: ``rows_per_block``) on
    the plan by shape; ``staged`` asks for the staged or the streaming plan
    (staged raises where the weights do not fit)."""
    n_steps, batch = gc.shape[:2]
    d, h, n_layers = spec.state_dim, spec.hidden_dim, spec.num_layers
    dev = x0.device
    _check("x0", x0, (batch, d), dev)
    _check("gates_const", gc, (n_steps, batch, 3 * h), dev)
    _check("eps", eps, (n_steps, batch, d), dev)
    _check_weights(spec, w, dev)
    if rows is None:
        rows = rows_per_block(batch, torch.cuda.get_device_properties(dev).multi_processor_count)
    if rows not in ROWS_PER_BLOCK:
        raise ValueError(f"rows per K1 block must be one of {ROWS_PER_BLOCK}, got {rows}")
    plan = forward_plan(spec, rows, dev.index)
    packed = pack_forward_weights(spec, w, plan)
    rows_t, cols_t = _int_tables(spec, dev)
    paths = torch.empty((n_steps, batch, d), dtype=torch.float32, device=dev)
    raw = torch.empty((n_steps, batch, spec.n_out), dtype=torch.float32, device=dev)
    h_all = (
        torch.empty((n_steps, batch, n_layers * h), dtype=torch.float32, device=dev)
        if save_h else None
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = SDE_SAMPLER.get().sde_sampler_fwd(
        x0.data_ptr(), gc.data_ptr(), eps.data_ptr(), packed.data_ptr(),
        rows_t.data_ptr(), cols_t.data_ptr(), paths.data_ptr(), raw.data_ptr(), _ptr(h_all),
        batch, n_steps, d, h, n_layers, spec.n_tril, rows, -1 if staged is None else int(staged),
        *_scalars(spec), stream,
    )
    raise_on(err, "sde_sampler_fwd")
    FORWARD_LAUNCHES.count += 1
    _, _, diag = _tables(spec, dev)
    raw_tril = raw[..., d:]
    chol_vals = torch.where(diag, torch.clamp(raw_tril, min=spec.diag_min), raw_tril)
    return SamplerOutputs(paths=paths, raw=raw, chol_vals=chol_vals, h_all=h_all)


def _weight_grad(
    lib: ctypes.CDLL, a: Tensor, a_cols: slice, a_shift: int, g: Tensor,
    dw: Tensor, db: Tensor | None, stream: int,
) -> None:
    """``dw = A^T . G`` (and ``db = 1^T . G``) over all T*B rows, where A row r
    is ``a``'s row ``r - a_shift`` restricted to ``a_cols`` (0 before it)."""
    lda = a.shape[-1]
    ka = a_cols.stop - a_cols.start
    nj = g.shape[-1]
    n_rows = g.numel() // nj
    n_split = max(1, min(64, n_rows // 512))
    partial = torch.empty(
        (n_split, ka + (db is not None), nj), dtype=torch.float32, device=g.device
    )
    a_ptr = a.data_ptr() + a_cols.start * a.element_size()
    err = lib.sde_sampler_weight_grad(
        a_ptr, lda, a_shift, ka, g.data_ptr(), nj, nj, n_rows,
        partial.data_ptr(), n_split, dw.data_ptr(), _ptr(db), stream,
    )
    raise_on(err, "sde_sampler_weight_grad")


class BackwardPlan(NamedTuple):
    """How K2's BPTT kernel runs for a shape (``sde_sampler_bwd_plan``): the
    row strides of the packed matrices, whether they are staged in shared
    memory (else read from device memory: the streaming path), threads and
    shared memory per block."""

    ld0: int
    ld1: int
    staged: bool
    threads: int
    smem_bytes: int
    packed_floats: int


@functools.lru_cache(maxsize=None)
def backward_plan(spec: SamplerSpec, rows: int, device_index: int) -> BackwardPlan:
    """K2's launch for ``spec`` at ``rows`` batch rows per block, chosen by
    shape alone: staged when the packed matrices fit the card's opt-in shared
    memory."""
    out = (ctypes.c_longlong * 6)()
    with torch.cuda.device(device_index):
        err = SDE_SAMPLER.get().sde_sampler_bwd_plan(
            spec.state_dim, spec.hidden_dim, spec.num_layers, spec.n_tril, rows, ctypes.addressof(out))
    raise_on(err, "sde_sampler_bwd_plan")
    ld0, ld1, staged, threads, smem, floats = out
    return BackwardPlan(ld0, ld1, bool(staged), threads, smem, floats)


# Batch rows per K1 and K2 block that the kernels are built for. One serial
# step takes longer the more rows a block carries (PERF.md, section 6), so the
# fewest rows win as long as the blocks fit in one wave.
ROWS_PER_BLOCK = (1, 2, 4)


def rows_per_block(batch: int, n_sms: int) -> int:
    """Rows per K1 and per K2 block: the fewest that keep the blocks within
    one wave on ``n_sms`` multiprocessors."""
    for rows in ROWS_PER_BLOCK:
        if -(-batch // rows) <= n_sms:
            return rows
    return ROWS_PER_BLOCK[-1]


def pack_bptt_weights(spec: SamplerSpec, w: SamplerWeights, plan: BackwardPlan) -> Tensor:
    """The matrices of K2's transposed matvecs, one ``[3H, ld]`` block per
    layer with ``W_hh^T`` in columns ``0..H-1`` and the matrix that sends the
    cotangent down beside it (``W_x^T`` for layer 0, ``W_ih^T`` above), zero
    in the padding columns, flattened in layer order."""
    h = spec.hidden_dim
    blocks = []
    for layer in range(spec.num_layers):
        ld = plan.ld0 if layer == 0 else plan.ld1
        w_hh = w.w_hh0 if layer == 0 else w.w_hh_st[layer - 1]
        w_down = w.w_x if layer == 0 else w.w_ih_st[layer - 1]
        block = w_hh.new_zeros((3 * h, ld))
        block[:, :h] = w_hh.t()
        block[:, h : h + w_down.shape[0]] = w_down.t()
        blocks.append(block.reshape(-1))
    packed = torch.cat(blocks)
    if packed.numel() != plan.packed_floats:
        raise ValueError(f"packed K2 weights: {packed.numel()} floats, the plan wants {plan.packed_floats}")
    return packed


def _backward_cuda(
    spec: SamplerSpec,
    w: SamplerWeights,
    x0: Tensor,
    gc: Tensor,
    eps: Tensor,
    fwd: SamplerOutputs,
    d_paths: Tensor,
    d_means: Tensor,
    d_cholv: Tensor,
    rows: int | None = None,
) -> SamplerGrads:
    n_steps, batch = gc.shape[:2]
    d, h, n_layers = spec.state_dim, spec.hidden_dim, spec.num_layers
    g3 = 3 * h
    dev = x0.device
    _check("x0", x0, (batch, d), dev)
    _check("gates_const", gc, (n_steps, batch, g3), dev)
    _check("eps", eps, (n_steps, batch, d), dev)
    _check("paths", fwd.paths, (n_steps, batch, d), dev)
    _check("raw", fwd.raw, (n_steps, batch, spec.n_out), dev)
    if fwd.h_all is None:
        raise ValueError("sampler backward needs the forward's h stash (save_h=True)")
    _check("h_all", fwd.h_all, (n_steps, batch, n_layers * h), dev)
    _check("d_paths", d_paths, (n_steps, batch, d), dev)
    _check("d_means", d_means, (n_steps, batch, d), dev)
    _check("d_cholv", d_cholv, (n_steps, batch, spec.n_tril), dev)
    _check_weights(spec, w, dev)
    if rows is None:
        rows = rows_per_block(batch, torch.cuda.get_device_properties(dev).multi_processor_count)
    if rows not in ROWS_PER_BLOCK:
        raise ValueError(f"rows per K2 block must be one of {ROWS_PER_BLOCK}, got {rows}")
    lib = SDE_SAMPLER.get()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows_t, cols_t = _int_tables(spec, dev)
    plan = backward_plan(spec, rows, dev.index)

    x_in = torch.cat([x0[None], fwd.paths[:-1]])
    w_bptt = pack_bptt_weights(spec, w, plan)
    w_outT = w.w_out.t().contiguous()

    def empty(*shape: int) -> Tensor:
        return torch.empty(shape, dtype=torch.float32, device=dev)

    acts = empty(n_layers, n_steps, batch, 4 * h)  # r, z, n, n_hh of every step and layer
    d_gc = empty(n_steps, batch, g3)
    d_eps = empty(n_steps, batch, d)
    d_x0 = empty(batch, d)
    d_gh = empty(n_layers, n_steps, batch, g3)
    d_gi = empty(n_layers - 1, n_steps, batch, g3)
    d_out = empty(n_steps, batch, spec.n_out)
    err = lib.sde_sampler_bwd(
        gc.data_ptr(), eps.data_ptr(), x_in.data_ptr(), fwd.h_all.data_ptr(),
        fwd.raw.data_ptr(), d_paths.data_ptr(), d_means.data_ptr(), d_cholv.data_ptr(),
        *(_ptr(t) for t in w[:7]), w_bptt.data_ptr(), w_outT.data_ptr(),
        rows_t.data_ptr(), cols_t.data_ptr(), acts.data_ptr(),
        d_gc.data_ptr(), d_eps.data_ptr(), d_x0.data_ptr(), d_gh.data_ptr(),
        _ptr(d_gi), d_out.data_ptr(),
        batch, n_steps, d, h, n_layers, spec.n_tril, rows, *_scalars(spec), stream,
    )
    raise_on(err, "sde_sampler_bwd")

    grads = SamplerWeights(*(torch.empty_like(t) for t in w))
    h_all = fwd.h_all
    col = [slice(l * h, (l + 1) * h) for l in range(n_layers)]
    # h_{t-1} is h_all shifted down by one step (B rows), zero at t = 0
    _weight_grad(lib, x_in, slice(0, d), 0, d_gc, grads.w_x, None, stream)
    _weight_grad(lib, h_all, col[0], batch, d_gh[0], grads.w_hh0, grads.b_hh0, stream)
    for l in range(1, n_layers):
        _weight_grad(lib, h_all, col[l - 1], 0, d_gi[l - 1], grads.w_ih_st[l - 1], grads.b_ih_st[l - 1], stream)
        _weight_grad(lib, h_all, col[l], batch, d_gh[l], grads.w_hh_st[l - 1], grads.b_hh_st[l - 1], stream)
    _weight_grad(lib, h_all, col[-1], 0, d_out, grads.w_out, grads.b_out, stream)
    BACKWARD_LAUNCHES.count += 1
    return SamplerGrads(d_gc=d_gc, d_eps=d_eps, d_x0=d_x0, weights=grads)


# ----------------------------------------------------------------- wrappers


def sampler_forward(
    spec: SamplerSpec, w: SamplerWeights, x0: Tensor, gc: Tensor, eps: Tensor,
    *, save_h: bool,
) -> SamplerOutputs:
    """K1: launches the CUDA kernel for CUDA tensors; the plain version serves
    CPU tensors only."""
    if x0.is_cuda:
        return _forward_cuda(spec, w, x0, gc, eps, save_h=save_h)
    if x0.device.type == "cpu":
        return _forward_plain(spec, w, x0, gc, eps, save_h=save_h)
    raise NotImplementedError(f"sampler_forward: no kernel for device {x0.device}")


def sampler_backward(spec: SamplerSpec, w: SamplerWeights, x0: Tensor, gc: Tensor,
                     eps: Tensor, fwd: SamplerOutputs, d_paths: Tensor,
                     d_means: Tensor, d_cholv: Tensor) -> SamplerGrads:
    """K2: launches the CUDA kernels for CUDA tensors; the plain version serves
    CPU tensors only."""
    args = (spec, w, x0, gc, eps, fwd, d_paths, d_means, d_cholv)
    if x0.is_cuda:
        return _backward_cuda(*args)
    if x0.device.type == "cpu":
        return _backward_plain(*args)
    raise NotImplementedError(f"sampler_backward: no kernel for device {x0.device}")


def public_outputs(
    spec: SamplerSpec, x0: Tensor, out: SamplerOutputs
) -> tuple[Tensor, Tensor, Tensor]:
    """Time-major streams -> ``(paths [B,T+1,D], means [B,T,D], chol_vals
    [B,T,n_tril])``, the layout the ELBO consumes."""
    paths = torch.cat([x0[:, None], out.paths.transpose(0, 1)], dim=1)
    means = out.raw[..., : spec.state_dim].transpose(0, 1)
    return paths, means, out.chol_vals.transpose(0, 1)


class FusedPathSampler(torch.autograd.Function):
    """Autograd bridge over K1/K2: ``(spec, x0 [B,D], gates_const [T,B,3H],
    eps [T,B,D], *weights) -> (paths [B,T+1,D], means [B,T,D], chol_vals
    [B,T,n_tril])``. The h stash is saved only when a gradient is needed."""

    @staticmethod
    def forward(ctx, spec: SamplerSpec, save_h: bool, x0, gc, eps, *weights):
        w = SamplerWeights(*weights)
        out = sampler_forward(spec, w, x0, gc, eps, save_h=save_h)
        if save_h:
            ctx.spec = spec
            ctx.save_for_backward(x0, gc, eps, *out, *weights)
        return public_outputs(spec, x0, out)

    @staticmethod
    def backward(ctx, d_paths_full, d_means, d_cholv):
        if not hasattr(ctx, "spec"):
            raise RuntimeError("FusedPathSampler was run without its h stash")
        spec = ctx.spec
        x0, gc, eps, *saved = ctx.saved_tensors
        fwd = SamplerOutputs(*saved[:4])
        w = SamplerWeights(*saved[4:])

        def tmaj(g: Tensor | None, width: int) -> Tensor:
            if g is None:
                return gc.new_zeros((gc.shape[0], gc.shape[1], width))
            return g.transpose(0, 1).float().contiguous()

        d_paths = tmaj(None if d_paths_full is None else d_paths_full[:, 1:], spec.state_dim)
        grads = sampler_backward(
            spec, w, x0, gc, eps, fwd,
            d_paths, tmaj(d_means, spec.state_dim), tmaj(d_cholv, spec.n_tril),
        )
        d_x0 = grads.d_x0
        if d_paths_full is not None:
            d_x0 = d_x0 + d_paths_full[:, 0]
        return (None, None, d_x0, grads.d_gc, grads.d_eps, *grads.weights)


def sample_paths(
    spec: SamplerSpec, w: SamplerWeights, x0: Tensor, gc: Tensor, eps: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """The fused sampler (K1 forward, K2 backward) on contiguous fp32 streams."""
    tensors = (x0, gc, eps, *w)
    save_h = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    tensors = tuple(t.float().contiguous() for t in tensors)
    return FusedPathSampler.apply(spec, save_h, *tensors)


def sample_paths_scan(
    spec: SamplerSpec, w: SamplerWeights, x0: Tensor, gc: Tensor, eps: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """The plain loop, differentiated by autograd (JAX's ``lax.scan`` path)."""
    out = _forward_plain(spec, w, x0, gc, eps, save_h=False)
    return public_outputs(spec, x0, out)


__all__ = [
    "SamplerSpec",
    "SamplerWeights",
    "SamplerOutputs",
    "SamplerGrads",
    "FusedPathSampler",
    "FORWARD_LAUNCHES",
    "BACKWARD_LAUNCHES",
    "BackwardPlan",
    "ForwardPlan",
    "ROWS_PER_BLOCK",
    "backward_plan",
    "forward_plan",
    "pack_bptt_weights",
    "pack_forward_weights",
    "rows_per_block",
    "prep_weights",
    "sampler_forward",
    "sampler_backward",
    "sample_paths",
    "sample_paths_scan",
    "index_tables",
    "tril_indices",
]
