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

Each kernel runs one of three paths, picked by shape before the launch
(``make_fwd_plan`` / ``make_bwd_plan`` in the sources, mirrored here by
``plan_forward`` / ``plan_backward``): one block per 1, 2 or 4 rows with
the weights staged in its shared memory; a thread-block cluster of 2, 4, 8
or 16 CTAs that holds the weights between them, each CTA a column slice of
every product (``cluster_layout``), where they fit no block; or one block
per rows streaming them from device memory, where they fit no cluster of
up to 16.

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


# The kernels' paths (``FwdPath`` / ``BwdPath`` in csrc/sde_sampler_fwd.cu and _bwd.cu)
PATH_STREAMING, PATH_STAGED, PATH_CLUSTER = 0, 1, 2
PATH_NAMES = {PATH_STREAMING: "streaming", PATH_STAGED: "staged", PATH_CLUSTER: "cluster"}


class ForwardPlan(NamedTuple):
    """How K1 runs for a shape (``make_fwd_plan`` in csrc/sde_sampler_fwd.cu,
    mirrored by ``plan_forward``): the path (the one-block kernel with its
    weights staged in shared memory or streamed from device memory, or the
    cluster kernel), CTAs a cluster, batch rows a block or cluster, threads,
    shared memory, the packed floats (per CTA on the cluster path), and the
    layout numbers: the one-block kernel's units per packed row and
    ``W_out^T`` row stride; the cluster kernel's units, output columns,
    state entries per CTA and rows a warp."""

    path: int
    cluster: int
    rows: int
    threads: int
    smem_bytes: int
    packed_floats: int
    units: int
    ld_out: int
    uc: int
    nop: int
    slots: int
    rw: int

    @property
    def staged(self) -> bool:
        """Whether the weights sit in shared memory (staged or cluster)."""
        return self.path != PATH_STREAMING


# The widest head K1 takes: 32 warps of 8 hidden units fill a block's 1024
# threads (``kMaxHidden`` in csrc/sde_sampler_fwd.cu).
K1_MAX_HIDDEN = 256
MAX_CLUSTER = 16     # ``kMaxCluster`` in csrc/sde_sampler.cuh (above 8: a non-portable size)
CLUSTER_SIZES = (2, 4, 8, 16)  # the clusters both planners try
UNITS_PER_WARP = 8   # hidden units a warp owns (``kUnitsPerWarp``)
CLUSTER_THREADS = 768  # threads of a cluster kernel's CTA, at most (``kClusterThreads``)
EXCHANGE_SMEM = 16     # a cluster kernel's static shared memory: two mbarriers (``kExchangeSmem``)
BPTT_TASKS_PER_WARP = 2  # the cluster BPTT's product tasks a warp, at most, where they outnumber the warps

# Batch rows per block of the one-block kernels (K1 and K2's BPTT).
ROWS_PER_BLOCK = (1, 2, 4)


def _round_rows(rows: int) -> int:
    """1, 2, 4 or the next multiple of 4 (``round_rows``)."""
    if rows <= 2:
        return max(1, rows)
    return 4 if rows <= 4 else -(-rows // 4) * 4


def cluster_waves(batch: int, per_wave: int, max_rows: int) -> int:
    """Waves of clusters a batch takes at ``max_rows`` rows a cluster when
    the card runs ``per_wave`` clusters at once."""
    return -(-batch // (max(1, per_wave) * max_rows))


def cluster_rows(batch: int, per_wave: int, max_rows: int) -> int:
    """Rows a cluster (a lone block on the one-block paths) carries, by the
    row rule of both kernels (``cluster_rows`` in csrc/sde_sampler.cuh): the
    fewest that keep the clusters within one wave of the ``per_wave``
    clusters the card runs at once (``n_sms`` lone blocks; for clusters, at
    most ``n_sms // cluster`` and fewer where a GPC's multiprocessors do not
    divide into clusters: ``cluster_slots``); where ``max_rows`` (what
    shared memory and the threads allow) cannot, the fewest waves, the rows
    spread evenly over them. One serial step takes longer the more rows it
    carries, so the fewest win as long as the clusters fit in a wave. Rows
    are 1, 2, 4 or a multiple of 4."""
    per_wave = max(1, per_wave)
    waves = cluster_waves(batch, per_wave, max_rows)
    return min(max_rows, _round_rows(-(-batch // (per_wave * waves))))


def entry_owner(i: int, cluster: int) -> int:
    """The CTA of a cluster that owns state entry ``i``: dealt out in a snake
    so that the tril rows, ``i + 1`` values long, balance."""
    q = i % (2 * cluster)
    return q if q < cluster else 2 * cluster - 1 - q


def _cta_entries(d: int, cholesky: str, cluster: int, c: int) -> tuple[list[int], list[int], list[int]]:
    """CTA ``c``'s state entries, the local column of each one's mu, and the
    global output column of each of its local columns (entry by entry: mu_i,
    then row i of the tril values)."""
    entries, segs, cols = [], [], []
    for i in range(d):
        if entry_owner(i, cluster) != c:
            continue
        entries.append(i)
        segs.append(len(cols))
        cols.append(i)
        if cholesky == "diag":
            cols.append(d + i)
        else:
            cols.extend(d + i * (i + 1) // 2 + j for j in range(i + 1))
    return entries, segs, cols


def cluster_columns(d: int, cholesky: str, cluster: int) -> tuple[int, int]:
    """``(nop, slots)``: the widest CTA's output columns padded to 32, and
    the most state entries a CTA owns (``cluster_columns``)."""
    per = [_cta_entries(d, cholesky, cluster, c) for c in range(cluster)]
    nop = -(-max(len(p[2]) for p in per) // 32) * 32
    return nop, max(len(p[0]) for p in per)


def layout_width(d: int, nop: int, slots: int) -> int:
    """Ints of one CTA's row of ``cluster_layout``."""
    return 3 * nop + 2 * slots + d


def cluster_layout(d: int, cholesky: str, cluster: int) -> np.ndarray:
    """``[cluster, 3 * nop + 2 * slots + d]`` int32, per CTA: the global
    output column of each local column (-1 past its own); its state entries
    (-1 past its own); the local column of each one's mu; for each local
    column the slot of its entry and its tril column j (-1 for mu and past
    its own); and, the same in every row, the slot of each state entry in
    the CTA that owns it."""
    nop, slots = cluster_columns(d, cholesky, cluster)
    out = np.full((cluster, layout_width(d, nop, slots)), -1, dtype=np.int32)
    jslot = np.zeros(d, dtype=np.int32)
    for c in range(cluster):
        entries, segs, cols = _cta_entries(d, cholesky, cluster, c)
        out[c, : len(cols)] = cols
        out[c, nop : nop + len(entries)] = entries
        out[c, nop + slots : nop + slots + len(segs)] = segs
        mslot = out[c, nop + 2 * slots : 2 * nop + 2 * slots]
        mj = out[c, 2 * nop + 2 * slots : 3 * nop + 2 * slots]
        for s, (e, seg) in enumerate(zip(entries, segs)):
            jslot[e] = s
            n_vals = 1 if cholesky == "diag" else e + 1
            mslot[seg : seg + 1 + n_vals] = s
            mj[seg + 1 : seg + 1 + n_vals] = [e] if cholesky == "diag" else range(e + 1)
    out[:, 3 * nop + 2 * slots :] = jslot
    return out


@functools.lru_cache(maxsize=None)
def _layout_tensor(d: int, cholesky: str, cluster: int, device: torch.device) -> Tensor:
    return torch.as_tensor(cluster_layout(d, cholesky, cluster), device=device)


def _packed_ld(n: int) -> int:
    """``packed_ld`` in csrc/sde_sampler.cuh."""
    return 8 if n <= 8 else ((n - 8 + 31) // 32) * 32 + 8


def _block_forward_smem(spec: SamplerSpec, rows: int) -> tuple[int, int, int, int, int]:
    """The one-block kernel's ``(threads, smem staged, smem streaming,
    packed floats, W_out^T row stride)`` at ``rows`` (``make_block_fwd_plan``)."""
    d, h, n_layers, nt, no = spec.state_dim, spec.hidden_dim, spec.num_layers, spec.n_tril, spec.n_out
    groups = -(-h // UNITS_PER_WARP)
    warps = groups + 1 if 32 * (groups + 1) <= 1024 else groups
    units = -(-h // 8) * 8
    ld_out = _packed_ld(units)
    layer_rows = (d + h + 2) + (n_layers - 1) * (2 * h + 2)
    out4 = (no * ld_out + no + 3) // 4
    floats = 4 * (units * layer_rows + out4)
    work = (2 * rows * (3 * h + d) + 2 * rows * n_layers * h + rows * d + rows * no
            + groups * rows * no + rows * nt)
    streaming = 4 * work + 4 * 2 * nt
    return 32 * warps, streaming + 4 * floats, streaming, floats, ld_out


def _cluster_forward_smem(spec: SamplerSpec, cluster: int, rows: int) -> tuple[int, int, int, int, int]:
    """The cluster kernel's ``(smem, packed floats per CTA, uc, nop, slots)``
    for a cluster of ``cluster`` CTAs at ``rows`` (``cluster_fwd_smem``)."""
    d, h, n_layers = spec.state_dim, spec.hidden_dim, spec.num_layers
    uc = h // cluster
    nop, slots = cluster_columns(d, spec.cholesky, cluster)
    sr = -(-(3 * uc + d) // 4) * 4
    floats = 4 * uc * ((d + h + 2) + (n_layers - 1) * (2 * h + 2)) + h * nop + nop
    smem = 4 * (floats + 2 * rows * sr + 2 * rows * n_layers * h + rows * d + rows * nop) + 4 * (3 * nop + 2 * slots)
    return smem, floats, uc, nop, slots


def _cluster_forward_rw(uc: int, rows: int) -> int:
    """Rows a warp carries at ``rows`` rows a cluster: the fewest (1, 2 or
    4) whose warps fit ``CLUSTER_THREADS`` (``cluster_fwd_rw``)."""
    rw = 1
    while rw < min(rows, 4):
        if 32 * (uc // UNITS_PER_WARP) * (rows // rw) <= CLUSTER_THREADS:
            return rw
        rw *= 2
    return min(rows, 4)


def _cluster_forward_max_rows(spec: SamplerSpec, cluster: int, optin: int) -> int:
    """The most rows a cluster carries: its shared memory within ``optin``
    and at most ``CLUSTER_THREADS`` threads at 4 rows a warp
    (``cluster_fwd_max_rows``)."""
    best, r = 0, 1
    groups = spec.hidden_dim // cluster // UNITS_PER_WARP
    while r <= 256:
        rw = min(r, 4)
        if (32 * groups * (r // rw) > CLUSTER_THREADS
                or _cluster_forward_smem(spec, cluster, r)[0] + EXCHANGE_SMEM > optin):
            break
        best = r
        r = 2 * r if r < 4 else r + 4
    return best


def _cluster_ok(h: int, cluster: int) -> bool:
    return 1 <= cluster <= MAX_CLUSTER and h % (UNITS_PER_WARP * cluster) == 0


def _per_wave(cluster: int, n_sms: int, slots: dict[int, int] | None) -> int:
    held = (slots or {}).get(cluster, n_sms // cluster)
    return min(n_sms // cluster, held)


def plan_forward(spec: SamplerSpec, batch: int, n_sms: int, optin: int,
                 slots: dict[int, int] | None = None) -> ForwardPlan:
    """K1's plan for a shape, computed here as ``make_fwd_plan`` computes it
    on the card (``n_sms`` multiprocessors, ``optin`` bytes of shared memory
    a block, ``slots``: the clusters of each size the card runs at once at
    their most rows, ``cluster_slots``; ``n_sms // cluster`` where not
    given): the one-block kernel with its weights staged where they fit a
    block at the rows ``cluster_rows`` gives (at most 4); else the cluster
    kernel at the cluster of ``CLUSTER_SIZES`` whose slices fit in the
    fewest waves of clusters (the smaller on a tie), at the rows
    ``cluster_rows`` gives a cluster; else the one-block kernel streaming
    its weights."""
    h = spec.hidden_dim
    if h > K1_MAX_HIDDEN:
        raise ValueError(f"K1 takes hidden_dim <= {K1_MAX_HIDDEN}, got {h}")
    block_rows = cluster_rows(batch, n_sms, ROWS_PER_BLOCK[-1])
    threads, staged, streaming, floats, ld_out = _block_forward_smem(spec, block_rows)
    units = -(-h // 8) * 8
    if staged <= optin:
        return ForwardPlan(PATH_STAGED, 1, block_rows, threads, staged, floats, units, ld_out, 0, 0, 0, 0)
    fits = {c: _cluster_forward_max_rows(spec, c, optin) for c in CLUSTER_SIZES if _cluster_ok(h, c)}
    fits = {c: m for c, m in fits.items() if m > 0}
    if not fits:
        if streaming > optin:
            raise ValueError(f"K1 has no plan for {spec} at {batch} rows: even its streaming plan's "
                             f"{streaming} bytes of shared memory exceed {optin}")
        return ForwardPlan(PATH_STREAMING, 1, block_rows, threads, streaming, floats, units, ld_out, 0, 0, 0, 0)
    cluster = min(fits, key=lambda c: (cluster_waves(batch, _per_wave(c, n_sms, slots), fits[c]), c))
    rows = cluster_rows(batch, _per_wave(cluster, n_sms, slots), fits[cluster])
    smem, cfloats, uc, nop, n_slots = _cluster_forward_smem(spec, cluster, rows)
    rw = _cluster_forward_rw(uc, rows)
    return ForwardPlan(PATH_CLUSTER, cluster, rows, 32 * (uc // UNITS_PER_WARP) * (rows // rw), smem,
                       cfloats, units, ld_out, uc, nop, n_slots, rw)


@functools.lru_cache(maxsize=None)
def forward_plan(spec: SamplerSpec, batch: int, device_index: int, path: int = -1, cluster: int = 0,
                 rows: int = 0) -> ForwardPlan:
    """K1's launch for ``spec`` at ``batch`` rows, as the card's
    ``make_fwd_plan`` computes it: by shape alone, or on the ``path``,
    ``cluster`` and ``rows`` asked for (-1, 0, 0: by shape)."""
    out = (ctypes.c_longlong * 12)()
    with torch.cuda.device(device_index):
        err = SDE_SAMPLER.get().sde_sampler_fwd_plan(
            spec.state_dim, spec.hidden_dim, spec.num_layers, spec.n_tril, int(spec.cholesky == "diag"),
            batch, path, cluster, rows, ctypes.addressof(out))
    raise_on(err, f"sde_sampler_fwd_plan (H={spec.hidden_dim}, path {path}, cluster {cluster}, rows {rows}; "
                  f"K1 takes H <= {K1_MAX_HIDDEN})")
    return ForwardPlan(*(int(v) for v in out))


def _pack_block_forward(spec: SamplerSpec, w: SamplerWeights, plan: ForwardPlan) -> Tensor:
    h, n_out = spec.hidden_dim, spec.n_out
    blocks = []
    for layer in range(spec.num_layers):
        rows = _gate_rows(w, layer)  # [in + H + 2, 3H]
        block = rows.new_zeros((rows.shape[0], plan.units, 4))
        block[:, :h, :3] = rows.reshape(-1, 3, h).transpose(1, 2)
        blocks.append(block.reshape(-1))
    out = w.w_out.new_zeros((n_out, plan.ld_out))
    out[:, :h] = w.w_out.t()
    blocks.append(out.reshape(-1))
    blocks.append(torch.cat([w.b_out, w.b_out.new_zeros(-n_out % 4)]))
    return torch.cat(blocks)


def _gate_rows(w: SamplerWeights, layer: int) -> Tensor:
    """Layer ``layer``'s gate matrices as rows: ``W_in`` (``W_x`` for layer
    0), ``W_hh``, the input bias (zero for layer 0) and the hidden bias,
    ``[in + H + 2, 3H]``."""
    w_in = w.w_x if layer == 0 else w.w_ih_st[layer - 1]
    w_hh = w.w_hh0 if layer == 0 else w.w_hh_st[layer - 1]
    b_in = torch.zeros_like(w.b_hh0) if layer == 0 else w.b_ih_st[layer - 1]
    b_hh = w.b_hh0 if layer == 0 else w.b_hh_st[layer - 1]
    return torch.cat([w_in, w_hh, b_in[None], b_hh[None]])


def _pack_cluster_forward(spec: SamplerSpec, w: SamplerWeights, plan: ForwardPlan) -> Tensor:
    h, uc = spec.hidden_dim, plan.uc
    layout = cluster_layout(spec.state_dim, spec.cholesky, plan.cluster)
    w_out = torch.cat([w.w_out, w.w_out.new_zeros((h, 1))], dim=1)  # column -1: zeros
    b_out = torch.cat([w.b_out, w.b_out.new_zeros(1)])
    ctas = []
    for c in range(plan.cluster):
        blocks = []
        for layer in range(spec.num_layers):
            rows = _gate_rows(w, layer).reshape(-1, 3, h)[:, :, c * uc : (c + 1) * uc]
            block = rows.new_zeros((rows.shape[0], uc, 4))
            block[:, :, :3] = rows.transpose(1, 2)
            blocks.append(block.reshape(-1))
        cols = torch.as_tensor(layout[c, : plan.nop], dtype=torch.long, device=w.w_out.device)
        blocks.append(w_out[:, cols].reshape(-1))  # [H, nop], column -1 reads the zeros
        blocks.append(b_out[cols])
        ctas.append(torch.cat(blocks))
    return torch.cat(ctas)


def _source(w: SamplerWeights) -> Tensor:
    """Every weight flattened, in ``SamplerWeights`` order, after one zero."""
    return torch.cat([w.w_x.new_zeros(1), *(t.reshape(-1) for t in w)])


@functools.lru_cache(maxsize=None)
def _pack_index(pack, spec: SamplerSpec, plan, device: torch.device) -> Tensor:
    """Where each float of ``pack(spec, w, plan)`` comes from in
    ``_source(w)`` (0: a zero): the packing, which only moves values, run
    once on weights that hold their own positions. A packing on the card is
    then one gather, with no host work and no copy from the host."""
    d, h, l1, g = spec.state_dim, spec.hidden_dim, spec.num_layers - 1, 3 * spec.hidden_dim
    shapes = [(d, g), (h, g), (g,), (l1, h, g), (l1, h, g), (l1, g), (l1, g), (h, spec.n_out), (spec.n_out,)]
    ids, start = [], 1
    for shape in shapes:
        n = int(np.prod(shape))
        ids.append(torch.arange(start, start + n, dtype=torch.float64).reshape(shape))
        start += n
    return pack(spec, SamplerWeights(*ids), plan).long().to(device)


def pack_forward_weights(spec: SamplerSpec, w: SamplerWeights, plan: ForwardPlan) -> Tensor:
    """K1's weights as ``plan`` lays them out (``_pack_forward``), by one
    cached gather."""
    return _source(w)[_pack_index(_pack_forward, spec, plan, w.w_x.device)]


def _pack_forward(spec: SamplerSpec, w: SamplerWeights, plan: ForwardPlan) -> Tensor:
    """K1's weights as ``plan`` lays them out.

    One-block paths, unit-major: per layer a ``[in + H + 2, units, 4]``
    block whose row i holds, for hidden unit k, the float4 ``{r, z, n, 0}``
    of columns ``k, H+k, 2H+k`` of ``W_in`` (rows ``0..in-1``; ``W_x`` for
    layer 0), then of ``W_hh`` (H rows), then of the input bias (zero for
    layer 0) and the hidden bias; zero past unit H. Then ``W_out^T`` with
    row stride ``plan.ld_out`` and ``b_out``, padded to whole float4s.

    Cluster path, per CTA c of the cluster in turn: the same layer blocks
    for its units ``c*uc .. (c+1)*uc - 1`` only, then ``W_out`` restricted
    to its output columns (``cluster_layout``) as ``[H, nop]``, k-major, and
    those columns of ``b_out``; zero in the padding columns."""
    if plan.path == PATH_CLUSTER:
        packed = _pack_cluster_forward(spec, w, plan)
        want = plan.cluster * plan.packed_floats
    else:
        packed = _pack_block_forward(spec, w, plan)
        want = plan.packed_floats
    if packed.numel() != want:
        raise ValueError(f"packed K1 weights: {packed.numel()} floats, the plan wants {want}")
    return packed


def _forward_cuda(
    spec: SamplerSpec, w: SamplerWeights, x0: Tensor, gc: Tensor, eps: Tensor,
    *, save_h: bool, path: int = -1, cluster: int = 0, rows: int = 0,
) -> SamplerOutputs:
    """K1 on the plan by shape, or on the ``path``, ``cluster`` and ``rows``
    asked for (``forward_plan``)."""
    n_steps, batch = gc.shape[:2]
    d, h, n_layers = spec.state_dim, spec.hidden_dim, spec.num_layers
    dev = x0.device
    _check("x0", x0, (batch, d), dev)
    _check("gates_const", gc, (n_steps, batch, 3 * h), dev)
    _check("eps", eps, (n_steps, batch, d), dev)
    _check_weights(spec, w, dev)
    plan = forward_plan(spec, batch, dev.index, path, cluster, rows)
    packed = pack_forward_weights(spec, w, plan)
    on_cluster = plan.path == PATH_CLUSTER
    layout = _layout_tensor(d, spec.cholesky, plan.cluster, dev) if on_cluster else None
    rows_t, cols_t = _int_tables(spec, dev)
    paths = torch.empty((n_steps, batch, d), dtype=torch.float32, device=dev)
    raw = torch.empty((n_steps, batch, spec.n_out), dtype=torch.float32, device=dev)
    chol_vals = torch.empty((n_steps, batch, spec.n_tril), dtype=torch.float32, device=dev) if on_cluster else None
    h_all = (
        torch.empty((n_steps, batch, n_layers * h), dtype=torch.float32, device=dev)
        if save_h else None
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = SDE_SAMPLER.get().sde_sampler_fwd(
        x0.data_ptr(), gc.data_ptr(), eps.data_ptr(), packed.data_ptr(), _ptr(layout),
        rows_t.data_ptr(), cols_t.data_ptr(), paths.data_ptr(), raw.data_ptr(), _ptr(chol_vals), _ptr(h_all),
        batch, n_steps, d, h, n_layers, spec.n_tril, int(spec.cholesky == "diag"),
        plan.path, plan.cluster, plan.rows, *_scalars(spec), stream,
    )
    raise_on(err, "sde_sampler_fwd")
    FORWARD_LAUNCHES.count += 1
    if not on_cluster:  # the cluster kernel writes them; the one-block kernel's lone output warp does not
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
    """How K2's BPTT runs for a shape (``make_bwd_plan`` in
    csrc/sde_sampler_bwd.cu, mirrored by ``plan_backward``): the path, CTAs
    a cluster, rows a block or cluster, threads, shared memory, the packed
    floats (per CTA on the cluster path), the one-block kernel's row strides
    of its packed matrices and the cluster kernel's units, output columns,
    state entries per CTA and rows a warp."""

    path: int
    cluster: int
    rows: int
    threads: int
    smem_bytes: int
    packed_floats: int
    ld0: int
    ld1: int
    uc: int
    nop: int
    slots: int
    rw: int

    @property
    def staged(self) -> bool:
        """Whether the matrices sit in shared memory (staged or cluster)."""
        return self.path != PATH_STREAMING


def _block_backward_smem(spec: SamplerSpec, rows: int) -> tuple[int, int, int, int, int, int]:
    """The one-block BPTT kernel's ``(threads, smem staged, smem streaming,
    packed floats, ld0, ld1)`` at ``rows`` (``make_plan``)."""
    d, h, n_layers, nt, no = spec.state_dim, spec.hidden_dim, spec.num_layers, spec.n_tril, spec.n_out
    g, lh = 3 * h, n_layers * h
    ld0, ld1 = _packed_ld(h + d), _packed_ld(2 * h)
    floats = g * (ld0 + (n_layers - 1) * ld1)
    stage_row = 5 * n_layers * h + 4 * d + 2 * nt
    work = 2 * rows * stage_row + rows * (lh + 2 * g + 2 * h + no + d)
    base = 4 * work + 4 * 2 * nt
    cols = h + (h if n_layers > 1 else d)
    n = 32 * -(-cols // 8)
    per_row = max(d + nt + d, h)
    if n < rows * per_row:
        n = -(-(rows * per_row) // 32) * 32
    return min(1024, max(64, n)), base + 4 * (floats + no * h), base, floats, ld0, ld1


def _cluster_backward_smem(spec: SamplerSpec, cluster: int, rows: int) -> tuple[int, int, int, int, int]:
    """The cluster BPTT kernel's ``(smem, packed floats per CTA, uc, nop,
    slots)`` (``cluster_bwd_smem``)."""
    d, h, n_layers = spec.state_dim, spec.hidden_dim, spec.num_layers
    uc = h // cluster
    nop, slots = cluster_columns(d, spec.cholesky, cluster)
    sr = -(-(5 * n_layers * uc + slots + d) // 4) * 4
    floats = 4 * uc * ((h + d) + (n_layers - 1) * 2 * h) + nop * h
    r = rows
    work = (floats + r * sr + r * n_layers * uc + 2 * r * slots + r * nop + r * uc * 4 + r * uc
            + 4 * cluster * r * uc + 2 * cluster * r * slots)
    return 4 * work + 4 * layout_width(d, nop, slots), floats, uc, nop, slots


def _cluster_backward_max_rows(spec: SamplerSpec, cluster: int, optin: int) -> int:
    """The most rows a cluster carries in K2 (``cluster_bwd_max_rows``)."""
    best, r = 0, 1
    while r <= 256 and _cluster_backward_smem(spec, cluster, r)[0] + EXCHANGE_SMEM <= optin:
        best = r
        r = 2 * r if r < 4 else r + 4
    return best


def plan_backward(spec: SamplerSpec, batch: int, n_sms: int, optin: int,
                  slots: dict[int, int] | None = None) -> BackwardPlan:
    """K2's BPTT plan, computed here as ``make_bwd_plan`` computes it on the
    card, by K1's rule (``plan_forward``): staged in one block where the
    matrices fit; else clusters of ``CLUSTER_SIZES`` in the fewest waves;
    else streaming."""
    h = spec.hidden_dim
    block_rows = cluster_rows(batch, n_sms, ROWS_PER_BLOCK[-1])
    threads, staged, streaming, floats, ld0, ld1 = _block_backward_smem(spec, block_rows)
    if staged <= optin:
        return BackwardPlan(PATH_STAGED, 1, block_rows, threads, staged, floats, ld0, ld1, 0, 0, 0, 0)
    fits = {c: _cluster_backward_max_rows(spec, c, optin) for c in CLUSTER_SIZES if _cluster_ok(h, c)}
    fits = {c: m for c, m in fits.items() if m > 0}
    if not fits:
        if streaming > optin:
            raise ValueError(f"K2 has no plan for {spec} at {batch} rows")
        return BackwardPlan(PATH_STREAMING, 1, block_rows, threads, streaming, floats, ld0, ld1, 0, 0, 0, 0)
    cluster = min(fits, key=lambda c: (cluster_waves(batch, _per_wave(c, n_sms, slots), fits[c]), c))
    rows = cluster_rows(batch, _per_wave(cluster, n_sms, slots), fits[cluster])
    smem, cfloats, uc, nop, n_slots = _cluster_backward_smem(spec, cluster, rows)
    rw, threads = _cluster_backward_launch(spec, uc, rows)
    return BackwardPlan(PATH_CLUSTER, cluster, rows, threads, smem, cfloats, ld0, ld1, uc, nop, n_slots, rw)


def _cluster_backward_threads(rows: int, uc: int) -> int:
    """``cluster_bwd_threads``: the elementwise phases' threads."""
    return min(CLUSTER_THREADS, max(128, -(-(rows * uc) // 32) * 32))


def _cluster_backward_launch(spec: SamplerSpec, uc: int, rows: int) -> tuple[int, int]:
    """``(rows a warp, threads)`` of the cluster BPTT (``cluster_bwd_launch``):
    the fewest rows a warp at which each task of a layer's products (32
    output columns of those rows) gets a warp within ``CLUSTER_THREADS``,
    and the threads that takes, at least the elementwise phases'; else 4
    rows a warp (or the rows) and warps enough for ``BPTT_TASKS_PER_WARP``
    tasks each, within ``CLUSTER_THREADS``."""
    h, d = spec.hidden_dim, spec.state_dim
    widest = max(h + d, 2 * h if spec.num_layers > 1 else 0)
    blocks = -(-widest // 32)
    threads = _cluster_backward_threads(rows, uc)
    rw = 1
    while rw <= min(rows, 4):
        if 32 * blocks * (rows // rw) <= CLUSTER_THREADS:
            return rw, max(threads, 32 * blocks * (rows // rw))
        rw *= 2
    warps = -(-blocks * (rows // min(rows, 4)) // BPTT_TASKS_PER_WARP)
    return min(rows, 4), max(threads, min(CLUSTER_THREADS, 32 * warps))


def cluster_slots(spec: SamplerSpec, device_index: int) -> dict[str, dict[int, int]]:
    """The clusters of each of ``CLUSTER_SIZES`` CTAs of each cluster kernel
    that the card runs at once at its most rows (``fwd_cluster_slots`` / ``bwd_cluster_slots``,
    from ``cudaOccupancyMaxActiveClusters``): the ``slots`` of
    ``plan_forward`` (``"fwd"``) and ``plan_backward`` (``"bwd"``)."""
    props = torch.cuda.get_device_properties(device_index)
    n_sms, optin = props.multi_processor_count, props.shared_memory_per_block_optin
    lib = SDE_SAMPLER.get()
    out: dict[str, dict[int, int]] = {"fwd": {}, "bwd": {}}
    for cluster in CLUSTER_SIZES:
        if not _cluster_ok(spec.hidden_dim, cluster):
            continue
        uc = spec.hidden_dim // cluster
        rows = _cluster_forward_max_rows(spec, cluster, optin)
        if rows:
            rw = _cluster_forward_rw(uc, rows)
            threads = 32 * (uc // UNITS_PER_WARP) * (rows // rw)
            out["fwd"][cluster] = _held(lib.sde_sampler_fwd_max_clusters, cluster, rw, threads,
                                        _cluster_forward_smem(spec, cluster, rows)[0], device_index)
        rows = _cluster_backward_max_rows(spec, cluster, optin)
        if rows:
            rw, threads = _cluster_backward_launch(spec, uc, rows)
            out["bwd"][cluster] = _held(lib.sde_sampler_bwd_max_clusters, cluster, rw, threads,
                                        _cluster_backward_smem(spec, cluster, rows)[0], device_index)
    return {k: {c: min(n, n_sms // c) for c, n in v.items()} for k, v in out.items()}


def _held(query, cluster: int, rw: int, threads: int, smem: int, device_index: int) -> int:
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        raise_on(query(cluster, rw, threads, smem, ctypes.addressof(n)), "cudaOccupancyMaxActiveClusters")
    return n.value


@functools.lru_cache(maxsize=None)
def backward_plan(spec: SamplerSpec, batch: int, device_index: int, path: int = -1, cluster: int = 0,
                  rows: int = 0) -> BackwardPlan:
    """K2's BPTT launch for ``spec`` at ``batch`` rows as the card's
    ``make_bwd_plan`` computes it: by shape alone, or on the ``path``,
    ``cluster`` and ``rows`` asked for (-1, 0, 0: by shape)."""
    out = (ctypes.c_longlong * 12)()
    with torch.cuda.device(device_index):
        err = SDE_SAMPLER.get().sde_sampler_bwd_plan(
            spec.state_dim, spec.hidden_dim, spec.num_layers, spec.n_tril, int(spec.cholesky == "diag"),
            batch, path, cluster, rows, ctypes.addressof(out))
    raise_on(err, f"sde_sampler_bwd_plan (path {path}, cluster {cluster}, rows {rows})")
    return BackwardPlan(*(int(v) for v in out))


def _pack_block_bptt(spec: SamplerSpec, w: SamplerWeights, plan: BackwardPlan) -> Tensor:
    h = spec.hidden_dim
    blocks = []
    for layer in range(spec.num_layers):
        ld = plan.ld0 if layer == 0 else plan.ld1
        w_hh, w_down = _bptt_rows(w, layer)
        block = w_hh.new_zeros((3 * h, ld))
        block[:, :h] = w_hh.t()
        block[:, h : h + w_down.shape[0]] = w_down.t()
        blocks.append(block.reshape(-1))
    return torch.cat(blocks)


def _bptt_rows(w: SamplerWeights, layer: int) -> tuple[Tensor, Tensor]:
    """Layer ``layer``'s ``W_hh`` and the matrix that sends its cotangent
    down (``W_x`` for layer 0, ``W_ih`` above)."""
    if layer == 0:
        return w.w_hh0, w.w_x
    return w.w_hh_st[layer - 1], w.w_ih_st[layer - 1]


def _pack_cluster_bptt(spec: SamplerSpec, w: SamplerWeights, plan: BackwardPlan) -> Tensor:
    h, uc = spec.hidden_dim, plan.uc
    layout = cluster_layout(spec.state_dim, spec.cholesky, plan.cluster)
    w_out = torch.cat([w.w_out, w.w_out.new_zeros((h, 1))], dim=1)  # column -1: zeros
    ctas = []
    for c in range(plan.cluster):
        blocks = []
        for layer in range(spec.num_layers):
            rows = torch.cat(_bptt_rows(w, layer))  # [H + in, 3H]
            cols = rows.reshape(-1, 3, h)[:, :, c * uc : (c + 1) * uc]  # [H + in, 3, uc]
            block = rows.new_zeros((uc, rows.shape[0], 4))
            block[:, :, :3] = cols.permute(2, 0, 1)
            blocks.append(block.reshape(-1))
        ocol = torch.as_tensor(layout[c, : plan.nop], dtype=torch.long, device=w.w_out.device)
        blocks.append(w_out[:, ocol].t().reshape(-1))  # [nop, H]
        ctas.append(torch.cat(blocks))
    return torch.cat(ctas)


def pack_bptt_weights(spec: SamplerSpec, w: SamplerWeights, plan: BackwardPlan) -> Tensor:
    """K2's BPTT matrices as ``plan`` lays them out (``_pack_bptt``), by one
    cached gather."""
    return _source(w)[_pack_index(_pack_bptt, spec, plan, w.w_x.device)]


def _pack_bptt(spec: SamplerSpec, w: SamplerWeights, plan: BackwardPlan) -> Tensor:
    """The matrices of K2's transposed products as ``plan`` lays them out.

    One-block paths: one ``[3H, ld]`` block per layer with ``W_hh^T`` in
    columns ``0..H-1`` and the matrix that sends the cotangent down beside
    it (``W_x^T`` for layer 0, ``W_ih^T`` above), zero in the padding
    columns, flattened in layer order.

    Cluster path, per CTA c in turn: per layer a ``[uc, H + in, 4]`` block
    whose row u holds, for each row i of ``W_hh`` and then of ``W_x`` /
    ``W_ih``, the float4 ``{r, z, n, 0}`` of unit ``c*uc + u``'s gate
    columns; then ``W_out``'s columns of its outputs (``cluster_layout``)
    as ``[nop, H]`` rows, zero in the padding rows."""
    if plan.path == PATH_CLUSTER:
        packed = _pack_cluster_bptt(spec, w, plan)
        want = plan.cluster * plan.packed_floats
    else:
        packed = _pack_block_bptt(spec, w, plan)
        want = plan.packed_floats
    if packed.numel() != want:
        raise ValueError(f"packed K2 weights: {packed.numel()} floats, the plan wants {want}")
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
    path: int = -1,
    cluster: int = 0,
    rows: int = 0,
    acts: Tensor | None = None,
) -> SamplerGrads:
    """K2 on the BPTT plan by shape, or on the ``path``, ``cluster`` and
    ``rows`` asked for (``backward_plan``). ``acts`` may hold the gate
    pass's scratch (``[L, T, B, 4H]``: r, z, n and n_hh of every step and
    layer), for a caller that reads the gates back."""
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
    lib = SDE_SAMPLER.get()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows_t, cols_t = _int_tables(spec, dev)
    plan = backward_plan(spec, batch, dev.index, path, cluster, rows)
    on_cluster = plan.path == PATH_CLUSTER

    x_in = torch.cat([x0[None], fwd.paths[:-1]])
    packed = pack_bptt_weights(spec, w, plan)
    w_outT = w.w_out.t().contiguous()
    layout = _layout_tensor(d, spec.cholesky, plan.cluster, dev) if on_cluster else None

    def empty(*shape: int) -> Tensor:
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if acts is None:
        acts = empty(n_layers, n_steps, batch, 4 * h)  # r, z, n, n_hh of every step and layer
    _check("acts", acts, (n_layers, n_steps, batch, 4 * h), dev)
    if on_cluster and (acts.data_ptr() % 16 or fwd.h_all.data_ptr() % 16):
        raise ValueError("the cluster BPTT reads acts and h_all in 16-byte pieces: both must be 16-byte aligned")
    d_gc = empty(n_steps, batch, g3)
    d_eps = empty(n_steps, batch, d)
    d_x0 = empty(batch, d)
    d_gh = empty(n_layers, n_steps, batch, g3)
    d_gi = empty(n_layers - 1, n_steps, batch, g3)
    d_out = empty(n_steps, batch, spec.n_out)
    err = lib.sde_sampler_bwd(
        gc.data_ptr(), eps.data_ptr(), x_in.data_ptr(), fwd.h_all.data_ptr(),
        fwd.raw.data_ptr(), d_paths.data_ptr(), d_means.data_ptr(), d_cholv.data_ptr(),
        *(_ptr(t) for t in w[:7]), None if on_cluster else packed.data_ptr(), w_outT.data_ptr(),
        rows_t.data_ptr(), cols_t.data_ptr(), packed.data_ptr() if on_cluster else None, _ptr(layout),
        acts.data_ptr(), d_gc.data_ptr(), d_eps.data_ptr(), d_x0.data_ptr(), d_gh.data_ptr(),
        _ptr(d_gi), d_out.data_ptr(),
        batch, n_steps, d, h, n_layers, spec.n_tril, int(spec.cholesky == "diag"),
        plan.path, plan.cluster, plan.rows, *_scalars(spec), stream,
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
    "K1_MAX_HIDDEN",
    "BackwardPlan",
    "ForwardPlan",
    "ROWS_PER_BLOCK",
    "backward_plan",
    "forward_plan",
    "pack_bptt_weights",
    "pack_forward_weights",
    "cluster_rows",
    "cluster_slots",
    "cluster_waves",
    "cluster_layout",
    "plan_backward",
    "plan_forward",
    "PATH_CLUSTER",
    "PATH_STAGED",
    "PATH_STREAMING",
    "prep_weights",
    "sampler_forward",
    "sampler_backward",
    "sample_paths",
    "sample_paths_scan",
    "index_tables",
    "tril_indices",
]
