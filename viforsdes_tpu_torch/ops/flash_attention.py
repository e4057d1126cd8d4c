"""Blockwise (flash) attention for long grids: the hand-written CUDA kernels K5
(forward), K6 (dK/dV) and K7 (dQ), their plain PyTorch versions, and the
autograd bridge.

PyTorch counterpart of ``viforsdes_tpu/ops/flash_attention.py`` and
``viforsdes_tpu/ops/pallas/flash_fixed.py``. The dense path materializes
``[B, H, S, S]`` probabilities, about 1 GB per block per pass at the
Lorenz-63 grid (B=32, H=4, S=2001); the kernels keep them on chip and save one
fp32 log-sum-exp per row for the backward.

Semantics of ``flash_sdpa``: non-causal attention with ``sm_scale =
1/sqrt(head_dim)``, fp32 logits and softmax from inputs in bf16 or fp32, the
output in the input dtype. ``real_len`` (below S) puts the tokens from
``real_len`` on in their own segment: real queries never see them, and they
see only each other. Where the JAX function pads S to its 512-token block and
its pad queries also see those zero-padded keys, the kernels have no padding
and mask the ragged tail instead, so rows from ``real_len`` on may differ from
the JAX function's; their callers discard those rows.

The wrappers launch the kernels (``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``) for CUDA tensors and take the plain versions only
for CPU tensors; any other device raises. ``di = rowsum(o * do)`` is a plain
reduction outside the kernels, as in the JAX package. With bf16 inputs K5, K6
and K7 read q, k, v and do by TMA and run ``wgmma``; with fp32 inputs they do
the same in 3xTF32 (each product split into tf32 hi and lo parts, fp32
accuracy). ``flash_plan`` gives the launch plans.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from viforsdes_tpu_torch.ops.kernel_build import (
    ATTENTION,
    LaunchCounter,
    kernel_operand,
    raise_on,
    view_args,
)
from viforsdes_tpu_torch.ops.qk_prep import SUPPORTED_DTYPES, SUPPORTED_HEAD_DIMS, bshd_empty

# Grids longer than this take the flash kernels; shorter grids keep the dense
# path, whose [S, S] probabilities are small there.
FLASH_SEQ_THRESHOLD = 512

# DEFAULT_MASK_VALUE of the Pallas TPU flash kernel.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

FORWARD_LAUNCHES = LaunchCounter()    # K5
BACKWARD_DKV_LAUNCHES = LaunchCounter()  # K6
BACKWARD_DQ_LAUNCHES = LaunchCounter()   # K7


def use_flash_attention(seq_len: int) -> bool:
    """Static dispatch: the flash kernels serve grids longer than 512 tokens."""
    return seq_len > FLASH_SEQ_THRESHOLD


# ------------------------------------------------------------ launch plan

# The wgmma kernels (``FwdPlan``, ``DkvPlan``, ``DqPlan``, ``FwdPlan32``,
# ``DkvPlan32``, ``DqPlan32`` and the block constants of
# ``csrc/flash_attn.cuh``): a block owns its output rows (consumer
# warpgroups of 64 and one producer warpgroup) and streams the other side's
# rows through a ring of stages. With bf16 inputs a block owns WGMMA_ROWS rows
# and the ring has WGMMA_STAGES stages.
WGMMA_ROWS = 128
WGMMA_THREADS = 384
WGMMA_STAGES = 4

# fp32 inputs (K5-K7 in 3xTF32): every operand tile holds a hi and a lo
# part, and K5's v (K6's q and do, K7's k) also arrives transposed, so the
# tiles are shorter: streamed rows by kernel and head_dim, and at head_dim 128
# one consumer warpgroup of 64 rows. K5 holds only q fixed and affords wider
# kv tiles than K7.
TF32_TILE_ROWS = {"fwd": {32: 32, 64: 32, 128: 16}, "dkv": {32: 32, 64: 16, 128: 8},
                  "dq": {32: 32, 64: 16, 128: 8}}


class FlashPlan(NamedTuple):
    rows: int        # output rows of a block: q rows (K5, K7), kv rows (K6)
    tile_rows: int   # streamed rows a stage: kv rows (K5, K7), q rows (K6)
    stages: int
    threads: int
    smem_bytes: int  # dynamic shared memory, 1024 bytes of alignment included


def _tf32_plan(kernel: str, d: int) -> FlashPlan:
    """K5 (``"fwd"``), K6 (``"dkv"``) or K7 (``"dq"``) with fp32 inputs:
    ``Tile32`` tiles of hi and lo, 4-byte elements."""
    groups = 1 if d == 128 else 2
    rows, tile = 64 * groups, TF32_TILE_ROWS[kernel][d]
    split = 2 * tile * d * 4  # one streamed operand, hi and lo
    fixed = 2 * (2 * rows * d * 4)  # the block's two operands, hi and lo
    if kernel == "fwd":  # q fixed; k, v^T (stagers) and v as TMA lands it
        fixed //= 2
        stages = 4
        stage = 2 * split + tile * d * 4
    elif kernel == "dkv":  # q, do, q^T, do^T (stagers), lse, di
        stages = 4 if d == 32 else 3
        stage = 4 * split + 2 * 4 * tile
    else:  # k, v, k^T (stagers)
        stages = 4
        stage = 3 * split
    barriers = 8 * (2 + 3 * stages)
    smem = 1024 + fixed + stages * stage + barriers
    return FlashPlan(rows, tile, stages, 128 * (groups + 1), smem)


def flash_plan(kernel: str, head_dim: int, dtype: torch.dtype = torch.bfloat16) -> FlashPlan:
    """The launch plan of K5 (``kernel="fwd"``), K6 (``"dkv"``) or K7
    (``"dq"``) with ``dtype`` inputs at ``head_dim``; ``chip_smoke.py`` holds
    it equal to the kernels' own (``flash_attn_fwd_plan``,
    ``flash_attn_bwd_plan``)."""
    d = head_dim
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash attention: head_dim {d} has no kernel")
    if kernel not in ("fwd", "dkv", "dq"):
        raise ValueError(f"flash_plan: unknown kernel {kernel!r}")
    if dtype == torch.float32:
        return _tf32_plan(kernel, d)
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_plan: no kernel for {dtype}")
    if kernel == "fwd":  # q fixed; k and v tiles streamed
        tile = 64 if d == 128 else 128
        fixed, stage = 2 * WGMMA_ROWS * d, 2 * (2 * tile * d)
    elif kernel == "dkv":  # k and v fixed; q and do tiles (TMA), lse and di streamed
        tile = 16 if d == 128 else 32
        fixed, stage = 2 * (2 * WGMMA_ROWS * d), 2 * (2 * tile * d) + 2 * 4 * tile
    else:  # q and do fixed; k and v tiles streamed
        tile = 32 if d == 128 else 64
        fixed, stage = 2 * (2 * WGMMA_ROWS * d), 2 * (2 * tile * d)
    barriers = 8 * (1 + 2 * WGMMA_STAGES)
    smem = 1024 + fixed + WGMMA_STAGES * stage + barriers
    return FlashPlan(WGMMA_ROWS, tile, WGMMA_STAGES, WGMMA_THREADS, smem)


def tma_readable(t: Tensor) -> bool:
    """Whether TMA can read ``t`` as a ``[B, H, S, D]`` tensor map: unit
    stride on D, a 16-byte aligned base, and outer byte strides that are
    positive multiples of 16 below 2**40."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(0 < s * t.element_size() < 2**40 and s * t.element_size() % 16 == 0
               for s in t.stride()[:-1])


def _tma_operand(t: Tensor) -> Tensor:
    """``t`` where the kernels can read it through its strides (TMA), else a
    contiguous copy; refused before any launch if even the copy is not
    readable."""
    t = kernel_operand(t)
    if not tma_readable(t):
        t = t.clone(memory_format=torch.contiguous_format)
    if not tma_readable(t):
        raise ValueError(f"flash attention: TMA cannot read a view with strides {t.stride()}")
    return t


# ------------------------------------------------------------- plain versions


def _masked_logits(q: Tensor, k: Tensor, real_len: int, sm_scale: float) -> Tensor:
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    s = q.shape[2]
    if real_len < s:
        seg = torch.arange(s, device=q.device) >= real_len
        same = seg[:, None] == seg[None, :]
        logits = torch.where(same, logits, torch.full_like(logits, DEFAULT_MASK_VALUE))
    return logits


def _forward_plain(
    q: Tensor, k: Tensor, v: Tensor, real_len: int, sm_scale: float
) -> tuple[Tensor, Tensor]:
    """The dense masked softmax of the JAX package's reference
    (``_reference_masked_attention``) over ``[B, H, S, D]``, in fp32, and the
    log-sum-exp of each row."""
    logits = _masked_logits(q, k, real_len, sm_scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
    return out, lse


def _backward_plain(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
    real_len: int, sm_scale: float,
) -> tuple[Tensor, Tensor, Tensor]:
    """The Pallas library's ``mha_reference_bwd`` with the scale: p from the
    saved log-sum-exp, ``ds = p (dp - di) * scale``."""
    p = torch.exp(_masked_logits(q, k, real_len, sm_scale) - lse[..., None])
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32).to(v.dtype)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    di = torch.sum(o.float() * do32, dim=-1, keepdim=True)
    ds = (dp - di) * p * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).to(k.dtype)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)
    return dq, dk, dv


# ----------------------------------------------------------- CUDA kernels


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash attention: q, k, v must share one [B, H, S, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash attention: head_dim {d} has no kernel; supported head widths "
            f"are {SUPPORTED_HEAD_DIMS}"
        )
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash attention: q, k, v must share one dtype of {SUPPORTED_DTYPES}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention: q, k, v must be on one device")


def _check_scale(sm_scale: float) -> None:
    """The kernels take the row max on unscaled scores (K5) and fold
    log2(scale) into the exponent (K7): both need a positive scale."""
    if not sm_scale > 0:
        raise ValueError(f"flash attention: sm_scale must be positive, got {sm_scale}")


def _forward_cuda(
    q: Tensor, k: Tensor, v: Tensor, real_len: int, sm_scale: float
) -> tuple[Tensor, Tensor]:
    _check(q, k, v)
    _check_scale(sm_scale)
    q, k, v = (_tma_operand(t) for t in (q, k, v))
    b, h, s, d = q.shape
    out = bshd_empty(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = ATTENTION.get().flash_attn_fwd(
        *view_args(q), *view_args(k), *view_args(v), *view_args(out), lse.data_ptr(),
        b, h, s, d, real_len, int(q.dtype == torch.bfloat16), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on(err, "flash_attn_fwd")
    FORWARD_LAUNCHES.count += 1
    return out, lse


def _backward_operands(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
    real_len: int, sm_scale: float,
) -> tuple[tuple, Tensor, Tensor, Tensor]:
    """The C arguments of K6 and K7 (inputs, ``di = rowsum(o * do)`` and the
    gradients they write) and the gradient tensors."""
    _check(q, k, v)
    _check_scale(sm_scale)
    if do.shape != q.shape or do.device != q.device:
        raise ValueError("flash attention backward: do must match q in shape and device")
    q, k, v, do = (_tma_operand(t) for t in (q, k, v, do.to(q.dtype)))
    b, h, s, d = q.shape
    lse = lse.float().contiguous()
    di = torch.sum(o.float() * do.float(), dim=-1).contiguous()  # [B, H, S]
    dq, dk, dv = bshd_empty(q), bshd_empty(k), bshd_empty(v)
    args = (
        *view_args(q), *view_args(k), *view_args(v), *view_args(do),
        lse.data_ptr(), di.data_ptr(), *view_args(dq), *view_args(dk), *view_args(dv),
        b, h, s, d, real_len, int(q.dtype == torch.bfloat16), float(sm_scale),
    )
    # the args hold raw pointers: keep their tensors alive with them
    return (args, (q, k, v, do, lse, di)), dq, dk, dv


_PASSES = ((BACKWARD_DKV_LAUNCHES, "flash_attn_bwd dkv"), (BACKWARD_DQ_LAUNCHES, "flash_attn_bwd dq"))


def _backward_launch(operands: tuple, which: int) -> None:
    """Launch K6 (``which`` 0: dk, dv) or K7 (1: dq)."""
    args, tensors = operands
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    counter, what = _PASSES[which]
    raise_on(ATTENTION.get().flash_attn_bwd(*args, which, stream), what)
    counter.count += 1


def _backward_cuda(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
    real_len: int, sm_scale: float,
) -> tuple[Tensor, Tensor, Tensor]:
    operands, dq, dk, dv = _backward_operands(q, k, v, o, lse, do, real_len, sm_scale)
    _backward_launch(operands, 0)
    _backward_launch(operands, 1)
    return dq, dk, dv


# ----------------------------------------------------------------- wrappers


def flash_forward(
    q: Tensor, k: Tensor, v: Tensor, real_len: int, sm_scale: float
) -> tuple[Tensor, Tensor]:
    """K5 over ``[B, H, S, D]``: ``(o, lse)``. The CUDA kernel for CUDA
    tensors; the plain version for CPU tensors."""
    if q.is_cuda:
        return _forward_cuda(q, k, v, real_len, sm_scale)
    if q.device.type == "cpu":
        return _forward_plain(q, k, v, real_len, sm_scale)
    raise NotImplementedError(f"flash attention: no kernel for device {q.device}")


def flash_backward(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
    real_len: int, sm_scale: float,
) -> tuple[Tensor, Tensor, Tensor]:
    """K6 then K7: ``(dq, dk, dv)``. The CUDA kernels for CUDA tensors; the
    plain version for CPU tensors."""
    args = (q, k, v, o, lse, do, real_len, sm_scale)
    if q.is_cuda:
        return _backward_cuda(*args)
    if q.device.type == "cpu":
        return _backward_plain(*args)
    raise NotImplementedError(f"flash attention backward: no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Autograd bridge: K5 forward, K6 and K7 backward, over ``[B, H, S, D]``."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, real_len: int, sm_scale: float) -> Tensor:
        o, lse = flash_forward(q, k, v, real_len, sm_scale)
        ctx.real_len, ctx.sm_scale = real_len, sm_scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.real_len, ctx.sm_scale)
        return dq, dk, dv, None, None


# The widest head the flash kernels take; ``ops/attention.py`` sends wider
# heads to its dense path.
FLASH_MAX_HEAD_DIM = max(SUPPORTED_HEAD_DIMS)


def kernel_head_dim(d: int) -> int:
    """The kernel width a head of width ``d`` runs at: the narrowest of
    ``SUPPORTED_HEAD_DIMS`` that holds it."""
    for width in SUPPORTED_HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(
        f"flash attention: head_dim {d} is wider than the widest kernel width "
        f"{FLASH_MAX_HEAD_DIM}; such heads take the dense path"
    )


def flash_sdpa(
    q: Tensor, k: Tensor, v: Tensor, *, kernel_layout: bool = False,
    real_len: int | None = None,
) -> Tensor:
    """Non-causal flash attention over ``[B, S, H, D]`` tensors
    (``kernel_layout=True``: ``[B, H, S, D]`` in and out). Tokens from
    ``real_len`` on form their own segment; the output keeps the caller's S.
    A head width without a kernel (up to ``FLASH_MAX_HEAD_DIM``) runs
    zero-padded to ``kernel_head_dim(d)``: zero columns add exactly 0 to
    Q K^T and to P V, the scale stays ``1/sqrt(d)`` of the real width, and
    the output is sliced back to d (autograd carries the pad and the slice)."""
    if not kernel_layout:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s, d = q.shape[2], q.shape[3]
    sm_scale = 1.0 / math.sqrt(d)
    valid = s if real_len is None else min(int(real_len), s)
    width = kernel_head_dim(d)
    if width != d:
        q, k, v = (torch.nn.functional.pad(t, (0, width - d)) for t in (q, k, v))
    out = FlashAttention.apply(q, k, v, valid, sm_scale)
    if width != d:
        out = out[..., :d]
    return out if kernel_layout else out.transpose(1, 2)


__all__ = [
    "FLASH_MAX_HEAD_DIM",
    "FLASH_SEQ_THRESHOLD",
    "DEFAULT_MASK_VALUE",
    "FORWARD_LAUNCHES",
    "BACKWARD_DKV_LAUNCHES",
    "BACKWARD_DQ_LAUNCHES",
    "FlashAttention",
    "FlashPlan",
    "flash_plan",
    "flash_sdpa",
    "kernel_head_dim",
    "tma_readable",
    "flash_forward",
    "flash_backward",
    "use_flash_attention",
]
