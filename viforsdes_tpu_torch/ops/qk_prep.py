"""Fused QK-RMSNorm + RoPE: the hand-written CUDA kernels K3 (forward) and K4
(backward), their plain PyTorch versions, and the autograd bridge.

PyTorch counterpart of ``viforsdes_tpu/ops/pallas/qk_prep.py``. ``qk_prep``
computes ``apply_rope_1d(rms_norm(x))`` over ``x [B, H, S, D]`` in one pass
with the composition's rounding points (the rsqrt scale cast to x's dtype
before the multiply, the rotation in fp32 on the normed halves); its
backward re-reads the raw x instead of saving normalized intermediates.
Gradients flow to x only: the cos/sin tables are constants.

The wrappers launch the kernels (``csrc/qk_prep.cu``) for CUDA tensors and
take the plain versions only for CPU tensors; any other device raises. On the
card x may be a strided view (q or k as the QKV projection left them); the
output is written in ``[B, S, H, D]`` memory and returned as a ``[B, H, S, D]``
view, the layout the rest of the attention block reads.
"""

from __future__ import annotations

import torch
from torch import Tensor

from viforsdes_tpu_torch.ops.embeddings import RotaryTables, apply_rope_1d
from viforsdes_tpu_torch.ops.kernel_build import (
    ATTENTION,
    LaunchCounter,
    kernel_operand,
    raise_on,
    view_args,
)
from viforsdes_tpu_torch.ops.norms import rms_norm

SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

FORWARD_LAUNCHES = LaunchCounter()
BACKWARD_LAUNCHES = LaunchCounter()


# ------------------------------------------------------------- plain versions


def _forward_plain(x: Tensor, cos: Tensor, sin: Tensor, eps: float) -> Tensor:
    """The unfused composition: RMSNorm, then RoPE along the sequence axis."""
    return apply_rope_1d(rms_norm(x, eps=eps), RotaryTables(cos=cos, sin=sin))


def _backward_plain(x: Tensor, cos: Tensor, sin: Tensor, dy: Tensor, eps: float) -> Tensor:
    """The explicit VJP of K4: inverse rotation, then the RMSNorm VJP with
    ``r = rsqrt(mean(x^2) + eps)`` recomputed from the raw x in fp32."""
    x32, dy32 = x.float(), dy.float()
    f = cos.shape[-1]
    dr, di = dy32[..., :f], dy32[..., f:]
    dn = torch.cat([dr * cos + di * sin, -dr * sin + di * cos], dim=-1)
    d = x.shape[-1]
    r = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    s = torch.sum(dn * x32, dim=-1, keepdim=True)
    return (r * dn - x32 * (r * r * r) * (s / d)).to(x.dtype)


# ----------------------------------------------------------- CUDA kernels


def bshd_empty(like: Tensor) -> Tensor:
    """An uninitialized ``[B, H, S, D]`` tensor like ``like``, stored as
    ``[B, S, H, D]`` (returned as the transposed view)."""
    b, h, s, d = like.shape
    return like.new_empty((b, s, h, d)).transpose(1, 2)


def _check(x: Tensor, cos: Tensor, sin: Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"qk_prep: expected x [B, H, S, D], got shape {tuple(x.shape)}")
    b, h, s, d = x.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"qk_prep: head_dim {d} has no kernel; supported head widths are "
            f"{SUPPORTED_HEAD_DIMS}"
        )
    if x.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"qk_prep: dtype {x.dtype} has no kernel; supported: {SUPPORTED_DTYPES}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (s, d // 2) or t.device != x.device:
            raise ValueError(f"qk_prep: {name} must be float32 [{s}, {d // 2}] on {x.device}")


def _tables(cos: Tensor, sin: Tensor) -> tuple[Tensor, Tensor]:
    return kernel_operand(cos.contiguous()), kernel_operand(sin.contiguous())


def _forward_cuda(x: Tensor, cos: Tensor, sin: Tensor, eps: float) -> Tensor:
    _check(x, cos, sin)
    x = kernel_operand(x)
    cos, sin = _tables(cos, sin)
    out = bshd_empty(x)
    b, h, s, d = x.shape
    err = ATTENTION.get().qk_prep_fwd(
        *view_args(x), cos.data_ptr(), sin.data_ptr(), *view_args(out),
        b, h, s, d, int(x.dtype == torch.bfloat16), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on(err, "qk_prep_fwd")
    FORWARD_LAUNCHES.count += 1
    return out


def _backward_cuda(x: Tensor, cos: Tensor, sin: Tensor, dy: Tensor, eps: float) -> Tensor:
    _check(x, cos, sin)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("qk_prep backward: dy must match x in shape, dtype and device")
    x, dy = kernel_operand(x), kernel_operand(dy)
    cos, sin = _tables(cos, sin)
    dx = bshd_empty(x)
    b, h, s, d = x.shape
    err = ATTENTION.get().qk_prep_bwd(
        *view_args(x), *view_args(dy), cos.data_ptr(), sin.data_ptr(), *view_args(dx),
        b, h, s, d, int(x.dtype == torch.bfloat16), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on(err, "qk_prep_bwd")
    BACKWARD_LAUNCHES.count += 1
    return dx


# ----------------------------------------------------------------- wrappers


def qk_prep_forward(x: Tensor, cos: Tensor, sin: Tensor, eps: float) -> Tensor:
    """K3: the CUDA kernel for CUDA tensors; the plain version for CPU tensors."""
    if x.is_cuda:
        return _forward_cuda(x, cos, sin, eps)
    if x.device.type == "cpu":
        return _forward_plain(x, cos, sin, eps)
    raise NotImplementedError(f"qk_prep: no kernel for device {x.device}")


def qk_prep_backward(x: Tensor, cos: Tensor, sin: Tensor, dy: Tensor, eps: float) -> Tensor:
    """K4: the CUDA kernel for CUDA tensors; the plain version for CPU tensors."""
    if x.is_cuda:
        return _backward_cuda(x, cos, sin, dy, eps)
    if x.device.type == "cpu":
        return _backward_plain(x, cos, sin, dy, eps)
    raise NotImplementedError(f"qk_prep backward: no kernel for device {x.device}")


class QKPrep(torch.autograd.Function):
    """Autograd bridge over K3/K4: ``(x [B, H, S, D], cos [S, D/2], sin
    [S, D/2], eps) -> [B, H, S, D]``; no gradient for the tables."""

    @staticmethod
    def forward(ctx, x: Tensor, cos: Tensor, sin: Tensor, eps: float) -> Tensor:
        ctx.eps = eps
        ctx.save_for_backward(x, cos, sin)
        return qk_prep_forward(x, cos, sin, eps)

    @staticmethod
    def backward(ctx, dy: Tensor):
        x, cos, sin = ctx.saved_tensors
        return qk_prep_backward(x, cos, sin, dy, ctx.eps), None, None, None


def qk_prep(x: Tensor, cos: Tensor, sin: Tensor, eps: float = 1e-6) -> Tensor:
    """``rms_norm(x)`` + RoPE over ``x [B, H, S, D]`` in one fused pass;
    ``cos``/``sin`` are the ``[S, D/2]`` fp32 tables sliced to the sequence."""
    return QKPrep.apply(x, cos, sin, eps)


__all__ = [
    "FORWARD_LAUNCHES",
    "BACKWARD_LAUNCHES",
    "SUPPORTED_HEAD_DIMS",
    "QKPrep",
    "qk_prep",
    "qk_prep_forward",
    "qk_prep_backward",
]
