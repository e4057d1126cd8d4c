"""The SiT's norm site in one pass: the adaLN-Zero gated residual, the
non-affine LayerNorm and the adaLN modulation, as one hand-written CUDA
kernel pair (``csrc/adaln_norm.cu``), its plain PyTorch versions, and the
autograd bridge.

``gated_norm_modulate(x, y, gate, scale, shift, eps)`` returns
``(x_new, m)`` with ``x_new = x + y*gate`` (``x`` itself when ``y`` is None)
and ``m = (1+scale) * layer_norm(x_new) + shift``, the composition that
``ops/sit.py`` runs at each of a block's two norm sites. The kernels keep
``ops/norms.py``'s rounding points in the forward; the backward does all its
math in fp32 from the saved ``x_new``, ``y`` and fp32 row statistics, and
sums the modulation gradients over the tokens per CTA, then over the CTAs in
a fixed order (no atomics).

The kernels take CUDA tensors ``x [B, S, 256]`` in fp32 or bf16 with the
modulation as ``[B, 1, 256]`` broadcast chunks; anything else (CPU tensors,
a per-token ``[B, S, C]`` cond, another width) takes the eager composition,
which is also the oracle the kernels are held to.
"""

from __future__ import annotations

import torch
from torch import Tensor

from viforsdes_tpu_torch.ops.kernel_build import ADALN_NORM, LaunchCounter, raise_on
from viforsdes_tpu_torch.ops.norms import layer_norm

SUPPORTED_WIDTHS = (256,)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
ROWS_PER_CTA = 64  # token rows of one sample a CTA owns (8 warps, 8 rows each)

FORWARD_LAUNCHES = LaunchCounter()
BACKWARD_LAUNCHES = LaunchCounter()  # one a backward call: the gradient kernel and its reduction


# ------------------------------------------------------------- plain versions


def _forward_plain(
    x: Tensor, y: Tensor | None, gate: Tensor | None, scale: Tensor, shift: Tensor, eps: float
) -> tuple[Tensor, Tensor]:
    """The eager composition: the gated residual, then the modulated LayerNorm."""
    x_new = x if y is None else x + y * gate
    return x_new, (1 + scale) * layer_norm(x_new, eps=eps) + shift


def _row_stats(x_new: Tensor, eps: float) -> Tensor:
    """``[..., 2]`` fp32 (mean, rstd) of each row, as ``layer_norm`` takes them."""
    xf = x_new.float()
    mean = torch.mean(xf, dim=-1)
    var = torch.mean(torch.square(xf), dim=-1) - torch.square(mean)
    return torch.stack([mean, torch.rsqrt(torch.clamp(var, min=0.0) + eps)], dim=-1)


def _backward_plain(
    x_new: Tensor,
    y: Tensor | None,
    gate: Tensor | None,
    scale: Tensor,
    stats: Tensor,
    dx_new: Tensor | None,
    dm: Tensor,
) -> tuple[Tensor, Tensor | None, Tensor | None, Tensor, Tensor]:
    """The explicit VJP the backward kernel computes, all in fp32:
    ``(dx, dy, dgate, dscale, dshift)``, ``dy`` and ``dgate`` None without a
    residual. ``1 + scale`` is taken in the data type, as the forward used it."""
    dtype = x_new.dtype
    mean, rstd = stats[..., :1], stats[..., 1:]
    n = (x_new.float() - mean) * rstd
    dmf = dm.float()
    g = dmf * (1 + scale).float()
    d = rstd * (g - g.mean(-1, keepdim=True) - n * (g * n).mean(-1, keepdim=True))
    dscale = (dmf * n).sum(1, keepdim=True).to(dtype)
    dshift = dmf.sum(1, keepdim=True).to(dtype)
    if y is None:
        return d.to(dtype), None, None, dscale, dshift
    d = d + dx_new.float()
    dgate = (d * y.float()).sum(1, keepdim=True).to(dtype)
    return d.to(dtype), (d * gate.float()).to(dtype), dgate, dscale, dshift


# ----------------------------------------------------------- CUDA kernels


def kernel_fits(
    x: Tensor, y: Tensor | None, gate: Tensor | None, scale: Tensor, shift: Tensor
) -> bool:
    """Whether the kernels take these operands, on whatever device: ``x
    [B, S, H]`` with H a supported width and rows to work on, ``y`` like
    ``x``, and the modulation as ``[B, 1, H]`` chunks of x's dtype."""
    if x.dim() != 3 or x.dtype not in SUPPORTED_DTYPES or x.numel() == 0:
        return False
    b, _, h = x.shape
    if h not in SUPPORTED_WIDTHS:
        return False
    if y is not None and (y.shape != x.shape or y.dtype != x.dtype or gate is None):
        return False
    mods = [scale, shift] + ([] if y is None else [gate])
    return all(t.shape == (b, 1, h) and t.dtype == x.dtype and t.device == x.device for t in mods)


def _rows(t: Tensor) -> tuple[Tensor, int]:
    """A ``[B, 1, H]`` modulation chunk and the element stride between its
    samples, copied only where its rows are not 16-byte aligned vectors."""
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or t.stride(0) % vec:
        t = t.contiguous()
    return t, t.stride(0)


def _chunks(s: int) -> int:
    return -(-s // ROWS_PER_CTA)


def _forward_cuda(
    x: Tensor, y: Tensor | None, gate: Tensor | None, scale: Tensor, shift: Tensor, eps: float
) -> tuple[Tensor, Tensor, Tensor]:
    """``(x_new, m, stats)``; ``x_new`` is ``x`` without a residual."""
    b, s, h = x.shape
    x = x.contiguous()
    scale, s_scale = _rows(scale)
    shift, s_shift = _rows(shift)
    m = torch.empty_like(x)
    stats = torch.empty((b, s, 2), dtype=torch.float32, device=x.device)
    if y is None:
        x_new, y_ptr, gate_ptr, s_gate = x, None, None, 0
    else:
        y = y.contiguous()
        gate, s_gate = _rows(gate)
        x_new, y_ptr, gate_ptr = torch.empty_like(x), y.data_ptr(), gate.data_ptr()
    err = ADALN_NORM.get().adaln_norm_fwd(
        x.data_ptr(), y_ptr, gate_ptr, s_gate, scale.data_ptr(), s_scale, shift.data_ptr(), s_shift,
        x_new.data_ptr(), m.data_ptr(), stats.data_ptr(),
        b, s, h, ROWS_PER_CTA, int(x.dtype == torch.bfloat16), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on(err, "adaln_norm_fwd")
    FORWARD_LAUNCHES.count += 1
    return x_new, m, stats


def _backward_cuda(
    x_new: Tensor,
    y: Tensor | None,
    gate: Tensor | None,
    scale: Tensor,
    stats: Tensor,
    dx_new: Tensor | None,
    dm: Tensor,
) -> tuple[Tensor, Tensor | None, Tensor | None, Tensor, Tensor]:
    b, s, h = x_new.shape
    nq = 2 if y is None else 3
    dm = dm.contiguous()
    scale, s_scale = _rows(scale)
    dx = torch.empty_like(x_new)
    partial = torch.empty((b, _chunks(s), nq, h), dtype=torch.float32, device=x_new.device)
    dmod = torch.empty((nq, b, 1, h), dtype=x_new.dtype, device=x_new.device)
    if y is None:
        dy, y_ptr, gate_ptr, s_gate, dx_new_ptr, dy_ptr = None, None, None, 0, None, None
    else:
        gate, s_gate = _rows(gate)
        dx_new = dx_new.contiguous()
        dy = torch.empty_like(y)
        y_ptr, gate_ptr, dx_new_ptr, dy_ptr = y.data_ptr(), gate.data_ptr(), dx_new.data_ptr(), dy.data_ptr()
    err = ADALN_NORM.get().adaln_norm_bwd(
        x_new.data_ptr(), y_ptr, gate_ptr, s_gate, scale.data_ptr(), s_scale, stats.data_ptr(),
        dm.data_ptr(), dx_new_ptr, dx.data_ptr(), dy_ptr, partial.data_ptr(), dmod.data_ptr(),
        b, s, h, ROWS_PER_CTA, int(x_new.dtype == torch.bfloat16),
        torch.cuda.current_stream(x_new.device).cuda_stream,
    )
    raise_on(err, "adaln_norm_bwd")
    BACKWARD_LAUNCHES.count += 1
    dgate = None if y is None else dmod[2]
    return dx, dy, dgate, dmod[0], dmod[1]


class GatedNormModulate(torch.autograd.Function):
    """Autograd bridge over the kernels: ``(x, y, gate, scale, shift, eps)``
    -> ``(x_new, m)``, or ``m`` alone when ``y`` is None."""

    @staticmethod
    def forward(ctx, x, y, gate, scale, shift, eps):
        x_new, m, stats = _forward_cuda(x, y, gate, scale, shift, eps)
        ctx.save_for_backward(x_new, y, gate, scale, stats)
        return m if y is None else (x_new, m)

    @staticmethod
    def backward(ctx, *grads):
        x_new, y, gate, scale, stats = ctx.saved_tensors
        dx_new, dm = (None, grads[0]) if y is None else grads
        dx, dy, dgate, dscale, dshift = _backward_cuda(x_new, y, gate, scale, stats, dx_new, dm)
        return dx, dy, dgate, dscale, dshift, None


# ----------------------------------------------------------------- wrapper


def gated_norm_modulate(
    x: Tensor,
    y: Tensor | None,
    gate: Tensor | None,
    scale: Tensor,
    shift: Tensor,
    *,
    eps: float = 1e-5,
) -> tuple[Tensor, Tensor]:
    """``(x_new, m)``: ``x_new = x + y*gate`` (``x`` when ``y`` is None) and
    ``m = (1+scale) * layer_norm(x_new) + shift``. The kernels for CUDA
    operands they fit (``kernel_fits``); the eager composition otherwise."""
    if x.is_cuda and kernel_fits(x, y, gate, scale, shift):
        out = GatedNormModulate.apply(x, y, gate, scale, shift, eps)
        return (x, out) if y is None else out
    return _forward_plain(x, y, gate, scale, shift, eps)


__all__ = [
    "FORWARD_LAUNCHES",
    "BACKWARD_LAUNCHES",
    "SUPPORTED_WIDTHS",
    "GatedNormModulate",
    "gated_norm_modulate",
    "kernel_fits",
]
