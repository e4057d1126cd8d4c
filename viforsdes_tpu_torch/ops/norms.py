"""Normalization layers.

PyTorch twin of ``viforsdes_tpu/ops/norms.py``: statistics in fp32, data kept
in its input dtype, and the scale cast to that dtype before the multiply (the
JAX package's rounding points, which a bf16 comparison relies on).
"""

from __future__ import annotations

import torch
from torch import Tensor


def rms_norm(x: Tensor, weight: Tensor | None = None, *, eps: float = 1e-6) -> Tensor:
    mean_sq = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    out = x * torch.rsqrt(mean_sq + eps).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def layer_norm(
    x: Tensor,
    weight: Tensor | None = None,
    bias: Tensor | None = None,
    *,
    eps: float = 1e-5,
) -> Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True) - torch.square(mean)
    scale = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    out = (x - mean.to(x.dtype)) * scale.to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out
