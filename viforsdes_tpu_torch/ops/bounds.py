"""Lower-bound clamp with straight-through-style gradient.

Twin of ``viforsdes_tpu/ops/bounds.py``. Forward is ``max(x, bound)``; the
backward passes the gradient iff ``x >= bound`` OR ``grad < 0``, letting the
optimizer push a clamped value back above the bound but not further below it.
The path-sampler kernel applies the same rule (``lower_bound_grad_mask``) to
its summed Cholesky cotangent, so both sampler paths train alike near the
``DIAG_MIN`` boundary.
"""

from __future__ import annotations

import torch
from torch import Tensor


def lower_bound_grad_mask(x: Tensor, bound: float, g: Tensor) -> Tensor:
    """The raw backward rule, exposed for kernel implementations and tests."""
    return torch.where((x >= bound) | (g < 0), g, torch.zeros_like(g))


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, bound: float) -> Tensor:
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g: Tensor):
        (x,) = ctx.saved_tensors
        return lower_bound_grad_mask(x, ctx.bound, g), None


def lower_bound(x: Tensor, bound: float) -> Tensor:
    """``max(x, bound)`` with the asymmetric pass-through gradient."""
    return _LowerBound.apply(x, float(bound))
