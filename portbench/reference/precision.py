"""Where the reference rounds, and to what.

The reference computes in float32 with TF32 off. The controls of the
correctness check run the same reference one precision lower than the
configuration states (``PERF.md``, "How correct is decided"):

- ``fp8``: every operand of the encoder's matrix products (the region the
  program runs in bfloat16) rounded to float8 e4m3 with a per-tensor scale,
  products accumulated in float32, as fp8 training runs them;
- ``tf32``: float32 with TF32 matrix products on (a card setting; on the CPU
  it changes nothing).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch import Tensor

FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


class Precision:
    """``q(x)``: ``x`` as the encoder's products take it."""

    def __init__(self, kind: str = "fp32") -> None:
        if kind not in ("fp32", "fp8", "tf32"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: Tensor) -> Tensor:
        if self.kind != "fp8":
            return x
        return _Fp8Round.apply(x)

    @contextmanager
    def matmul(self):
        """TF32 products for ``tf32``, strict float32 otherwise."""
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.kind == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: Tensor) -> Tensor:
    """``x`` rounded to e4m3 after scaling its largest magnitude to
    ``FP8_MAX``, and scaled back."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _Fp8Round(torch.autograd.Function):
    """Rounding forward, rounding of the cotangent backward: both the
    product and its gradient products take fp8 operands."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        return fp8_round(g)
