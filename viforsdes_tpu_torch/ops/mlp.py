"""SwiGLU MLP: ``Linear(in, 2h) -> silu(left) * right -> Linear(h, in)``
(twin of ``viforsdes_tpu/ops/mlp.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from viforsdes_tpu_torch.ops.initializers import (
    Initializer,
    linear,
    linear_init,
    trunc_normal_init,
)


def swiglu_init(
    gen: torch.Generator,
    in_dim: int,
    hidden_dim: int,
    *,
    bias: bool = True,
    w_init_in: Initializer = trunc_normal_init,
    w_init_out: Initializer = trunc_normal_init,
) -> dict:
    return {
        "input_proj": linear_init(gen, in_dim, 2 * hidden_dim, bias=bias, w_init=w_init_in),
        "output_proj": linear_init(gen, hidden_dim, in_dim, bias=bias, w_init=w_init_out),
    }


def swiglu(params: dict, x: Tensor) -> Tensor:
    left, right = torch.chunk(linear(params["input_proj"], x), 2, dim=-1)
    return linear(params["output_proj"], F.silu(left) * right)
