"""adaLN-Zero conditioning (twin of ``viforsdes_tpu/ops/cond.py``).

``SiLU -> Linear(cond_dim, 3*branches*hidden)`` with the linear ZERO-initialized,
chunked into per-branch ``(scale, shift, gate)``: a branch modulates ``t`` as
``(1+scale)*t + shift`` and gates it as ``t*gate`` (``ops/adaln_norm.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from viforsdes_tpu_torch.ops.initializers import linear, linear_init, zeros_init


class CondBranch(NamedTuple):
    scale: Tensor
    shift: Tensor
    gate_value: Tensor


def cond_modulator_init(
    gen: torch.Generator, cond_dim: int, hidden_dim: int, *, branches: int = 1
) -> dict:
    if branches <= 0:
        raise ValueError("branches must be positive")
    return {
        "net": linear_init(gen, cond_dim, hidden_dim * 3 * branches, bias=True, w_init=zeros_init),
    }


def cond_modulator(params: dict, cond: Tensor, *, branches: int) -> tuple[CondBranch, ...]:
    chunks = torch.chunk(linear(params["net"], F.silu(cond)), 3 * branches, dim=-1)
    return tuple(
        CondBranch(scale=chunks[i * 3], shift=chunks[i * 3 + 1], gate_value=chunks[i * 3 + 2])
        for i in range(branches)
    )
