"""Weight-init policy and the linear layer.

PyTorch twin of ``viforsdes_tpu/ops/initializers.py``. Weights are stored
``[in, out]`` as in the JAX package, so a layer is ``y = x @ W + b`` and a
checkpoint converts leaf for leaf. Initializers draw from an explicit CPU
``torch.Generator``; the caller moves the tree to its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import Tensor

TRUNC_STD = 0.02

Initializer = Callable[[torch.Generator, tuple[int, ...]], Tensor]


def trunc_normal_init(
    gen: torch.Generator, shape: tuple[int, ...], std: float = TRUNC_STD
) -> Tensor:
    """N(0, std^2) truncated at +/-2 std."""
    w = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def zeros_init(gen: torch.Generator, shape: tuple[int, ...]) -> Tensor:
    del gen
    return torch.zeros(shape, dtype=torch.float32)


def _uniform(gen: torch.Generator, shape: tuple[int, ...], bound: float) -> Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def fan_in_uniform_init(gen: torch.Generator, shape: tuple[int, ...]) -> Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with ``shape = [in, out]``."""
    return _uniform(gen, shape, 1.0 / (shape[0] ** 0.5))


def fan_in_uniform_linear_init(
    gen: torch.Generator, in_dim: int, out_dim: int, *, bias: bool = True
) -> dict:
    """Linear with torch-default weight AND bias init (both U(+-1/sqrt(fan_in)))."""
    bound = 1.0 / (in_dim**0.5)
    params = {"w": _uniform(gen, (in_dim, out_dim), bound)}
    if bias:
        params["b"] = _uniform(gen, (out_dim,), bound)
    return params


def linear_init(
    gen: torch.Generator,
    in_dim: int,
    out_dim: int,
    *,
    bias: bool = True,
    w_init: Initializer = trunc_normal_init,
) -> dict:
    """Linear layer params: ``{"w": [in, out], "b": [out]?}``; bias zero-init."""
    params = {"w": w_init(gen, (in_dim, out_dim))}
    if bias:
        params["b"] = torch.zeros((out_dim,), dtype=torch.float32)
    return params


def linear(params: dict, x: Tensor) -> Tensor:
    """Apply a linear layer in the dtype of ``x`` (params cast on use)."""
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


@dataclass(frozen=True)
class InitPolicy:
    """Pluggable per-site init."""

    attn_in: Initializer = trunc_normal_init
    attn_out: Initializer = trunc_normal_init
    mlp_in: Initializer = trunc_normal_init
    mlp_out: Initializer = trunc_normal_init
    linear: Initializer = trunc_normal_init


DEFAULT_INIT_POLICY = InitPolicy()
