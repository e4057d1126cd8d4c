"""Priors over SDE parameters theta.

PyTorch twin of ``viforsdes_tpu/core/priors.py``: scalar mean/std broadcast to
``dim`` i.i.d. Normal or LogNormal marginals, ``log_prob`` summed over dims.
"""

from __future__ import annotations

import math
from enum import Enum, auto

import torch
from pydantic import BaseModel, ConfigDict, field_validator
from torch import Tensor

_LOG_2PI = math.log(2.0 * math.pi)


def normal_log_prob(x: Tensor, mean, std) -> Tensor:
    """Elementwise log N(x; mean, std^2)."""
    z = (x - mean) / std
    log_std = torch.log(std) if isinstance(std, Tensor) else math.log(std)
    return -0.5 * (z * z) - log_std - 0.5 * _LOG_2PI


def lognormal_log_prob(x: Tensor, mean, std) -> Tensor:
    """Elementwise log LogNormal(x; mean, std^2) = log N(log x) - log x."""
    log_x = torch.log(x)
    return normal_log_prob(log_x, mean, std) - log_x


class PriorType(Enum):
    NORMAL = auto()
    LOG_NORMAL = auto()


class Prior(BaseModel):
    """i.i.d. Normal/LogNormal prior over theta."""

    model_config = ConfigDict(frozen=True)

    type: PriorType
    mean: float
    std: float
    dim: int

    @field_validator("dim")
    @classmethod
    def dim_must_be_positive(cls, v: int) -> int:
        if v <= 0:
            raise ValueError("dim must be positive")
        return v

    @field_validator("std")
    @classmethod
    def std_must_be_positive(cls, v: float) -> float:
        if v <= 0:
            raise ValueError("std must be positive")
        return v

    def sample(self, generator: torch.Generator, n: int) -> Tensor:
        """Draw ``[n, dim]`` samples on the generator's device."""
        eps = torch.randn(
            (n, self.dim), generator=generator, device=generator.device
        )
        gauss = self.mean + self.std * eps
        if self.type == PriorType.LOG_NORMAL:
            return torch.exp(gauss)
        return gauss

    def log_prob(self, sde_parameters: Tensor) -> Tensor:
        """Log-density summed over the parameter dimension: ``[...,dim] -> [...]``."""
        if self.type == PriorType.LOG_NORMAL:
            lp = lognormal_log_prob(sde_parameters, self.mean, self.std)
        else:
            lp = normal_log_prob(sde_parameters, self.mean, self.std)
        return torch.sum(lp, dim=-1)
