"""Observation records and observation likelihoods.

PyTorch twin of ``viforsdes_tpu/core/observations.py``, with the same
validation. Times stay host float64 numpy: they are static grid metadata
(slot indices, validation), and fp32 times past 16.2 break the 1e-6
grid-alignment tolerance. Values are fp32 ``torch`` tensors on the CPU; the
trainer moves them, and a likelihood's ``obs_matrix``, to its device once.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from pydantic import BaseModel, ConfigDict, field_validator, model_validator
from torch import Tensor
from typing_extensions import Protocol, Self, runtime_checkable


def _as_f32_tensor(value) -> Tensor:
    if isinstance(value, Tensor):
        return value.to(torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32, copy=True))


class Observations(BaseModel):
    """Frozen record of observation times and values.

    times:  [T_obs]           (non-decreasing, host float64)
    values: [T_obs, obs_dim]  (fp32 tensor)
    """

    model_config = ConfigDict(frozen=True, arbitrary_types_allowed=True)

    times: np.ndarray
    values: Tensor

    @model_validator(mode="before")
    @classmethod
    def _coerce(cls, data: dict) -> dict:
        if isinstance(data, dict):
            if "times" in data:
                data["times"] = np.asarray(data["times"], dtype=np.float64)
            if "values" in data:
                data["values"] = _as_f32_tensor(data["values"])
        return data

    @model_validator(mode="after")
    def validate_shapes_and_order(self) -> Self:
        if self.times.ndim != 1:
            raise ValueError("times must be 1D array")
        if self.values.ndim != 2:
            raise ValueError("values must be 2D array [T_obs, obs_dim]")
        if self.times.shape[0] != self.values.shape[0]:
            raise ValueError(
                f"times and values must have same first dimension: "
                f"got {self.times.shape[0]} vs {self.values.shape[0]}"
            )
        t = self.times
        if not np.all(t[1:] >= t[:-1]):
            raise ValueError("times must be sorted in non-decreasing order")
        return self


@runtime_checkable
class ObservationLikelihood(Protocol):
    """Protocol for p(y | x) terms."""

    def log_prob(self, observations: Tensor, state: Tensor) -> Tensor: ...


class GaussianObservationLikelihood(BaseModel):
    """Isotropic Gaussian observation model with optional linear operator:
    ``log N(y; Hx, var·I)`` summed over the observation dimension; ``obs_matrix``
    H is ``[obs_dim, state_dim]`` for partial observation, identity otherwise."""

    model_config = ConfigDict(frozen=True, arbitrary_types_allowed=True)

    variance: float
    obs_matrix: Tensor | None = None

    @model_validator(mode="before")
    @classmethod
    def _coerce(cls, data: dict) -> dict:
        if isinstance(data, dict) and data.get("obs_matrix") is not None:
            data["obs_matrix"] = _as_f32_tensor(data["obs_matrix"])
        return data

    @field_validator("variance")
    @classmethod
    def validate_variance(cls, v: float) -> float:
        if v <= 0:
            raise ValueError("variance must be positive")
        return v

    def log_prob(
        self,
        observations: Tensor,
        state: Tensor,
        *,
        variance: Tensor | float | None = None,
    ) -> Tensor:
        """``variance`` overrides the configured scalar; a tensor that needs
        grad is how the learnable observation variance trains."""
        if self.obs_matrix is not None:
            if self.obs_matrix.ndim != 2:
                raise ValueError("obs_matrix must be 2D [obs_dim, state_dim]")
            if self.obs_matrix.shape[0] != observations.shape[-1]:
                raise ValueError("obs_matrix first dim must match observations")
            if self.obs_matrix.shape[1] != state.shape[-1]:
                raise ValueError("obs_matrix second dim must match state")
            predicted = torch.einsum("od,...d->...o", self.obs_matrix, state)
        else:
            predicted = state

        if observations.shape != predicted.shape:
            raise ValueError(
                f"observation shape {tuple(observations.shape)} does not match "
                f"predicted shape {tuple(predicted.shape)}"
            )

        var = self.variance if variance is None else variance
        diff = observations - predicted
        if isinstance(var, Tensor):
            log_norm = 0.5 * torch.log(2 * math.pi * var)
        else:
            log_norm = 0.5 * math.log(2 * math.pi * var)
        log_prob = -0.5 * (diff**2) / var - log_norm
        return torch.sum(log_prob, dim=-1)
