"""Variational posterior q(theta): Gaussian in unconstrained space (diagonal by
default, optionally full-covariance), log-normal marginals for
positive-constrained dims.

PyTorch twin of ``viforsdes_tpu/models/theta_posterior.py``. ``rsample`` takes
its standard-normal draws from the caller, so a test can feed both packages
the same numbers.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from viforsdes_tpu_torch.core.priors import lognormal_log_prob, normal_log_prob

_LOG_2PI = math.log(2.0 * math.pi)


class ThetaPosterior:
    """Static config wrapper; all methods are pure functions of ``params``."""

    def __init__(
        self,
        sde_param_dim: int,
        positive_dims: list[int],
        *,
        full_covariance: bool = False,
        device: torch.device,
    ) -> None:
        if sde_param_dim < 1:
            raise ValueError(f"sde_param_dim must be >= 1, got {sde_param_dim}")
        if any(d < 0 or d >= sde_param_dim for d in positive_dims):
            raise ValueError(f"sde_param_positive_dims must be in [0, {sde_param_dim})")
        self.sde_param_dim = sde_param_dim
        self.positive_dims = list(positive_dims)
        self.full_covariance = bool(full_covariance)
        mask = torch.zeros(sde_param_dim, dtype=torch.bool)
        mask[self.positive_dims] = True
        self.positive_mask = mask.to(device)

    def init(self, init_mean: Tensor | None = None, init_std: float = 1.0) -> dict:
        if init_std <= 0:
            raise ValueError(f"init_std must be positive, got {init_std}")
        mean = (
            torch.as_tensor(init_mean, dtype=torch.float32).clone()
            if init_mean is not None
            else torch.zeros(self.sde_param_dim, dtype=torch.float32)
        )
        params = {
            "mean": mean,
            "log_std": torch.full((self.sde_param_dim,), math.log(init_std), dtype=torch.float32),
        }
        if self.full_covariance:
            # strictly-lower coupling, zero-init: starts at diagonal parity
            params["tril"] = torch.zeros(
                (self.sde_param_dim, self.sde_param_dim), dtype=torch.float32
            )
        return params

    def _scale_tril(self, params: dict) -> Tensor:
        """Cholesky factor of the unconstrained-space covariance."""
        L = torch.diag(torch.exp(params["log_std"]))
        if self.full_covariance:
            L = L + torch.tril(params["tril"], diagonal=-1)
        return L

    def rsample(self, params: dict, eps: Tensor) -> Tensor:
        """Reparameterized draws ``[n, P]`` from standard-normal ``eps [n, P]``."""
        if self.full_covariance:
            z = params["mean"] + eps @ self._scale_tril(params).T
        else:
            z = params["mean"] + torch.exp(params["log_std"]) * eps
        return torch.where(self.positive_mask, torch.exp(z), z)

    def log_prob(self, params: dict, theta: Tensor) -> Tensor:
        """``[..., P] -> [...]``: density of theta under the Gaussian in
        unconstrained space with the exp-transform Jacobian on positive dims."""
        mean = params["mean"]
        # double-where: the log sees a safe positive value on masked-out dims
        # so its NaNs cannot leak into gradients through where
        safe_theta = torch.where(
            self.positive_mask, torch.clamp(theta, min=1e-38), torch.ones_like(theta)
        )
        if not self.full_covariance:
            std = torch.exp(params["log_std"])
            lp = torch.where(
                self.positive_mask,
                lognormal_log_prob(safe_theta, mean, std),
                normal_log_prob(theta, mean, std),
            )
            return torch.sum(lp, dim=-1)
        log_theta = torch.log(safe_theta)
        z = torch.where(self.positive_mask, log_theta, theta)
        L = self._scale_tril(params)
        y = torch.linalg.solve_triangular(
            L.expand(z.shape[:-1] + L.shape), (z - mean)[..., None], upper=False
        )[..., 0]
        log_det = torch.sum(params["log_std"])
        mvn = -0.5 * torch.sum(y * y, dim=-1) - log_det - 0.5 * self.sde_param_dim * _LOG_2PI
        jacobian = torch.sum(
            torch.where(self.positive_mask, log_theta, torch.zeros_like(log_theta)), dim=-1
        )
        return mvn - jacobian

    def expected_value(self, params: dict) -> Tensor:
        mean = params["mean"]
        if self.full_covariance:
            L = self._scale_tril(params)
            var = torch.sum(L * L, dim=-1)  # diag of L L^T
        else:
            std = torch.exp(params["log_std"])
            var = std * std
        return torch.where(self.positive_mask, torch.exp(mean + 0.5 * var), mean)
