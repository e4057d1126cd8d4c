"""Stochastic Lorenz-63 (a frozen copy of the SDE of
``examples_torch/lorenz63.py``): drift ``(sigma_L (x2 - x1), x1 (rho - x3) -
x2, x1 x2 - beta x3)``, constant diffusion ``2 I``."""

from __future__ import annotations

import torch
from torch import Tensor

NOISE_SCALE = 2.0


class StochasticLorenz63:
    state_dim = 3
    sde_param_dim = 3

    def drift(self, x: Tensor, p: Tensor) -> Tensor:
        sigma_l, rho, beta = p[..., 0], p[..., 1], p[..., 2]
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        return torch.stack([sigma_l * (x2 - x1), x1 * (rho - x3) - x2, x1 * x2 - beta * x3], dim=-1)

    def diffusion(self, x: Tensor, p: Tensor) -> Tensor:
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        return (NOISE_SCALE * eye).expand(*x.shape, 3)


SDE = StochasticLorenz63
