"""Independent Ornstein-Uhlenbeck processes in 32 dimensions with shared
(kappa, mu, sigma) (a frozen copy of the SDE of
``examples_torch/highdim_ou_dp.py``): drift ``kappa (mu - x)``, diffusion
``sigma I``."""

from __future__ import annotations

import torch
from torch import Tensor

STATE_DIM = 32


class HighDimOU:
    state_dim = STATE_DIM
    sde_param_dim = 3

    def drift(self, x: Tensor, p: Tensor) -> Tensor:
        return p[..., 0:1] * (p[..., 1:2] - x)

    def diffusion(self, x: Tensor, p: Tensor) -> Tensor:
        eye = torch.eye(STATE_DIM, dtype=x.dtype, device=x.device)
        return p[..., 2:3][..., None] * eye


SDE = HighDimOU
