"""Euler-Maruyama simulator of the true SDE (twin of
``viforsdes_tpu/core/solvers.py``).

Per step ``x += f(x, theta) dt + L(x, theta) eps sqrt(dt)``, with the listed
positive dims clamped at 1e-6 and ``n_steps = round(T / dt)``. The noise is
either given (``[B, n_steps, D]`` standard normals) or drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import Tensor

from viforsdes_tpu_torch.core.sde import SDE


def euler_maruyama(
    sde: SDE,
    x0: Tensor,
    theta: Tensor,
    time_horizon: float,
    dt: float,
    positive_dims: Sequence[int] = (),
    noise: Tensor | None = None,
    *,
    generator: torch.Generator | None = None,
) -> Tensor:
    """Simulate ``[B, n_steps+1, D]`` trajectories of the true SDE.

    Exactly one of ``noise`` or ``generator`` must be given; the generator
    draws on its own device, which must be ``x0``'s.
    """
    if dt <= 0:
        raise ValueError(f"dt must be positive, got {dt}")
    if time_horizon <= 0:
        raise ValueError(f"time_horizon must be positive, got {time_horizon}")
    n_steps = round(time_horizon / dt)
    sqrt_dt = dt**0.5
    batch, state_dim = x0.shape

    if noise is None:
        if generator is None:
            raise ValueError("provide either `noise` or `generator`")
        noise = torch.randn(
            (batch, n_steps, state_dim), generator=generator, dtype=x0.dtype, device=x0.device
        )

    positive = None
    if positive_dims:
        positive = torch.zeros(state_dim, dtype=torch.bool, device=x0.device)
        positive[list(positive_dims)] = True

    x = x0
    traj = [x0]
    for t in range(n_steps):
        x = x + sde.drift(x, theta) * dt + torch.einsum(
            "bij,bj->bi", sde.diffusion(x, theta), noise[:, t]
        ) * sqrt_dt
        if positive is not None:
            x = torch.where(positive, torch.clamp(x, min=1e-6), x)
        traj.append(x)
    return torch.stack(traj, dim=1)
