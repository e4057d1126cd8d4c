"""Functional glue: encoder -> head roll-out (twin of
``viforsdes_tpu/inference/path_sampler.py``).

Runs the encoder over the grid, maps ``x0 -> z0``, rolls the head over
``context[:, :-1]`` with the caller's standard-normal noise (time-major
``[T, B, D]``), and wraps the result. ``sde`` is read only by the
diffusion-matched head (``cholesky="matched"``), whose recurrence evaluates
the SDE's diffusion.
"""

from __future__ import annotations

import torch
from torch import Tensor

from viforsdes_tpu_torch.core.state_space import StateSpace
from viforsdes_tpu_torch.inference.types import DiffusionPathSample
from viforsdes_tpu_torch.models.encoder import ObservationContextEncoder
from viforsdes_tpu_torch.models.head import DiffusionTransitionHead


def sample_diffusion_paths(
    encoder: ObservationContextEncoder,
    head: DiffusionTransitionHead,
    params: dict,
    obs_values: Tensor,
    sde_parameters: Tensor,
    x0: Tensor,
    time_step: float,
    state_space: StateSpace,
    noise: Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    sde=None,
) -> DiffusionPathSample:
    context = encoder(
        params["encoder"], obs_values, sde_parameters, compute_dtype=compute_dtype
    )
    paths, transition_means, transition_cholesky = head.sample_diffusion_paths(
        params["head"],
        state_space.to_latent(x0),
        context[:, :-1],
        sde_parameters,
        noise,
        time_step,
        sde=sde,
        state_space=state_space,
    )
    return DiffusionPathSample(
        z=paths,
        transition_means=transition_means,
        transition_cholesky=transition_cholesky,
        state_space=state_space,
    )
