"""Model container: encoder + transition head + theta posterior (twin of
``viforsdes_tpu/models/model.py``). Static configuration lives here; the
learnable state is the params tree ``{"encoder", "head", "theta"}``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from viforsdes_tpu_torch.config import EncoderConfig, HeadConfig
from viforsdes_tpu_torch.models.encoder import ObservationContextEncoder
from viforsdes_tpu_torch.models.head import DiffusionTransitionHead
from viforsdes_tpu_torch.models.theta_posterior import ThetaPosterior


class VariationalSDEPosterior:
    def __init__(
        self,
        observation_dim: int,
        state_dim: int,
        sde_param_dim: int,
        encoder_config: EncoderConfig,
        head_config: HeadConfig,
        sde_param_positive_dims: list[int],
        *,
        obs_times: np.ndarray,
        time_horizon: float,
        time_step: float,
        theta_full_covariance: bool = False,
        device: torch.device,
    ) -> None:
        self.device = device
        self.encoder = ObservationContextEncoder.build(
            observation_dim,
            sde_param_dim,
            encoder_config,
            obs_times=obs_times,
            time_horizon=time_horizon,
            time_step=time_step,
            device=device,
        )
        self.head = DiffusionTransitionHead(
            state_dim=state_dim,
            context_dim=encoder_config.hidden_dim,
            sde_param_dim=sde_param_dim,
            config=head_config,
        )
        self.theta_posterior = ThetaPosterior(
            sde_param_dim,
            sde_param_positive_dims,
            full_covariance=theta_full_covariance,
            device=device,
        )

    def init(
        self,
        gen: torch.Generator,
        *,
        sde_param_init_mean: Tensor | None = None,
        sde_param_init_std: float = 1.0,
    ) -> dict:
        """A fresh params tree on the CPU, drawn from the CPU generator ``gen``."""
        return {
            "encoder": self.encoder.init(gen),
            "head": self.head.init(gen),
            "theta": self.theta_posterior.init(
                init_mean=sde_param_init_mean, init_std=sde_param_init_std
            ),
        }
