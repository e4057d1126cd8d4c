"""Top-level inference entry point (twin of ``viforsdes_tpu/infer.py``).

``InferenceConfig`` composes the run; ``_InferenceInputs`` front-loads the
validation (the grid-alignment rules are load-bearing for the encoder's
observation slots and the ELBO's observation indices); ``infer`` builds the
trainer, resumes it from a checkpoint or pretrains the theta mean, trains
(writing checkpoints if asked), and returns the ``VariationalPosterior``.

``device`` (default ``"cuda"``; a missing GPU raises, it never falls back to
the CPU) is the port's own field. ``mesh`` (``make_data_mesh``) trains data
parallel, one process per rank, with ``batch_size`` the global batch; the
trainer then runs on the rank's mesh device, and a ``device`` that names
another device raises. Every rank returns the same posterior.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from pydantic import BaseModel, ConfigDict, model_validator
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh
from typing_extensions import Self

from viforsdes_tpu_torch.config import (
    EncoderConfig,
    HeadConfig,
    PretrainConfig,
    TrainingConfig,
)
from viforsdes_tpu_torch.core.observations import ObservationLikelihood, Observations
from viforsdes_tpu_torch.core.priors import Prior
from viforsdes_tpu_torch.core.sde import SDE
from viforsdes_tpu_torch.core.state_space import StateSpace
from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer
from viforsdes_tpu_torch.posterior.posterior import VariationalPosterior
from viforsdes_tpu_torch.utils.console import Console


@dataclass(frozen=True)
class InferenceConfig:
    training: TrainingConfig = field(default_factory=TrainingConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    state_positive_dims: list[int] = field(default_factory=list)
    sde_param_positive_dims: list[int] = field(default_factory=list)
    param_names: list[str] | None = None
    sde_param_init_mean: Tensor | None = None
    sde_param_init_std: float = 1.0
    pretrain: bool | PretrainConfig = False
    console: Console | None = None
    seed: int = 0
    mesh: DeviceMesh | None = None
    device: torch.device | str = "cuda"
    x0: Tensor | None = None
    # per-step callback(step, elbo); a trainer checkpoint every
    # checkpoint_every completed steps into checkpoint_path
    callback: Callable[[int, float], None] | None = None
    checkpoint_every: int | None = None
    checkpoint_path: str | Path | None = None
    # continue an interrupted run from a trainer checkpoint (pretraining is
    # skipped: the checkpointed params hold it); the rest of the config must
    # be the original run's
    resume_from: str | Path | None = None


class _InferenceInputs(BaseModel):
    """Input validation (rules of ``viforsdes_tpu/infer.py``, verbatim)."""

    model_config = ConfigDict(frozen=True, arbitrary_types_allowed=True)

    observations: Observations
    time_horizon: float
    time_step: float
    state_dim: int
    sde_param_dim: int
    state_positive_dims: list[int]
    sde_param_positive_dims: list[int]
    prior: Prior

    @model_validator(mode="after")
    def validate_inputs(self) -> Self:
        if self.time_horizon <= 0:
            raise ValueError("time_horizon must be positive")
        if self.time_step <= 0:
            raise ValueError("time_step must be positive")
        times = np.asarray(self.observations.times)
        if times.size == 0:
            raise ValueError("observations must be non-empty")
        ratio = self.time_horizon / self.time_step
        n_steps = round(ratio)
        if not math.isclose(ratio, n_steps, rel_tol=1e-6, abs_tol=1e-6):
            raise ValueError("time_horizon must be an integer multiple of time_step")
        tol = max(1e-6, 1e-4 * self.time_step)
        if abs(float(times[0])) > tol:
            raise ValueError("first observation time must be 0")
        aligned = np.round(times / self.time_step) * self.time_step
        if np.any(np.abs(aligned - times) > tol):
            raise ValueError("observation times must align to time_step grid")
        if np.any(times < 0) or np.any(times > self.time_horizon):
            raise ValueError("observation times must be within [0, time_horizon]")
        if len(set(self.state_positive_dims)) != len(self.state_positive_dims):
            raise ValueError("state_positive_dims must be unique")
        if len(set(self.sde_param_positive_dims)) != len(self.sde_param_positive_dims):
            raise ValueError("sde_param_positive_dims must be unique")
        if any(d < 0 or d >= self.state_dim for d in self.state_positive_dims):
            raise ValueError("state_positive_dims must be within [0, state_dim)")
        if any(d < 0 or d >= self.sde_param_dim for d in self.sde_param_positive_dims):
            raise ValueError(
                "sde_param_positive_dims must be within [0, sde_param_dim)"
            )
        if self.prior.dim != self.sde_param_dim:
            raise ValueError("prior dim must match sde_param_dim")
        return self


def infer(
    sde: SDE,
    observations: Observations,
    observation_likelihood: ObservationLikelihood,
    prior: Prior,
    time_horizon: float,
    config: InferenceConfig | None = None,
) -> VariationalPosterior:
    """Run black-box variational inference; returns the trained posterior."""
    cfg = config or InferenceConfig()

    inputs = _InferenceInputs(
        observations=observations,
        time_horizon=time_horizon,
        time_step=cfg.training.time_step,
        state_dim=sde.state_dim,
        sde_param_dim=sde.sde_param_dim,
        state_positive_dims=list(cfg.state_positive_dims),
        sde_param_positive_dims=list(cfg.sde_param_positive_dims),
        prior=prior,
    )

    trainer = VariationalInferenceTrainer(
        sde=sde,
        observations=inputs.observations,
        observation_likelihood=observation_likelihood,
        prior=prior,
        time_horizon=inputs.time_horizon,
        config=cfg.training,
        encoder_config=cfg.encoder,
        head_config=cfg.head,
        state_positive_dims=inputs.state_positive_dims,
        sde_param_positive_dims=inputs.sde_param_positive_dims,
        console=cfg.console,
        param_names=cfg.param_names,
        sde_param_init_mean=cfg.sde_param_init_mean,
        sde_param_init_std=cfg.sde_param_init_std,
        seed=cfg.seed,
        mesh=cfg.mesh,
        device=cfg.device,
        x0=cfg.x0,
    )
    if cfg.resume_from is not None:
        trainer.restore_checkpoint(cfg.resume_from)
    elif cfg.pretrain and cfg.sde_param_init_mean is None:
        pretrain_config = cfg.pretrain if isinstance(cfg.pretrain, PretrainConfig) else None
        trainer.set_theta_mean(trainer.pretrain_sde_parameters(pretrain_config))

    state = trainer.train(
        callback=cfg.callback,
        checkpoint_every=cfg.checkpoint_every,
        checkpoint_path=cfg.checkpoint_path,
    )

    return VariationalPosterior(
        model=trainer.model,
        params=state.params,
        ema_params=state.ema_params,
        prior=prior,
        observations=inputs.observations,
        time_horizon=inputs.time_horizon,
        time_step=cfg.training.time_step,
        state_space=StateSpace(sde.state_dim, inputs.state_positive_dims),
        evidence_lower_bound_history=state.evidence_lower_bound_history,
        x0=cfg.x0,
        seed=cfg.seed,
        sde=sde,
    )
