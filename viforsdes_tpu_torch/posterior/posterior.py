"""Final posterior artifact: sampling and summaries.

PyTorch twin of the sampling part of ``viforsdes_tpu/posterior/posterior.py``:
``sample(n)`` draws theta ~ q and paths from the EMA weights in fp32, in
chunks of ``SAMPLE_CHUNK`` (one huge batch would hold encoder activations of
``[n, n_grid, mlp_hidden]``), returned in constrained x-space; ``summary(n)``
gives theta mean/std/quantiles and the path mean/std. Sampling runs without
autograd, so the path kernel runs forward only and stashes nothing. Save,
load, plot and diagnostics are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from viforsdes_tpu_torch.core.observations import Observations
from viforsdes_tpu_torch.core.priors import Prior
from viforsdes_tpu_torch.core.state_space import StateSpace
from viforsdes_tpu_torch.inference.path_sampler import sample_diffusion_paths
from viforsdes_tpu_torch.inference.trainer import stream_seed
from viforsdes_tpu_torch.models.model import VariationalSDEPosterior

QUANTILE_LEVELS = (0.05, 0.25, 0.5, 0.75, 0.95)


@dataclass(frozen=True)
class VariationalPosteriorSamples:
    sde_parameters: Tensor
    diffusion_paths: Tensor


@dataclass(frozen=True)
class Quantiles:
    q05: Tensor
    q25: Tensor
    q50: Tensor
    q75: Tensor
    q95: Tensor


@dataclass
class VariationalPosteriorSummary:
    sde_parameter_mean: Tensor
    sde_parameter_std: Tensor
    sde_parameter_quantiles: Quantiles
    diffusion_path_mean: Tensor
    diffusion_path_std: Tensor


class VariationalPosterior:
    # Posterior draws are evaluated in chunks of this many paths.
    SAMPLE_CHUNK = 256

    def __init__(
        self,
        model: VariationalSDEPosterior,
        params: dict,
        ema_params: dict,
        prior: Prior,
        observations: Observations,
        time_horizon: float,
        time_step: float,
        state_space: StateSpace,
        evidence_lower_bound_history: list[float],
        *,
        x0: Tensor | None = None,
        seed: int = 0,
    ) -> None:
        self.model = model
        self.params = params
        self.ema_params = ema_params
        self.prior = prior
        self.observations = observations
        self.time_horizon = float(time_horizon)
        self.time_step = float(time_step)
        self.state_space = state_space
        self.evidence_lower_bound_history = evidence_lower_bound_history
        self.device = model.device
        if x0 is None:
            if observations.values.shape[-1] != model.head.state_dim:
                raise ValueError(
                    "obs_dim != state_dim: pass an explicit x0 (the x0 = values[0] "
                    "convention only covers full observation)"
                )
            x0 = observations.values[0]
        self._x0_single = torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        self._obs_values = observations.values.to(self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(stream_seed(seed, 2))

    @torch.no_grad()
    def _sample_chunk(self, n: int) -> tuple[Tensor, Tensor]:
        head = self.model.head
        theta_eps = torch.randn(
            (n, self.model.theta_posterior.sde_param_dim), generator=self._gen, device=self.device
        )
        noise = torch.randn(
            (self.model.encoder.n_grid - 1, n, head.state_dim),
            generator=self._gen, device=self.device,
        )
        theta = self.model.theta_posterior.rsample(self.ema_params["theta"], theta_eps)
        sample = sample_diffusion_paths(
            self.model.encoder,
            head,
            self.ema_params,
            self._obs_values,
            theta,
            self._x0_single.expand(n, head.state_dim),
            self.time_step,
            self.state_space,
            noise,
            compute_dtype=torch.float32,  # evaluation runs at full precision
        )
        return theta, sample.x

    def sample(self, n: int) -> VariationalPosteriorSamples:
        thetas, xs = [], []
        done = 0
        while done < n:
            c = min(self.SAMPLE_CHUNK, n - done)
            theta, x = self._sample_chunk(c)
            thetas.append(theta)
            xs.append(x)
            done += c
        return VariationalPosteriorSamples(
            sde_parameters=torch.cat(thetas), diffusion_paths=torch.cat(xs)
        )

    def summary(self, n_samples: int = 1000) -> VariationalPosteriorSummary:
        samples = self.sample(n_samples)
        theta = samples.sde_parameters
        paths = samples.diffusion_paths
        levels = torch.tensor(QUANTILE_LEVELS, dtype=theta.dtype, device=theta.device)
        q = torch.quantile(theta, levels, dim=0)
        return VariationalPosteriorSummary(
            sde_parameter_mean=theta.mean(dim=0),
            sde_parameter_std=theta.std(dim=0),
            sde_parameter_quantiles=Quantiles(q05=q[0], q25=q[1], q50=q[2], q75=q[3], q95=q[4]),
            diffusion_path_mean=paths.mean(dim=0),
            diffusion_path_std=paths.std(dim=0),
        )
