"""Final posterior artifact: sampling, summaries, diagnostics, plotting,
save/load.

PyTorch twin of ``viforsdes_tpu/posterior/posterior.py``:

- ``sample(n)`` draws theta ~ q and paths from the EMA weights in fp32, in
  chunks of ``SAMPLE_CHUNK`` (one huge batch would hold encoder activations
  of ``[n, n_grid, mlp_hidden]``), returned in constrained x-space. Sampling
  runs without autograd, so the path kernel runs forward only and stashes
  nothing;
- ``summary(n)``: theta mean/std/quantiles and the path mean/std;
- ``diagnostics()``: the ELBO history; ``observation_variance()``: the
  learned observation variance; ``plot()``: a matplotlib figure;
- ``save()``/``load()``: params and EMA params with the grid settings,
  positive dims, ELBO history and x0, in the ``.npz`` format both packages
  read. Unlike the JAX package's ``load``, the port's keeps a learned
  observation variance (the ``obs`` leaf) when the archive holds one.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch
from torch import Tensor

from viforsdes_tpu_torch.core.observations import Observations
from viforsdes_tpu_torch.core.priors import Prior
from viforsdes_tpu_torch.core.state_space import StateSpace
from viforsdes_tpu_torch.inference.constants import OBS_VARIANCE_FLOOR
from viforsdes_tpu_torch.inference.path_sampler import sample_diffusion_paths
from viforsdes_tpu_torch.inference.trainer import stream_seed
from viforsdes_tpu_torch.models.model import VariationalSDEPosterior
from viforsdes_tpu_torch.utils.pytree_io import load_checkpoint, read_archive, save_checkpoint
from viforsdes_tpu_torch.utils.tree import tree_map
from viforsdes_tpu_torch.utils.visualization import plot_posterior

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


@dataclass
class InferenceDiagnostics:
    evidence_lower_bound_history: list[float]
    final_evidence_lower_bound: float
    n_iterations: int


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
        sde=None,
    ) -> None:
        # kept for the API of the JAX package, whose matched head mode
        # samples with the SDE's diffusion (not ported: the head refuses it)
        self.sde = sde
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

    def observation_variance(self) -> float | None:
        """Learned observation variance (``TrainingConfig.learn_obs_variance``)
        from the EMA weights; None when the likelihood variance was fixed."""
        obs = self.ema_params.get("obs")
        if obs is None:
            return None
        return float(OBS_VARIANCE_FLOOR + torch.exp(obs["log_variance"]))

    def diagnostics(self) -> InferenceDiagnostics:
        history = self.evidence_lower_bound_history
        return InferenceDiagnostics(
            evidence_lower_bound_history=history,
            final_evidence_lower_bound=history[-1] if history else float("nan"),
            n_iterations=len(history),
        )

    def plot(self, n_trajectories: int = 50, show: bool = True):
        samples = self.sample(n_trajectories)
        return plot_posterior(samples, self.observations, self.time_horizon, show)

    # ------------------------------------------------------------ checkpoint

    def save(self, path: str | Path) -> None:
        save_checkpoint(
            path,
            trees={"model_state": self.params, "ema_state": self.ema_params},
            metadata={
                "time_horizon": self.time_horizon,
                "time_step": self.time_step,
                "state_positive_dims": list(self.state_space.positive_dims),
                "evidence_lower_bound_history": [float(v) for v in self.evidence_lower_bound_history],
                # a reloaded partial-observation posterior needs its x0
                "x0": self._x0_single.cpu().tolist(),
            },
        )

    @classmethod
    def load(
        cls,
        path: str | Path,
        model: VariationalSDEPosterior,
        prior: Prior,
        observations: Observations,
        *,
        init_key: torch.Generator | None = None,
        sde=None,
    ) -> "VariationalPosterior":
        """A posterior from ``save`` (of either package) on ``model``'s
        device. The template is ``model.init(init_key)``, plus the learned
        observation variance's leaf when the archive holds one."""
        template = model.init(init_key if init_key is not None else torch.Generator().manual_seed(0))
        flat, _ = read_archive(path)
        if "model_state/obs/log_variance" in flat:
            template["obs"] = {"log_variance": torch.zeros((), dtype=torch.float32)}
        trees, meta = load_checkpoint(
            path,
            templates={"model_state": template, "ema_state": template},
            required_metadata=(
                "time_horizon",
                "time_step",
                "state_positive_dims",
                "evidence_lower_bound_history",
            ),
            kind="VariationalPosterior",
        )
        x0 = meta.get("x0")
        params, ema = (tree_map(lambda t: t.to(model.device), trees[k]) for k in ("model_state", "ema_state"))
        return cls(
            model=model,
            params=params,
            ema_params=ema,
            prior=prior,
            observations=observations,
            time_horizon=meta["time_horizon"],
            time_step=meta["time_step"],
            state_space=StateSpace(model.head.state_dim, meta["state_positive_dims"]),
            evidence_lower_bound_history=meta["evidence_lower_bound_history"],
            x0=None if x0 is None else torch.tensor(x0, dtype=torch.float32),
            sde=sde,
        )
