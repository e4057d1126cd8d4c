"""Training loop for black-box variational inference of SDEs.

PyTorch twin of ``viforsdes_tpu/inference/trainer.py``. Per step: sample
theta ~ q (reparameterized), roll the diffusion paths, compute the ELBO, step
the guarded two-group AdamW on ``-ELBO``, update the EMA.

- Randomness: each step's draws come from a generator on the device seeded
  from ``(seed, step)``, so a step's numbers depend only on its index (the
  role of ``fold_in(base, step)``). ``_step_math`` takes the draws as
  arguments, so a test can inject the JAX package's.
- State: params, EMA and AdamW moments are flat fp32 buffers per parameter
  group (``optimizer.ParamLayout``); the model reads the tree as views.
- Host syncs: metrics stay on the device and are copied to the host
  asynchronously; the host reads them only at flush boundaries, leaving the
  newest step in flight.

Not ported yet (they raise): pretraining, checkpoint/resume, multi-device
meshes, and ``steps_per_call`` > 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import Tensor

from viforsdes_tpu_torch.config import EncoderConfig, HeadConfig, TrainingConfig
from viforsdes_tpu_torch.core.observations import (
    GaussianObservationLikelihood,
    ObservationLikelihood,
    Observations,
)
from viforsdes_tpu_torch.core.priors import Prior
from viforsdes_tpu_torch.core.sde import SDE
from viforsdes_tpu_torch.core.state_space import StateSpace
from viforsdes_tpu_torch.inference.constants import (
    MAX_CONSECUTIVE_NONFINITE_STEPS,
    OBS_VARIANCE_FLOOR,
)
from viforsdes_tpu_torch.inference.elbo import compute_evidence_lower_bound, observation_indices
from viforsdes_tpu_torch.inference.ema import ema_init, ema_update
from viforsdes_tpu_torch.inference.optimizer import GROUPS, ParamLayout, global_norm, make_optimizer
from viforsdes_tpu_torch.inference.path_sampler import sample_diffusion_paths
from viforsdes_tpu_torch.inference.types import EvidenceLowerBoundResult
from viforsdes_tpu_torch.models.model import VariationalSDEPosterior


class StepMetrics(NamedTuple):
    elbo: Tensor
    observation_log_prob: Tensor
    sde_log_prob: Tensor
    generative_log_prob: Tensor
    prior_log_prob: Tensor
    posterior_log_prob: Tensor
    grad_norm: Tensor
    param_means: Tensor
    # consecutive non-finite update steps; the host loop aborts past
    # MAX_CONSECUTIVE_NONFINITE_STEPS
    notfinite_count: Tensor


@dataclass
class TrainingState:
    """Final state returned by ``train``."""

    step: int
    evidence_lower_bound_history: list[float]
    best_evidence_lower_bound: float
    params: dict
    ema_params: dict


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; a CUDA device that is absent is an error, never a
    silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stream_seed(seed: int, stream: int, step: int = 0) -> int:
    """Seed of one random stream (0 = init, 1 = training steps, 2 = posterior
    sampling) at one step: a function of its arguments only."""
    return int(np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0] >> 1)


# (theta eps [n_theta, P], path noise [T, B, D]) for one microbatch
Draws = tuple[Tensor, Tensor]


class VariationalInferenceTrainer:
    def __init__(
        self,
        sde: SDE,
        observations: Observations,
        observation_likelihood: ObservationLikelihood,
        prior: Prior,
        time_horizon: float,
        config: TrainingConfig,
        encoder_config: EncoderConfig,
        head_config: HeadConfig,
        state_positive_dims: list[int],
        sde_param_positive_dims: list[int],
        *,
        sde_param_init_mean: Tensor | None = None,
        sde_param_init_std: float = 1.0,
        seed: int = 0,
        device: torch.device | str = "cuda",
        x0: Tensor | None = None,
    ) -> None:
        if config.steps_per_call > 1:
            raise NotImplementedError(
                "steps_per_call > 1 (several steps per dispatch, a CUDA graph in "
                "the port) is not ported yet; use 0 or 1"
            )
        self.device = resolve_device(device)
        self.sde = sde
        self.observations = observations
        self.observation_likelihood = observation_likelihood
        self.prior = prior
        self.time_horizon = float(time_horizon)
        self.config = config
        self.seed = seed
        self.state_space = StateSpace(sde.state_dim, state_positive_dims)
        self.sde_param_positive_dims = list(sde_param_positive_dims)

        self.model = VariationalSDEPosterior(
            observation_dim=observations.values.shape[-1],
            state_dim=sde.state_dim,
            sde_param_dim=sde.sde_param_dim,
            encoder_config=encoder_config,
            head_config=head_config,
            sde_param_positive_dims=self.sde_param_positive_dims,
            obs_times=np.asarray(observations.times),
            time_horizon=self.time_horizon,
            time_step=config.time_step,
            theta_full_covariance=config.theta_full_covariance,
            device=self.device,
        )
        self.n_steps = self.model.encoder.n_grid - 1
        self.obs_indices = torch.as_tensor(
            observation_indices(np.asarray(observations.times), config.time_step, self.n_steps),
            device=self.device,
        )
        self.obs_values = observations.values.to(self.device)

        init_gen = torch.Generator().manual_seed(stream_seed(seed, 0))
        tree = self.model.init(
            init_gen,
            sde_param_init_mean=sde_param_init_mean,
            sde_param_init_std=sde_param_init_std,
        )
        if config.learn_obs_variance:
            if not isinstance(observation_likelihood, GaussianObservationLikelihood):
                raise ValueError("learn_obs_variance requires a GaussianObservationLikelihood")
            if observation_likelihood.variance <= OBS_VARIANCE_FLOOR:
                raise ValueError(
                    f"learn_obs_variance: initial variance must exceed the "
                    f"floor {OBS_VARIANCE_FLOOR}"
                )
            tree["obs"] = {
                "log_variance": torch.tensor(
                    np.log(observation_likelihood.variance - OBS_VARIANCE_FLOOR),
                    dtype=torch.float32,
                )
            }
        if config.obs_variance_final is not None:
            if not isinstance(observation_likelihood, GaussianObservationLikelihood):
                raise ValueError("obs_variance_final requires a GaussianObservationLikelihood")
            if config.obs_variance_final >= observation_likelihood.variance:
                raise ValueError(
                    "obs_variance_final must be below the likelihood's claimed "
                    "variance (the anneal only tightens the claim)"
                )
        self.layout = ParamLayout(tree)
        self.flat_params = self.layout.pack(tree, self.device)
        self.optimizer = make_optimizer(config)
        self.opt_state = self.optimizer.init(self.flat_params)
        self.flat_ema = ema_init(self.flat_params)

        if x0 is None:
            if observations.values.shape[-1] != sde.state_dim:
                raise ValueError(
                    "obs_dim != state_dim: pass an explicit x0 (the x0 = values[0] "
                    "convention only covers full observation)"
                )
            x0 = observations.values[0]
        self._x0_single = torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        self._train_gen = torch.Generator(device=self.device)

        self.step = 0
        self._completed_steps = 0
        self.evidence_lower_bound_history: list[float] = []
        self.best_evidence_lower_bound = float("-inf")

    # ------------------------------------------------------------- state

    @property
    def params(self) -> dict:
        """The params tree (views of the flat buffers)."""
        return self.layout.unpack(self.flat_params)

    @property
    def ema_params(self) -> dict:
        return self.layout.unpack(self.flat_ema)

    # ------------------------------------------------------------ train step

    def _annealed_obs_variance(self, step: int | None) -> float:
        """Claimed observation variance at ``step`` under the log-linear anneal
        (fp32 arithmetic, as the JAX package computes it); ``None`` is the
        final value, for evaluation after training."""
        vf = np.float32(self.config.obs_variance_final)
        if step is None:
            return float(vf)
        v0 = float(self.observation_likelihood.variance)
        t = np.clip(
            (np.float32(step) - np.float32(self.config.theta_warmup_steps))
            / np.float32(self.config.obs_variance_anneal_steps),
            np.float32(0.0),
            np.float32(1.0),
        )
        log_v = (np.float32(1.0) - t) * np.float32(np.log(v0)) + t * np.float32(np.log(float(vf)))
        return float(np.exp(np.float32(log_v), dtype=np.float32))

    def draws(self, step: int) -> list[Draws]:
        """The standard-normal draws of one training step, one pair per
        microbatch, from the device generator seeded by ``(seed, step)``."""
        self._train_gen.manual_seed(stream_seed(self.seed, 1, step))
        micro = self.config.batch_size // self.config.grad_accum_steps
        n_theta = micro // self.config.iw_samples
        out = []
        for _ in range(self.config.grad_accum_steps):
            theta_eps = torch.randn(
                (n_theta, self.sde.sde_param_dim), generator=self._train_gen, device=self.device
            )
            noise = torch.randn(
                (self.n_steps, micro, self.sde.state_dim),
                generator=self._train_gen, device=self.device,
            )
            out.append((theta_eps, noise))
        return out

    def _elbo_from_params(
        self, params: dict, theta_eps: Tensor, path_noise: Tensor, step: int | None = None
    ) -> EvidenceLowerBoundResult:
        """The ELBO of one microbatch from injected draws: ``theta_eps
        [B/iw, P]`` and time-major ``path_noise [T, B, D]``."""
        iw = self.config.iw_samples
        theta = self.model.theta_posterior.rsample(params["theta"], theta_eps)
        if iw > 1:
            # contiguous groups of iw paths per theta (the ELBO's IWAE groups)
            theta = torch.repeat_interleave(theta, iw, dim=0)
        batch_size = path_noise.shape[1]
        x0 = self._x0_single.expand(batch_size, self.sde.state_dim)
        sample = sample_diffusion_paths(
            self.model.encoder,
            self.model.head,
            params,
            self.obs_values,
            theta,
            x0,
            self.config.time_step,
            self.state_space,
            path_noise,
            compute_dtype=self.config.compute_dtype.value_dtype,
        )
        if self.config.obs_variance_final is not None:
            obs_variance = self._annealed_obs_variance(step)
        elif self.config.learn_obs_variance:
            obs_variance = OBS_VARIANCE_FLOOR + torch.exp(params["obs"]["log_variance"])
        else:
            obs_variance = None
        return compute_evidence_lower_bound(
            self.sde,
            self.observation_likelihood,
            self.prior,
            self.model.theta_posterior,
            params["theta"],
            theta,
            sample,
            self.config.time_step,
            obs_indices=self.obs_indices,
            obs_values=self.obs_values,
            iw_samples=iw,
            obs_variance=obs_variance,
        )

    def _step_math(
        self,
        params: dict[str, Tensor],
        opt_state: dict,
        ema: dict[str, Tensor],
        draws: Sequence[Draws],
        theta_scale: float | None = None,
        step: int | None = None,
    ) -> tuple[dict[str, Tensor], dict, dict[str, Tensor], StepMetrics]:
        """One optimizer step on flat group buffers, updated in place.
        ``draws`` holds one pair per microbatch (``grad_accum_steps``):
        averaging the microbatch gradients reproduces the full-batch gradient
        exactly, since IWAE groups never span microbatches. ``theta_scale``
        0.0 freezes the applied theta (and observation-variance) update during
        the warmup; ``step`` feeds the observation-variance anneal."""
        if self.config.obs_variance_final is not None and step is None:
            raise ValueError(
                "obs_variance_final is set: training steps must thread the "
                "step index into _step_math"
            )
        if len(draws) != self.config.grad_accum_steps:
            raise ValueError(f"expected {self.config.grad_accum_steps} draws, got {len(draws)}")
        grads: dict[str, Tensor] | None = None
        results: list[EvidenceLowerBoundResult] = []
        for theta_eps, path_noise in draws:
            leaves = {g: params[g].detach().requires_grad_() for g in GROUPS}
            result = self._elbo_from_params(
                self.layout.unpack(leaves), theta_eps, path_noise, step=step
            )
            g_micro = torch.autograd.grad(
                -result.evidence_lower_bound, [leaves[g] for g in GROUPS], allow_unused=True
            )
            g_micro = {
                g: torch.zeros_like(params[g]) if d is None else d
                for g, d in zip(GROUPS, g_micro)
            }
            grads = g_micro if grads is None else {g: grads[g] + g_micro[g] for g in GROUPS}
            results.append(_detach(result))
        accum = len(draws)
        if accum > 1:
            grads = {g: v / accum for g, v in grads.items()}
            result = _mean_results(results)
        else:
            result = results[0]

        grad_norm = global_norm(grads)
        updates = self.optimizer.update(grads, opt_state, params, grad_norm)
        if theta_scale is not None:
            updates["theta"] = updates["theta"] * theta_scale
        with torch.no_grad():
            for g in GROUPS:
                params[g].add_(updates[g])
            ema_update(ema, params)
            param_means = self.model.theta_posterior.expected_value(
                self.layout.unpack(params)["theta"]
            )
        metrics = StepMetrics(
            elbo=result.evidence_lower_bound,
            observation_log_prob=result.components.observation_log_prob,
            sde_log_prob=result.components.sde_log_prob,
            generative_log_prob=result.components.generative_log_prob,
            prior_log_prob=result.components.prior_log_prob,
            posterior_log_prob=result.components.posterior_log_prob,
            grad_norm=grad_norm,
            param_means=param_means,
            notfinite_count=opt_state["notfinite_count"].clone(),
        )
        return params, opt_state, ema, metrics

    def train_step(self, step: int) -> StepMetrics:
        """Run training step ``step`` on the trainer's state."""
        warmup = self.config.theta_warmup_steps
        theta_scale = (0.0 if step < warmup else 1.0) if warmup > 0 else None
        step_arg = step if self.config.obs_variance_final is not None else None
        self.flat_params, self.opt_state, self.flat_ema, metrics = self._step_math(
            self.flat_params, self.opt_state, self.flat_ema, self.draws(step),
            theta_scale, step=step_arg,
        )
        self.step = step
        self._completed_steps = step + 1
        return metrics

    # ----------------------------------------------------------------- train

    def train(
        self,
        callback: Callable[[int, float], None] | None = None,
        *,
        update_interval: int = 10,
        checkpoint_every: int | None = None,
        checkpoint_path=None,
    ) -> TrainingState:
        if checkpoint_every is not None or checkpoint_path is not None:
            raise NotImplementedError("trainer checkpoints are not ported yet")
        # (first step, host copy of the packed metrics, event marking the copy)
        pending: list[tuple[int, Tensor, torch.cuda.Event | None]] = []

        def flush(keep_last: int = 0) -> None:
            """Read pending metrics on the host. ``keep_last=1`` leaves the
            newest step's copy unread, so the device keeps working on it while
            the host catches up."""
            if len(pending) <= keep_last:
                return
            take = pending[: len(pending) - keep_last]
            del pending[: len(take)]
            if take[-1][2] is not None:
                take[-1][2].synchronize()
            worst = 0
            for step, host, _ in take:
                row = host.tolist()
                elbo = row[0]
                self.evidence_lower_bound_history.append(elbo)
                if elbo > self.best_evidence_lower_bound:
                    self.best_evidence_lower_bound = elbo
                if callback is not None:
                    callback(step, elbo)
                worst = max(worst, int(row[7]))
            if worst >= MAX_CONSECUTIVE_NONFINITE_STEPS:
                raise RuntimeError(
                    f"training diverged: {worst} consecutive non-finite update "
                    f"steps by step {take[-1][0]} (params remain at their last "
                    f"finite values)"
                )

        for step in range(self._completed_steps, self.config.n_iterations):
            metrics = self.train_step(step)
            packed = torch.cat([torch.stack([v.float() for v in metrics[:7]]),
                                metrics.notfinite_count.float()[None],
                                metrics.param_means.float()])
            if packed.is_cuda:
                host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                host.copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                pending.append((step, host, event))
            else:
                pending.append((step, packed, None))
            if (step + 1) % update_interval == 0:
                flush(keep_last=1)
        flush()

        return TrainingState(
            step=self.step,
            evidence_lower_bound_history=self.evidence_lower_bound_history,
            best_evidence_lower_bound=self.best_evidence_lower_bound,
            params=self.params,
            ema_params=self.ema_params,
        )


def _detach(result: EvidenceLowerBoundResult) -> EvidenceLowerBoundResult:
    return EvidenceLowerBoundResult(
        evidence_lower_bound=result.evidence_lower_bound.detach(),
        components=type(result.components)(*(c.detach() for c in result.components)),
    )


def _mean_results(results: list[EvidenceLowerBoundResult]) -> EvidenceLowerBoundResult:
    n = len(results)
    total = results[0]
    for r in results[1:]:
        total = EvidenceLowerBoundResult(
            evidence_lower_bound=total.evidence_lower_bound + r.evidence_lower_bound,
            components=type(r.components)(*(a + b for a, b in zip(total.components, r.components))),
        )
    return EvidenceLowerBoundResult(
        evidence_lower_bound=total.evidence_lower_bound / n,
        components=type(total.components)(*(c / n for c in total.components)),
    )
