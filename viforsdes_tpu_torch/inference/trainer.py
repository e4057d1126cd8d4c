"""Training loop for black-box variational inference of SDEs.

PyTorch twin of ``viforsdes_tpu/inference/trainer.py``. Per step: sample
theta ~ q (reparameterized), roll the diffusion paths, compute the ELBO, step
the guarded two-group AdamW on ``-ELBO``, update the EMA.

- Randomness: each step's draws come from a generator on the device seeded
  from ``(seed, step)``, so a step's numbers depend only on its index (the
  role of ``fold_in(base, step)``). ``_step_math`` takes the draws as
  arguments, so a test can inject the JAX package's.
- State: params, EMA and AdamW moments are flat fp32 buffers per parameter
  group (``optimizer.ParamLayout``); the model reads the tree as views. The
  buffers are updated in place, never replaced (a captured graph holds their
  addresses).
- Per-step host inputs: the theta-warmup scale and the annealed claimed
  observation variance are computed on the host (fp32, as the JAX package
  computes them) and enter the step as 0-dim device tensors, copied from
  pinned memory; nothing in the step reads a device value on the host.
- Dispatch: ``steps_per_call`` K > 1 runs K steps per call through a
  ``TrainChunk`` (``inference/chunk.py``): one CUDA graph of K steps on a
  CUDA device, the same K steps eagerly on the CPU. Chunks never span a
  flush or checkpoint boundary; auto (0) chunks runs of at least three
  flush intervals by the interval, as the JAX package does.
- Host syncs: metrics stay on the device and are copied to the host
  asynchronously, once per dispatch; the host reads them only at flush
  boundaries, leaving the newest dispatch in flight. Each flush feeds the
  console's live panel.
- Checkpoints: params, AdamW state and EMA as trees under the params' leaf
  paths (``utils/pytree_io.py``), with the next step; since a step's draws
  depend only on ``(seed, step)``, a restored run replays the unbroken one.
- Pretraining (``pretrain_sde_parameters``) fits the theta-posterior mean
  before training, by a global population search or by gradient descent,
  in plain PyTorch (the JAX package has no kernel there either). Its draws
  come from ``pretrain_draws``, which a test can replace.

Not ported yet: multi-device meshes.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import Tensor

from viforsdes_tpu_torch.config import EncoderConfig, HeadConfig, PretrainConfig, TrainingConfig
from viforsdes_tpu_torch.core.observations import (
    GaussianObservationLikelihood,
    ObservationLikelihood,
    Observations,
)
from viforsdes_tpu_torch.core.priors import Prior
from viforsdes_tpu_torch.core.sde import SDE
from viforsdes_tpu_torch.core.solvers import euler_maruyama
from viforsdes_tpu_torch.core.state_space import StateSpace
from viforsdes_tpu_torch.inference.chunk import TrainChunk, pack_metrics
from viforsdes_tpu_torch.inference.constants import (
    LOSS_EMA_DECAY,
    MAX_CONSECUTIVE_NONFINITE_STEPS,
    OBS_VARIANCE_FLOOR,
)
from viforsdes_tpu_torch.inference.elbo import compute_evidence_lower_bound, observation_indices
from viforsdes_tpu_torch.inference.ema import ema_init, ema_update
from viforsdes_tpu_torch.inference.optimizer import GROUPS, ParamLayout, global_norm, make_optimizer
from viforsdes_tpu_torch.inference.path_sampler import sample_diffusion_paths
from viforsdes_tpu_torch.inference.types import EvidenceLowerBoundResult
from viforsdes_tpu_torch.models.model import VariationalSDEPosterior
from viforsdes_tpu_torch.utils.console import Console
from viforsdes_tpu_torch.utils.pytree_io import load_checkpoint, save_checkpoint


# the ELBO components of a packed metrics row (entries 1..5), by name
_COMPONENTS = (
    "observation_log_prob",
    "sde_log_prob",
    "generative_log_prob",
    "prior_log_prob",
    "posterior_log_prob",
)


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


def stream_seed(seed: int, stream: int, step: int = 0, *sub: int) -> int:
    """Seed of one random stream (0 = init, 1 = training steps, 2 = posterior
    sampling, 3 = pretraining) at one step (and ``sub``, a draw's kind within
    it): a function of its arguments only."""
    entropy = [seed, stream, step, *sub]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


# (theta eps [n_theta, P], path noise [T, B, D]) for one microbatch
Draws = tuple[Tensor, Tensor]

# The kinds of pretraining draws (``pretrain_draws``), the last entry of their
# stream-3 seed.
PRETRAIN_DRAWS = {"sweep": 0, "cem": 1, "init": 2, "theta": 3, "noise": 4}

# The global pretrain scores its sweep candidates in scans of whole
# population chunks, as many as keep a [N, D, D] diffusion tensor within this
# many floats: fewer, wider scans than one per chunk, with the same elites
# (the top of the union, as the JAX package's running merge keeps).
SWEEP_SCAN_FLOATS = 1 << 26


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
        console: Console | None = None,
        param_names: list[str] | None = None,
        sde_param_init_mean: Tensor | None = None,
        sde_param_init_std: float = 1.0,
        seed: int = 0,
        device: torch.device | str = "cuda",
        x0: Tensor | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.sde = sde
        self.observations = observations
        obs_matrix = getattr(observation_likelihood, "obs_matrix", None)
        if isinstance(observation_likelihood, GaussianObservationLikelihood) and obs_matrix is not None:
            # the operator lives on the device once, not copied in every step
            observation_likelihood = observation_likelihood.model_copy(
                update={"obs_matrix": obs_matrix.to(self.device)}
            )
        self.observation_likelihood = observation_likelihood
        self.prior = prior
        self.time_horizon = float(time_horizon)
        self.config = config
        self.seed = seed
        self.param_names = param_names
        self.console = console if console is not None else Console()
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
        self._pretrain_gen = torch.Generator(device=self.device)

        self.step = 0
        self._completed_steps = 0
        self.evidence_lower_bound_history: list[float] = []
        self.best_evidence_lower_bound = float("-inf")
        self._train_chunks: dict[int, TrainChunk] = {}

    # ------------------------------------------------------------- state

    @property
    def params(self) -> dict:
        """The params tree (views of the flat buffers)."""
        return self.layout.unpack(self.flat_params)

    @property
    def ema_params(self) -> dict:
        return self.layout.unpack(self.flat_ema)

    # ---------------------------------------------------- checkpoint / resume

    def _opt_state_tree(self) -> dict:
        """The AdamW state with its moments as trees (the params' leaf paths)."""
        s = self.opt_state
        return {
            "count": s["count"],
            "mu": self.layout.unpack(s["mu"]),
            "nu": self.layout.unpack(s["nu"]),
            "notfinite_count": s["notfinite_count"],
            "total_notfinite": s["total_notfinite"],
        }

    def save_checkpoint(self, path: str | Path) -> None:
        """Mid-training checkpoint: params, AdamW state and EMA as trees, the
        next step, the ELBO history and the best ELBO."""
        save_checkpoint(
            path,
            trees={"params": self.params, "opt_state": self._opt_state_tree(), "ema": self.ema_params},
            metadata={
                "next_step": self._completed_steps,
                "evidence_lower_bound_history": [float(v) for v in self.evidence_lower_bound_history],
                "best_evidence_lower_bound": float(self.best_evidence_lower_bound),
            },
        )

    def restore_checkpoint(self, path: str | Path) -> None:
        """Resume from a checkpoint of ``save_checkpoint``: training continues
        at its next step with the draws an unbroken run would take there. A
        JAX trainer checkpoint holds optax's optimizer state, whose leaves are
        not the port's: that mismatch raises a ValueError."""
        trees, meta = load_checkpoint(
            path,
            templates={"params": self.params, "opt_state": self._opt_state_tree(), "ema": self.ema_params},
            required_metadata=("next_step", "evidence_lower_bound_history", "best_evidence_lower_bound"),
            kind="trainer",
        )
        opt = trees["opt_state"]
        # into the existing buffers: a captured chunk holds their addresses
        with torch.no_grad():
            for flats, tree in ((self.flat_params, trees["params"]), (self.flat_ema, trees["ema"]),
                                (self.opt_state["mu"], opt["mu"]), (self.opt_state["nu"], opt["nu"])):
                for g, restored in self.layout.pack(tree, self.device).items():
                    flats[g].copy_(restored)
            for k in ("count", "notfinite_count", "total_notfinite"):
                self.opt_state[k].copy_(opt[k])
        self.evidence_lower_bound_history = list(meta["evidence_lower_bound_history"])
        self.best_evidence_lower_bound = meta["best_evidence_lower_bound"]
        self._completed_steps = int(meta["next_step"])
        self.step = max(self._completed_steps - 1, 0)

    # ------------------------------------------------------------ train step

    def _obs_variance_schedule(self, steps: np.ndarray) -> np.ndarray:
        """Claimed observation variance at each of ``steps`` under the
        log-linear anneal, in fp32 arithmetic as the JAX package computes it."""
        vf = float(self.config.obs_variance_final)
        v0 = float(self.observation_likelihood.variance)
        t = np.clip(
            (steps.astype(np.float32) - np.float32(self.config.theta_warmup_steps))
            / np.float32(self.config.obs_variance_anneal_steps),
            np.float32(0.0),
            np.float32(1.0),
        )
        log_v = (np.float32(1.0) - t) * np.float32(np.log(v0)) + t * np.float32(np.log(vf))
        return np.exp(log_v, dtype=np.float32)

    def _step_schedule(self, first_step: int, length: int) -> np.ndarray:
        """The host-side inputs of steps ``first_step .. first_step + length -
        1`` as fp32 ``[2, length]``: the theta scale (0.0 during the warmup,
        else 1.0) and the anneal's claimed observation variance (1.0, unread,
        when no anneal is set)."""
        steps = np.arange(first_step, first_step + length)
        out = np.ones((2, length), dtype=np.float32)
        out[0] = steps >= self.config.theta_warmup_steps
        if self.config.obs_variance_final is not None:
            out[1] = self._obs_variance_schedule(steps)
        return out

    def _upload(self, values: np.ndarray, out: Tensor | None = None) -> Tensor:
        """``values`` on the trainer's device (into ``out`` if given) without
        waiting for the stream: through a fresh pinned buffer, copied
        asynchronously (the caching host allocator keeps the buffer until the
        copy is done)."""
        host = torch.from_numpy(values)
        if self.device.type == "cuda":
            host = host.pin_memory()
        if out is None:
            return host.to(self.device, non_blocking=True)
        return out.copy_(host, non_blocking=True)

    def _annealed_obs_variance(self, step: int | None) -> Tensor:
        """Claimed observation variance at ``step`` as a 0-dim fp32 tensor on
        the trainer's device; ``None`` is the final value, for evaluation
        after training."""
        if step is None:
            value = np.float32(self.config.obs_variance_final)
        else:
            value = self._obs_variance_schedule(np.asarray([step]))[0]
        return self._upload(np.asarray(value, dtype=np.float32))

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
        self, params: dict, theta_eps: Tensor, path_noise: Tensor, step: int | None = None,
        obs_variance: Tensor | None = None,
    ) -> EvidenceLowerBoundResult:
        """The ELBO of one microbatch from injected draws: ``theta_eps
        [B/iw, P]`` and time-major ``path_noise [T, B, D]``. Under the
        observation-variance anneal the claimed variance is ``obs_variance``
        (a 0-dim device tensor) or else the anneal's at ``step``."""
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
            sde=self.sde,
        )
        if self.config.obs_variance_final is not None:
            if obs_variance is None:
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
        theta_scale: Tensor | float | None = None,
        *,
        obs_variance: Tensor | None = None,
    ) -> tuple[dict[str, Tensor], dict, dict[str, Tensor], StepMetrics]:
        """One optimizer step on flat group buffers, updated in place.
        ``draws`` holds one pair per microbatch (``grad_accum_steps``):
        averaging the microbatch gradients reproduces the full-batch gradient
        exactly, since IWAE groups never span microbatches. ``theta_scale``
        0.0 freezes the applied theta (and observation-variance) update during
        the warmup; under the observation-variance anneal ``obs_variance``
        (a 0-dim device tensor) is the step's claimed variance."""
        if self.config.obs_variance_final is not None and obs_variance is None:
            raise ValueError(
                "obs_variance_final is set: training steps must pass the step's "
                "claimed variance (obs_variance) into _step_math"
            )
        if len(draws) != self.config.grad_accum_steps:
            raise ValueError(f"expected {self.config.grad_accum_steps} draws, got {len(draws)}")
        grads: dict[str, Tensor] | None = None
        results: list[EvidenceLowerBoundResult] = []
        for theta_eps, path_noise in draws:
            leaves = {g: params[g].detach().requires_grad_() for g in GROUPS}
            result = self._elbo_from_params(
                self.layout.unpack(leaves), theta_eps, path_noise, obs_variance=obs_variance
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
        """Run training step ``step`` on the trainer's state. Its theta scale
        and claimed observation variance enter as device tensors, as in a
        chunk (``TrainChunk``), so both dispatch paths run the same ops."""
        warmup = self.config.theta_warmup_steps > 0
        anneal = self.config.obs_variance_final is not None
        theta_scale = obs_variance = None
        if warmup or anneal:
            schedule = self._upload(self._step_schedule(step, 1))
            theta_scale = schedule[0, 0] if warmup else None
            obs_variance = schedule[1, 0] if anneal else None
        *_, metrics = self._step_math(
            self.flat_params, self.opt_state, self.flat_ema, self.draws(step),
            theta_scale, obs_variance=obs_variance,
        )
        self.step = step
        self._completed_steps = step + 1
        return metrics

    def _get_train_chunk(self, length: int) -> TrainChunk:
        """The runner of ``length`` steps per call, built once per length
        (the JAX package caches its scanned chunks the same way)."""
        chunk = self._train_chunks.get(length)
        if chunk is None:
            chunk = self._train_chunks[length] = TrainChunk(self, length)
        return chunk

    def _resolve_steps_per_call(self, update_interval: int) -> int:
        """Steps per dispatch: ``steps_per_call``, where auto (0) chunks a run
        of at least three flush intervals by the interval and runs a shorter
        one step by step; chunks never span a flush, so the interval caps
        it."""
        spc = self.config.steps_per_call
        if spc == 0:
            remaining = self.config.n_iterations - self._completed_steps
            spc = update_interval if remaining >= 3 * update_interval else 1
        return max(1, min(spc, update_interval))

    # ----------------------------------------------------------------- train

    def train(
        self,
        callback: Callable[[int, float], None] | None = None,
        *,
        update_interval: int = 10,
        checkpoint_every: int | None = None,
        checkpoint_path: str | Path | None = None,
    ) -> TrainingState:
        """Train from the next step to ``config.n_iterations``. With both
        ``checkpoint_every`` and ``checkpoint_path``, a checkpoint is written
        whenever the completed steps are a multiple of ``checkpoint_every``."""
        self.console.config_panel(self.config)
        # the smoothed loss, rebuilt from the history on resume
        loss_ema = 0.0
        for i, elbo in enumerate(self.evidence_lower_bound_history):
            loss_ema = LOSS_EMA_DECAY * loss_ema + (1 - LOSS_EMA_DECAY) * (-elbo) if i > 0 else -elbo
        # (first step, host copy of the dispatch's metrics rows [k, 8 + P],
        # event marking the copy)
        pending: list[tuple[int, Tensor, torch.cuda.Event | None]] = []

        def enqueue(first_step: int, rows: Tensor) -> None:
            if rows.is_cuda:
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                pending.append((first_step, host, event))
            else:  # a chunk's rows are overwritten by its next call
                pending.append((first_step, rows.clone(), None))

        def flush(progress, keep_last: int = 0) -> None:
            """Read pending metrics on the host, split into one row per step.
            ``keep_last=1`` leaves the newest dispatch's copy unread, so the
            device keeps working on it while the host catches up."""
            nonlocal loss_ema
            if len(pending) <= keep_last:
                return
            take = pending[: len(pending) - keep_last]
            del pending[: len(take)]
            if take[-1][2] is not None:
                take[-1][2].synchronize()
            worst = 0
            for first_step, host, _ in take:
                for step, row in enumerate(host.tolist(), start=first_step):
                    elbo = row[0]
                    loss_ema = LOSS_EMA_DECAY * loss_ema + (1 - LOSS_EMA_DECAY) * (-elbo) if step > 0 else -elbo
                    self.evidence_lower_bound_history.append(elbo)
                    if elbo > self.best_evidence_lower_bound:
                        self.best_evidence_lower_bound = elbo
                    if callback is not None:
                        callback(step, elbo)
                    worst = max(worst, int(row[7]))
            last_step = step
            if worst >= MAX_CONSECUTIVE_NONFINITE_STEPS:
                raise RuntimeError(
                    f"training diverged: {worst} consecutive non-finite update "
                    f"steps by step {last_step} (params remain at their last "
                    f"finite values; inspect the latest checkpoint)"
                )
            progress.update(
                step=last_step,
                loss=loss_ema / (1 - LOSS_EMA_DECAY ** (last_step + 1)),
                elbo=row[0],
                best_elbo=self.best_evidence_lower_bound,
                components=dict(zip(_COMPONENTS, row[1:6])),
                grad_norm=row[6],
                param_means=np.asarray(row[8:]),
            )

        checkpointing = checkpoint_every is not None and checkpoint_path is not None
        n_iterations = self.config.n_iterations
        chunk = self._resolve_steps_per_call(update_interval)

        def is_boundary(completed: int) -> bool:
            """Host-sync points in completed steps (flushes and checkpoints):
            no chunk spans one."""
            return completed % update_interval == 0 or (checkpointing and completed % checkpoint_every == 0)

        with self.console.training_progress(
            n_iterations,
            update_interval=update_interval,
            param_names=self.param_names,
            device=self.device,
        ) as progress:
            step = self._completed_steps
            while step < n_iterations:
                seg_end = step + 1
                while seg_end < n_iterations and not is_boundary(seg_end):
                    seg_end += 1
                while step < seg_end:
                    # a segment's tail shorter than a chunk runs step by step
                    if chunk > 1 and seg_end - step >= chunk:
                        enqueue(step, self._get_train_chunk(chunk)(step))
                        step += chunk
                    else:
                        enqueue(step, pack_metrics(self.train_step(step))[None])
                        step += 1
                if step % update_interval == 0:
                    flush(progress, keep_last=1)
                if checkpointing and step % checkpoint_every == 0:
                    flush(progress)
                    self.save_checkpoint(checkpoint_path)
            flush(progress)

        return TrainingState(
            step=self.step,
            evidence_lower_bound_history=self.evidence_lower_bound_history,
            best_evidence_lower_bound=self.best_evidence_lower_bound,
            params=self.params,
            ema_params=self.ema_params,
        )

    # -------------------------------------------------------------- pretrain

    def pretrain_draws(
        self, kind: str, index: int, shape: tuple[int, ...],
        low: Tensor | None = None, high: Tensor | None = None,
    ) -> Tensor:
        """The random numbers of pretraining, from stream 3 seeded by
        ``(seed, index, kind)``: ``"sweep"`` the candidates of sweep chunk
        ``index``, uniform in the box ``[low, high)``; ``"cem"`` the standard
        normals of CEM round ``index``; ``"init"`` the normals of the gradient
        method's initial mean; ``"theta"`` and ``"noise"`` gradient step
        ``index``'s theta eps ``[B, P]`` and path noise ``[B, T, D]``."""
        gen = self._pretrain_gen.manual_seed(stream_seed(self.seed, 3, index, PRETRAIN_DRAWS[kind]))
        if kind == "sweep":
            u = torch.rand(shape, generator=gen, device=self.device)
            return torch.maximum(low, u * (high - low) + low)
        return torch.randn(shape, generator=gen, device=self.device)

    def pretrain_sde_parameters(self, config: PretrainConfig | None = None) -> Tensor:
        """Pre-fit of the theta-posterior mean: a global population search on
        a teacher-forced segment objective (full-state observations), or
        gradient descent on the full-rollout MSE (``PretrainConfig.method``;
        ``"auto"`` takes the global search when the whole state is observed).
        Returns the mean in the unconstrained parameterization (log for
        positive dims)."""
        cfg = config or PretrainConfig()
        d = self.sde.sde_param_dim
        pos_mask = torch.zeros(d, dtype=torch.bool, device=self.device)
        pos_mask[self.sde_param_positive_dims] = True
        obs_idx = np.round(np.asarray(self.observations.times) / self.config.time_step).astype(np.int64)
        obs_values = self.obs_values
        # partial observation: compare through the linear observation operator
        obs_matrix = getattr(self.observation_likelihood, "obs_matrix", None)
        full_state_obs = obs_matrix is None and obs_values.shape[-1] == self.sde.state_dim

        method = cfg.method
        if method == "auto":
            method = "global" if full_state_obs else "gradient"
        if method == "global" and not full_state_obs:
            raise ValueError(
                "pretrain method='global' requires full-state observations "
                "(teacher forcing needs the whole state at every observation)"
            )
        if method == "global":
            return self._pretrain_global(cfg, pos_mask, obs_idx, obs_values)
        return self._pretrain_gradient(cfg, pos_mask, obs_idx, obs_values, obs_matrix)

    def _segment_score(self, use_nll: bool, is_obs: np.ndarray, grid_obs: Tensor,
                       pos_mask: Tensor) -> Callable[[Tensor], Tensor]:
        """The global method's score ``z [N, P] -> [N]`` (lower is better):
        one deterministic Euler rollout over the grid that restarts from the
        observed state at every observation slot and scores each segment's
        endpoint, by its Gaussian NLL under the candidate's own diffusion
        ``(L L^T) t_seg`` with L frozen at the restart state (``use_nll``) or
        by its squared error; the sum over segments per scored value,
        non-finite as +inf. The observation slots are known on the host, so
        the steps between them only roll the drift."""
        dt = self.config.time_step
        n_steps = len(is_obs) - 1
        state_dim = self.sde.state_dim
        n_scored = int(is_obs[1:].sum())
        clamp = None
        if self.state_space.positive_dims:
            clamp = torch.zeros(state_dim, dtype=torch.bool, device=self.device)
            clamp[list(self.state_space.positive_dims)] = True
        dt32 = np.float32(dt)

        def restart(x: Tensor, theta: Tensor) -> tuple[Tensor, Tensor]:
            chol = self.sde.diffusion(x, theta)
            diag = torch.abs(torch.diagonal(chol, dim1=-2, dim2=-1))
            return chol, 2.0 * torch.sum(torch.log(diag + 1e-20), -1)

        @torch.no_grad()
        def score(z: Tensor) -> Tensor:
            theta = torch.where(pos_mask, torch.exp(z), z)
            x = self._x0_single.expand(z.shape[0], state_dim)
            if use_nll:
                chol, logdet = restart(x, theta)
            total = torch.zeros(z.shape[0], dtype=torch.float32, device=self.device)
            t_el = np.float32(0.0)
            for k in range(n_steps):
                x_next = x + self.sde.drift(x, theta) * dt
                if clamp is not None:
                    x_next = torch.where(clamp, torch.clamp(x_next, min=1e-6), x_next)
                t_next = np.float32(t_el + dt32)
                if not is_obs[k + 1]:
                    x, t_el = x_next, t_next
                    continue
                y = grid_obs[k + 1].expand_as(x_next)
                r = x_next - y
                if use_nll:
                    w = torch.linalg.solve_triangular(chol, r[..., None], upper=False)[..., 0]
                    log_t = np.float32(state_dim) * np.log(t_next)
                    total = total + 0.5 * (torch.sum(w * w, -1) / float(t_next) + logdet + float(log_t))
                else:
                    total = total + torch.sum(r * r, -1)
                x, t_el = y, np.float32(0.0)
                if use_nll:
                    chol, logdet = restart(x, theta)
            out = total / (n_scored * state_dim)
            return torch.where(torch.isfinite(out), out, torch.full_like(out, float("inf")))

        return score

    def _pretrain_global(self, cfg: PretrainConfig, pos_mask: Tensor, obs_idx: np.ndarray,
                         obs_values: Tensor) -> Tensor:
        """Prior-box sweep + cross-entropy refinement of the segment score
        (``_segment_score``; the JAX package's ``_pretrain_global`` explains
        the choice). It assumes low observation noise: observed values are
        taken as exact restart states."""
        d = self.sde.sde_param_dim
        n_steps = round(self.time_horizon / self.config.time_step)
        state_dim = self.sde.state_dim
        is_obs = np.zeros(n_steps + 1, dtype=bool)
        is_obs[obs_idx] = True
        grid_obs = torch.zeros((n_steps + 1, state_dim), dtype=torch.float32, device=self.device)
        grid_obs[torch.as_tensor(obs_idx, device=self.device)] = obs_values.float()
        if int(is_obs[1:].sum()) == 0:
            raise ValueError("pretrain requires at least one observation after t=0")
        score = self._segment_score(cfg.global_objective == "nll", is_obs, grid_obs, pos_mask)

        # Prior-informed unconstrained search box (3 prior std; positive dims
        # searched in log space, with 3 extra nats downward: small rate
        # constants sit in the prior's lower tail).
        m, s = self.prior.mean, self.prior.std
        if self.prior.type.name == "LOG_NORMAL":
            lo_pos, hi_pos = m - 3.0 * s - 3.0, m + 3.0 * s
        else:
            hi_pos = float(np.log(max(m + 3.0 * s, 1e-2)))
            lo_pos = hi_pos - 7.0

        def box(pos: float, other: float) -> Tensor:
            return torch.where(pos_mask, torch.tensor(pos, dtype=torch.float32, device=self.device),
                               torch.tensor(other, dtype=torch.float32, device=self.device))

        lo, hi = box(lo_pos, m - 3.0 * s), box(hi_pos, m + 3.0 * s)
        pop = cfg.batch_size
        n_elite = max(1, int(round(cfg.elite_fraction * pop)))

        with self.console.pretrain_progress(cfg.cem_rounds + 1) as progress:
            # phase A: uniform sweep of the box, population chunks scored in
            # wider scans; the running top-n_elite of every candidate so far
            n_chunks = max(1, -(-cfg.sweep_candidates // pop))
            per_scan = max(1, min(n_chunks, SWEEP_SCAN_FLOATS // (pop * state_dim * state_dim)))
            best_z = torch.zeros((0, d), dtype=torch.float32, device=self.device)
            best_s = torch.zeros((0,), dtype=torch.float32, device=self.device)
            for c0 in range(0, n_chunks, per_scan):
                z = torch.cat([self.pretrain_draws("sweep", c, (pop, d), lo, hi)
                               for c in range(c0, min(n_chunks, c0 + per_scan))])
                all_s = torch.cat([best_s, score(z)])
                keep = torch.argsort(all_s, stable=True)[:n_elite]
                best_z, best_s = torch.cat([best_z, z])[keep], all_s[keep]
            mu = torch.mean(best_z, 0)
            sigma = torch.std(best_z, 0, correction=0) + 0.05
            progress.update(0, float(best_s[0]), float(best_s[0]), _median(sigma))

            # phase B: cross-entropy refinement around the sweep elites
            overall_best_s = float(best_s[0])
            overall_best_z = best_z[0]
            for r in range(cfg.cem_rounds):
                z = mu + sigma * self.pretrain_draws("cem", r, (pop, d))
                s_r = score(z)
                elite = torch.argsort(s_r, stable=True)[:n_elite]
                mu = torch.mean(z[elite], 0)
                sigma = torch.std(z[elite], 0, correction=0) + 1e-4
                round_best = float(s_r[elite[0]])
                if round_best < overall_best_s:
                    overall_best_s = round_best
                    overall_best_z = z[elite[0]]
                progress.update(r + 1, round_best, overall_best_s, _median(sigma))

        # The CEM mean is the denoised estimate; the single best candidate if
        # the mean regressed (NLL scores can be negative: an absolute and
        # relative tolerance).
        tol = 0.05 * max(1.0, abs(overall_best_s))
        if float(score(mu[None])[0]) <= overall_best_s + tol:
            return mu
        return overall_best_z

    def _pretrain_gradient(self, cfg: PretrainConfig, pos_mask: Tensor, obs_idx: np.ndarray,
                           obs_values: Tensor, obs_matrix: Tensor | None) -> Tensor:
        """Adam (after clip-by-global-norm 1.0, as optax's chain computes
        them) on the full-rollout MSE at the observation times, through the
        linear observation operator under partial observation. A step whose
        MSE is not finite is skipped; the best mean is the one the best MSE
        was evaluated at, before its step."""
        d = self.sde.sde_param_dim
        batch = cfg.batch_size
        n_steps = round(self.time_horizon / self.config.time_step)
        b1, b2, eps_adam, max_norm = 0.9, 0.999, 1e-8, 1.0
        mu0 = torch.where(pos_mask, torch.zeros((), device=self.device),
                          cfg.init_scale * self.pretrain_draws("init", 0, (d,)))
        state = [mu0, torch.zeros(d, dtype=torch.float32, device=self.device)]  # mean, log sigma
        m1 = [torch.zeros_like(v) for v in state]
        m2 = [torch.zeros_like(v) for v in state]
        count = 0
        x0 = self._x0_single.expand(batch, self.sde.state_dim)
        obs_idx_t = torch.as_tensor(obs_idx, device=self.device)
        h = None if obs_matrix is None else obs_matrix.to(self.device)
        best_mu, best_mse = mu0, float("inf")

        with self.console.pretrain_progress(cfg.n_iterations) as progress:
            for step in range(cfg.n_iterations):
                eps = self.pretrain_draws("theta", step, (batch, d))
                noise = self.pretrain_draws("noise", step, (batch, n_steps, self.sde.state_dim))
                mu, log_sigma = (v.detach().requires_grad_() for v in state)
                log_theta = mu + torch.exp(log_sigma) * eps
                theta = torch.where(pos_mask, torch.exp(log_theta), log_theta)
                paths = euler_maruyama(self.sde, x0, theta, self.time_horizon, self.config.time_step,
                                       self.state_space.positive_dims, noise=noise)
                predicted = paths[:, obs_idx_t]
                if h is not None:
                    predicted = torch.einsum("od,btd->bto", h, predicted)
                mse = torch.mean((predicted - obs_values[None]) ** 2)
                grads = torch.autograd.grad(mse, [mu, log_sigma])
                mse_f = float(mse.detach())
                mu_before = state[0]
                if np.isfinite(mse_f):
                    with torch.no_grad():
                        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                        trigger = g_norm < max_norm
                        count += 1
                        bc1 = 1.0 - b1 ** np.float32(count)
                        bc2 = 1.0 - b2 ** np.float32(count)
                        new_state = []
                        for i, g in enumerate(grads):
                            g = torch.where(trigger, g, (g / g_norm) * max_norm)
                            m1[i] = (1.0 - b1) * g + b1 * m1[i]
                            m2[i] = (1.0 - b2) * (g * g) + b2 * m2[i]
                            update = (m1[i] / float(bc1)) / (torch.sqrt(m2[i] / float(bc2)) + eps_adam)
                            new_state.append(state[i] + -cfg.learning_rate * update)
                        state = new_state
                    if mse_f < best_mse:
                        best_mu, best_mse = mu_before, mse_f
                progress.update(step, mse_f, best_mse, _median(torch.exp(state[1])))
        return best_mu.detach()

    def set_theta_mean(self, mean: Tensor) -> None:
        """Copy a pretrained mean into the theta posterior. The AdamW moments
        restart from zero, as the JAX package does (pretraining comes before
        any step); the EMA is left as it is, also as the JAX package does."""
        with torch.no_grad():
            self.params["theta"]["mean"].copy_(torch.as_tensor(mean, dtype=torch.float32))
            # in place: a captured chunk holds the state's addresses
            for g in GROUPS:
                self.opt_state["mu"][g].zero_()
                self.opt_state["nu"][g].zero_()
            for k in ("count", "notfinite_count", "total_notfinite"):
                self.opt_state[k].zero_()


def _median(v: Tensor) -> float:
    """The median as numpy takes it (the mean of the middle two), for the
    pretrain panel."""
    return float(np.median(v.detach().cpu().numpy()))


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
