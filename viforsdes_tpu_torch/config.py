"""Config system: pydantic frozen models + YAML loading.

The PyTorch twin of ``viforsdes_tpu/config.py``: the same models with the same
field names, defaults and validators (``tests/test_torch_config.py`` holds the
two equal). The only difference is ``ComputeDtype.value_dtype``, which maps to
a ``torch`` dtype. Comments that explain a field's purpose live in the JAX
package's copy.
"""

from __future__ import annotations

from enum import Enum
from pathlib import Path
from typing import Self

import torch
import yaml
from pydantic import BaseModel, ConfigDict, field_validator, model_validator


class YamlConfig(BaseModel):
    model_config = ConfigDict(frozen=True)

    @classmethod
    def from_yaml(cls, path: str | Path) -> Self:
        with open(path) as f:
            data = yaml.safe_load(f)
        if data is None:
            data = {}
        return cls(**data)


class ComputeDtype(Enum):
    """Activation compute dtype for the encoder/ELBO path (ref ``AmpDtype``)."""

    BFLOAT16 = "bfloat16"
    FLOAT32 = "float32"

    @property
    def value_dtype(self):
        return torch.bfloat16 if self is ComputeDtype.BFLOAT16 else torch.float32


class TrainingConfig(YamlConfig):
    time_step: float = 0.1
    batch_size: int = 50
    n_iterations: int = 25000
    learning_rate: float = 1e-4
    sde_param_lr: float = 1e-3
    grad_clip_norm: float = 1.0
    compute_dtype: ComputeDtype = ComputeDtype.BFLOAT16
    # Freeze the theta posterior for the first N steps so the (zero-init)
    # path model learns to bridge observations before theta moves. Without
    # it, chaotic systems collapse: the drift-regression against early
    # random-walk paths pulls theta to degenerate values faster than the
    # path model can learn, and the two lock in (Lorenz-63: sigma_L -> 0.05
    # from a near-truth init, results_lorenz.json round-2 diagnosis).
    theta_warmup_steps: int = 0
    # Importance-weighted path bound (IWAE, Burda et al. 2016): each of the
    # batch_size/iw_samples theta samples gets iw_samples paths, combined by
    # logsumexp over the per-path weights. Same path count and compute as the
    # plain ELBO (iw_samples=1, the reference objective). As iw_samples grows
    # the bound tends to E_q(theta)[log p(y|theta)] - KL(q(theta)||p(theta)),
    # whose optimum over q(theta) is the EXACT theta posterior — removing the
    # theta bias that a too-weak path family induces under the single-sample
    # ELBO (the mechanism behind the Lorenz-63 / high-dim OU 2-sigma failures,
    # BASELINE.md round-2 diagnosis).
    iw_samples: int = 1
    # Steps per dispatch. The port runs one step per call for 0 and 1; larger
    # values (several steps captured as one CUDA graph) raise
    # NotImplementedError in the trainer until that dispatch exists.
    steps_per_call: int = 0
    # Full-covariance q(theta) in the unconstrained space (zero-init coupling,
    # so init == the reference's mean-field family). Mean-field cannot
    # represent the parameter correlations chaotic posteriors carry, which
    # contributes to its overconfident marginal CIs (BASELINE.md Lorenz
    # diagnosis); the coupling adds P(P-1)/2 parameters — free at P <= a few.
    theta_full_covariance: bool = False
    # Learnable observation variance (beyond-reference: the reference's
    # GaussianObservationLikelihood holds it fixed, ref observations.py:39-74).
    # Adds a scalar log-variance parameter to the ELBO's observation term,
    # initialized at the likelihood's claimed variance and trained at
    # sde_param_lr (frozen during theta_warmup_steps, like theta); the
    # effective variance is OBS_VARIANCE_FLOOR + exp(log_variance). Motivation
    # (BASELINE.md ladder-5 diagnosis): when the claimed observation std is
    # comparable to the per-step increment noise sigma*sqrt(dt), the ELBO can
    # book real path variation as observation noise and the diffusion
    # parameter deflates; with noiseless data the learned variance shrinks,
    # pinning paths to the observations — claiming a tiny FIXED variance
    # instead diverges (the round-3 obs_var=1e-4 run ended all-NaN).
    learn_obs_variance: bool = False
    # Deterministic observation-variance annealing (beyond-reference). The
    # round-4 ladder-5 run falsified the LEARNED variance for this purpose:
    # early in training the path residuals are large, so the variance's MLE
    # gradient points UP — the claimed variance inflated 0.01 -> 0.048 and
    # the ELBO booked path variation as observation noise (full degenerate
    # collapse, kappa 0.62 / sigma 0.134, results_highdim_r4.json). The
    # anneal forces the descent instead: the claimed variance follows a
    # log-linear schedule from the likelihood's value down to
    # obs_variance_final over obs_variance_anneal_steps steps (starting
    # after theta_warmup_steps), then holds. Gradual tightening avoids the
    # init-shock that made a small FIXED claim diverge (round-3 obs_var=1e-4
    # run, all-NaN).
    obs_variance_final: float | None = None
    obs_variance_anneal_steps: int = 0
    # Gradient accumulation: split the batch into grad_accum_steps sequential
    # microbatches inside the jitted step (lax.scan), averaging gradients and
    # metrics. Mathematically EXACT for this objective (the ELBO/IWAE bound is
    # a mean over theta groups, and groups never span microbatches), so the
    # global batch's gradient is reproduced with 1/grad_accum_steps of the
    # activation memory — e.g. the ladder-5 global batch 4096 on one 16 GB
    # v5e chip (batch 4096 un-accumulated needs 29 GB, measured round 3).
    grad_accum_steps: int = 1

    @field_validator("theta_warmup_steps")
    @classmethod
    def validate_warmup(cls, v: int) -> int:
        if v < 0:
            raise ValueError("theta_warmup_steps must be >= 0")
        return v

    @field_validator("iw_samples")
    @classmethod
    def validate_iw_samples(cls, v: int) -> int:
        if v < 1:
            raise ValueError("iw_samples must be >= 1")
        return v

    @field_validator("steps_per_call")
    @classmethod
    def validate_steps_per_call(cls, v: int) -> int:
        if v < 0:
            raise ValueError("steps_per_call must be >= 0 (0 = auto)")
        return v

    @field_validator("grad_accum_steps")
    @classmethod
    def validate_grad_accum_steps(cls, v: int) -> int:
        if v < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        return v

    @model_validator(mode="after")
    def validate_obs_variance_anneal(self) -> "TrainingConfig":
        if self.obs_variance_final is not None:
            if self.obs_variance_final <= 0:
                raise ValueError("obs_variance_final must be > 0")
            if self.obs_variance_anneal_steps < 1:
                raise ValueError(
                    "obs_variance_final requires obs_variance_anneal_steps >= 1"
                )
            if self.learn_obs_variance:
                raise ValueError(
                    "obs_variance_final (deterministic anneal) and "
                    "learn_obs_variance are mutually exclusive"
                )
        elif self.obs_variance_anneal_steps != 0:
            raise ValueError(
                "obs_variance_anneal_steps requires obs_variance_final"
            )
        return self

    @model_validator(mode="after")
    def validate_iw_divides_batch(self) -> "TrainingConfig":
        if self.batch_size % self.iw_samples != 0:
            raise ValueError("batch_size must be divisible by iw_samples")
        if self.batch_size % self.grad_accum_steps != 0:
            raise ValueError("batch_size must be divisible by grad_accum_steps")
        micro = self.batch_size // self.grad_accum_steps
        if micro % self.iw_samples != 0:
            raise ValueError(
                "microbatch (batch_size / grad_accum_steps) must be divisible "
                "by iw_samples (importance groups cannot span microbatches)"
            )
        return self

    @field_validator("time_step", "learning_rate", "sde_param_lr", "grad_clip_norm")
    @classmethod
    def validate_positive_floats(cls, v: float) -> float:
        if v <= 0:
            raise ValueError("value must be positive")
        return v

    @field_validator("batch_size", "n_iterations")
    @classmethod
    def validate_positive_ints(cls, v: int) -> int:
        if v <= 0:
            raise ValueError("value must be positive")
        return v


class EncoderConfig(YamlConfig):
    hidden_dim: int = 128
    cond_dim: int = 128
    num_heads: int = 4
    depth: int = 4
    mlp_ratio: float = 8 / 3
    # The port's SiT stack is plain PyTorch with dense attention.

    @field_validator("hidden_dim", "cond_dim", "num_heads", "depth")
    @classmethod
    def validate_positive_ints(cls, v: int) -> int:
        if v <= 0:
            raise ValueError("value must be positive")
        return v

    @field_validator("mlp_ratio")
    @classmethod
    def validate_positive_ratio(cls, v: float) -> float:
        if v <= 0:
            raise ValueError("mlp_ratio must be positive")
        return v

    @model_validator(mode="after")
    def validate_head_divisible(self) -> "EncoderConfig":
        # Model-level check (the reference's field-order-dependent validator at
        # ``config.py:76-82`` silently never fired because num_heads is
        # declared after hidden_dim).
        if self.hidden_dim % self.num_heads != 0:
            raise ValueError("hidden_dim must be divisible by num_heads")
        return self


class HeadConfig(YamlConfig):
    hidden_dim: int = 64
    num_layers: int = 2
    # Path-sampler backend: "auto" = the hand-written CUDA kernels on a CUDA
    # device, the plain loop on the CPU; "pallas" = the kernels (the name is
    # kept from the JAX package); "scan" = the plain loop everywhere.
    sampler: str = "auto"
    # The TPU kernel's batch tile. The CUDA kernels take their rows per
    # block from the batch (``rows_per_block`` in ops/sde_sampler.py), so the
    # port reads this field nowhere.
    sampler_block_b: int = 128
    # Transition-scale parameterization: "full" = lower-triangular Cholesky,
    # d(d+1)/2 outputs (reference parity); "diag" = per-dim diagonal scale,
    # d outputs. For SDEs with (near-)diagonal bridge covariance, diag mode
    # removes the O(d^2) output block that dominates the head at large
    # state_dim (528 of 560 outputs at d=32). "matched" = diffusion-matched
    # bridge: the variational transition scale is the SDE's own diffusion
    # Cholesky g(x_t, theta) (chain-ruled into latent space) times a learned
    # per-dim correction exp(c), zero-init => exactly matched at init. A
    # diffusion bridge has the SAME diffusion coefficient as its SDE (Doob
    # h-transform), and the continuous-time KL is finite only when they
    # match — so matched mode removes the free-Cholesky failure mode where
    # the bridge's quadratic variation collapses to the DIAG_MIN floor and
    # drags the sigma posterior with it (the measured ladder-5 mechanism,
    # BASELINE.md / benchmarks/bridge_diagnosis.py). Requires the scan
    # sampler (the user's diffusion fn runs inside the recurrence).
    cholesky: str = "full"

    @field_validator("hidden_dim", "num_layers", "sampler_block_b")
    @classmethod
    def validate_positive_ints(cls, v: int) -> int:
        if v <= 0:
            raise ValueError("value must be positive")
        return v

    @field_validator("sampler")
    @classmethod
    def validate_sampler(cls, v: str) -> str:
        if v not in ("auto", "scan", "pallas"):
            raise ValueError("sampler must be 'auto', 'scan' or 'pallas'")
        return v

    @field_validator("cholesky")
    @classmethod
    def validate_cholesky(cls, v: str) -> str:
        if v not in ("full", "diag", "matched"):
            raise ValueError("cholesky must be 'full', 'diag' or 'matched'")
        return v


class PretrainConfig(YamlConfig):
    n_iterations: int = 1000
    batch_size: int = 4096
    learning_rate: float = 0.02
    init_scale: float = 2.0
    # Pretraining method:
    #   "global"   = prior-box quasi-random sweep + cross-entropy refinement
    #                of a teacher-forced segment objective (simulation restarts
    #                from every observed state; deterministic rollouts).
    #                Requires full-state observations. Finds narrow basins the
    #                reference's gradient pretrain cannot: chaotic systems'
    #                full-rollout MSE rewards degenerate stable dynamics
    #                (Lorenz-63 collapses to sigma_L~0.1), while the segment
    #                objective is globally minimized at the true parameters —
    #                but inside a basin too small for gradient descent, hence
    #                the population search (batch_size candidates per round).
    #   "gradient" = the reference objective (ref trainer.py:208-259): Adam on
    #                full-horizon stochastic rollout MSE at observation times.
    #   "auto"     = global when the full state is observed, gradient otherwise.
    #
    # NOTE (behavioral difference vs the reference): "global"/"auto" treats
    # observed values as exact restart states (teacher forcing) and scores
    # drift-only deterministic segments, i.e. it assumes observation noise is
    # small relative to the signal. With large observation variance the
    # segment objective partially fits that noise; set method="gradient" to
    # recover the reference's exact pretrain behavior in that regime.
    method: str = "auto"
    # Global-method segment score:
    #   "nll" = Gaussian pseudo-likelihood of segment residuals under the
    #           candidate's own diffusion covariance (L L^T * t_seg). Unlike
    #           MSE it identifies parameters that only enter the diffusion
    #           (pure OU: sigma never appears in the drift, so the MSE sweep
    #           left it at the search-box center — the round-3 highdim run
    #           started at sigma 0.10 vs true 0.5 and diverged). Ranking is
    #           identical to MSE when diffusion is theta-independent.
    #   "mse" = plain segment-endpoint MSE (rounds 2-3 behavior).
    global_objective: str = "nll"
    # Global-method budget: phase-A sweep candidates and CEM rounds/elites.
    sweep_candidates: int = 524288
    cem_rounds: int = 15
    elite_fraction: float = 0.1

    @field_validator("method")
    @classmethod
    def validate_method(cls, v: str) -> str:
        if v not in ("auto", "global", "gradient"):
            raise ValueError("method must be 'auto', 'global' or 'gradient'")
        return v

    @field_validator("global_objective")
    @classmethod
    def validate_global_objective(cls, v: str) -> str:
        if v not in ("nll", "mse"):
            raise ValueError("global_objective must be 'nll' or 'mse'")
        return v

    @field_validator("sweep_candidates", "cem_rounds")
    @classmethod
    def validate_positive_budget(cls, v: int) -> int:
        if v <= 0:
            raise ValueError("value must be positive")
        return v

    @field_validator("elite_fraction")
    @classmethod
    def validate_elite_fraction(cls, v: float) -> float:
        if not 0 < v <= 1:
            raise ValueError("elite_fraction must be in (0, 1]")
        return v

    @field_validator("n_iterations", "batch_size")
    @classmethod
    def validate_positive_ints(cls, v: int) -> int:
        if v <= 0:
            raise ValueError("value must be positive")
        return v

    @field_validator("learning_rate", "init_scale")
    @classmethod
    def validate_positive_floats(cls, v: float) -> float:
        if v <= 0:
            raise ValueError("value must be positive")
        return v
