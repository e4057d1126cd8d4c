"""Ornstein-Uhlenbeck 1-D example on the PyTorch port (twin of
``examples/ornstein_uhlenbeck.py``).

dx = kappa (mu - x) dt + sigma dW, observed 6 times on [0, 5].
Posterior over (kappa, mu, sigma) with kappa, sigma > 0 (log-normal marginals).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch import Tensor  # noqa: E402

import viforsdes_tpu_torch as vtt  # noqa: E402


class OrnsteinUhlenbeck:
    state_dim = 1
    sde_param_dim = 3

    def drift(self, x: Tensor, sde_parameters: Tensor) -> Tensor:
        kappa = sde_parameters[..., 0:1]
        mu = sde_parameters[..., 1:2]
        return kappa * (mu - x)

    def diffusion(self, x: Tensor, sde_parameters: Tensor) -> Tensor:
        sigma = sde_parameters[..., 2:3]
        return sigma[..., None]


def main() -> None:
    console = vtt.Console()
    param_names = ["κ", "μ", "σ"]

    observations = vtt.Observations(
        times=[0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
        values=[[2.0], [1.5], [0.8], [1.2], [0.9], [1.1]],
    )

    prior = vtt.Prior(type=vtt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3)

    posterior = vtt.infer(
        sde=OrnsteinUhlenbeck(),
        observations=observations,
        observation_likelihood=vtt.GaussianObservationLikelihood(variance=0.1),
        prior=prior,
        time_horizon=5.0,
        config=vtt.InferenceConfig(
            training=vtt.TrainingConfig(
                time_step=0.05,
                batch_size=128,
                n_iterations=20000,
                learning_rate=1e-4,
                sde_param_lr=1e-3,
                grad_clip_norm=1.0,
            ),
            encoder=vtt.EncoderConfig(hidden_dim=256, num_heads=4, depth=8),
            head=vtt.HeadConfig(hidden_dim=64, num_layers=2),
            sde_param_positive_dims=[0, 2],
            console=console,
            param_names=param_names,
            pretrain=vtt.PretrainConfig(),
        ),
    )

    summary = posterior.summary(n_samples=500)
    diag = posterior.diagnostics()
    console.summary_table(summary, diag, param_names=param_names)

    posterior.plot(n_trajectories=30, show=False).savefig("ou_posterior.png", dpi=120)
    posterior.save("ou_posterior.npz")


if __name__ == "__main__":
    main()
