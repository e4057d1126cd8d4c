"""SIR epidemic SDE with PARTIAL observation on the PyTorch port (twin of
``examples/sir_epidemic.py``): only the infected count I is observed;
susceptible S is latent. Log-normal theta posterior over (beta, gamma).

Chemical-Langevin SIR (S, I), recovered pool implicit:
  dS = -beta S I / N dt + noise
  dI = (beta S I / N - gamma I) dt + noise
with the 2x2 Cholesky of the reaction-noise covariance. It exercises
``obs_matrix`` partial observation (H = [[0, 1]]) and an explicit ``x0``.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch import Tensor  # noqa: E402

import viforsdes_tpu_torch as vtt  # noqa: E402

POPULATION = 1000.0


class SIR:
    state_dim = 2  # (S, I)
    sde_param_dim = 2  # (beta, gamma)

    def drift(self, x: Tensor, p: Tensor) -> Tensor:
        s, i = x[..., 0], x[..., 1]
        beta, gamma = p[..., 0], p[..., 1]
        infection = beta * s * i / POPULATION
        recovery = gamma * i
        return torch.stack([-infection, infection - recovery], dim=-1)

    def diffusion(self, x: Tensor, p: Tensor) -> Tensor:
        s, i = x[..., 0], x[..., 1]
        beta, gamma = p[..., 0], p[..., 1]
        a = torch.clamp(beta * s * i / POPULATION, min=1e-6)  # infection reaction rate
        b = torch.clamp(gamma * i, min=1e-6)  # recovery reaction rate
        # Cov = [[a, -a], [-a, a+b]]; closed-form Cholesky:
        l00 = torch.sqrt(a)
        l10 = -torch.sqrt(a)
        l11 = torch.sqrt(b)
        zeros = torch.zeros_like(a)
        row0 = torch.stack([l00, zeros], dim=-1)
        row1 = torch.stack([l10, l11], dim=-1)
        return torch.stack([row0, row1], dim=-2)


def main() -> None:
    console = vtt.Console()
    param_names = ["β", "γ"]

    # Weekly case counts of infected individuals (observed dimension: I only).
    observations = vtt.Observations(
        times=[0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0],
        values=[[5.0], [14.0], [42.0], [95.0], [155.0], [170.0], [130.0], [85.0], [50.0]],
    )

    prior = vtt.Prior(type=vtt.PriorType.LOG_NORMAL, mean=0.0, std=1.0, dim=2)

    posterior = vtt.infer(
        sde=SIR(),
        observations=observations,
        # observe only I: H = [[0, 1]]
        observation_likelihood=vtt.GaussianObservationLikelihood(
            variance=4.0, obs_matrix=[[0.0, 1.0]]
        ),
        prior=prior,
        time_horizon=8.0,
        config=vtt.InferenceConfig(
            training=vtt.TrainingConfig(
                time_step=0.02,
                batch_size=64,
                n_iterations=20000,
            ),
            encoder=vtt.EncoderConfig(hidden_dim=256, num_heads=4, depth=8),
            head=vtt.HeadConfig(hidden_dim=64, num_layers=2),
            state_positive_dims=[0, 1],
            sde_param_positive_dims=[0, 1],
            console=console,
            param_names=param_names,
            x0=torch.tensor([POPULATION - 5.0, 5.0]),  # S0, I0
        ),
    )

    summary = posterior.summary(n_samples=500)
    console.summary_table(summary, posterior.diagnostics(), param_names=param_names)

    posterior.plot(n_trajectories=30, show=False).savefig("sir_posterior.png", dpi=120)
    posterior.save("sir_posterior.npz")


if __name__ == "__main__":
    main()
