"""Stochastic Lorenz-63 3-D example on the PyTorch port (twin of
``examples/lorenz63.py``: dense observations, long horizon T=20 -> a
2000-step path and a 2001-token grid, which takes the flash kernels).

dx = sigma_L (y - x) dt + s dW1
dy = (x (rho - z) - y) dt + s dW2
dz = (x y - beta z) dt + s dW3

Inferred parameters: (sigma_L, rho, beta), all positive; fixed known noise
scale s. Observations are all three coordinates every 0.5 time units: the
JAX example's own, simulated there from ``jax.random.key(17)`` and carried
across in ``data/lorenz63_example.json``.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch import Tensor  # noqa: E402

import viforsdes_tpu_torch as vtt  # noqa: E402
from examples_torch import load_observations  # noqa: E402

NOISE_SCALE = 2.0
TRUE_PARAMS = (10.0, 28.0, 8.0 / 3.0)


class StochasticLorenz63:
    state_dim = 3
    sde_param_dim = 3

    def drift(self, x: Tensor, p: Tensor) -> Tensor:
        sigma_l, rho, beta = p[..., 0], p[..., 1], p[..., 2]
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        return torch.stack(
            [
                sigma_l * (x2 - x1),
                x1 * (rho - x3) - x2,
                x1 * x2 - beta * x3,
            ],
            dim=-1,
        )

    def diffusion(self, x: Tensor, p: Tensor) -> Tensor:
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        return (NOISE_SCALE * eye).expand(*x.shape, 3)


def simulate_observations(generator: torch.Generator, time_horizon=20.0, dt=0.01, obs_every=0.5):
    """Synthetic observations of the true system, drawn from ``generator``
    (the port's draws: not the JAX example's bits, which
    ``load_observations`` gives)."""
    sde = StochasticLorenz63()
    x0 = torch.tensor([[1.0, 1.0, 25.0]], device=generator.device)
    theta = torch.tensor([TRUE_PARAMS], device=generator.device)
    traj = vtt.euler_maruyama(sde, x0, theta, time_horizon, dt, generator=generator)
    stride = int(round(obs_every / dt))
    idx = list(range(0, traj.shape[1], stride))
    return vtt.Observations(times=[i * dt for i in idx], values=traj[0, idx].cpu())


def main() -> None:
    console = vtt.Console()
    param_names = ["σ_L", "ρ", "β"]

    observations = load_observations("lorenz63_example")

    prior = vtt.Prior(type=vtt.PriorType.LOG_NORMAL, mean=1.0, std=1.5, dim=3)

    posterior = vtt.infer(
        sde=StochasticLorenz63(),
        observations=observations,
        observation_likelihood=vtt.GaussianObservationLikelihood(variance=1.0),
        prior=prior,
        time_horizon=20.0,
        config=vtt.InferenceConfig(
            training=vtt.TrainingConfig(
                time_step=0.01,  # 2000-step path
                batch_size=32,
                n_iterations=30000,
            ),
            encoder=vtt.EncoderConfig(hidden_dim=256, num_heads=4, depth=8),
            head=vtt.HeadConfig(hidden_dim=64, num_layers=2),
            sde_param_positive_dims=[0, 1, 2],
            console=console,
            param_names=param_names,
            pretrain=vtt.PretrainConfig(),
        ),
    )

    summary = posterior.summary(n_samples=500)
    console.summary_table(summary, posterior.diagnostics(), param_names=param_names)
    print("true params:", TRUE_PARAMS)

    posterior.plot(n_trajectories=30, show=False).savefig("lorenz63_posterior.png", dpi=120)
    posterior.save("lorenz63_posterior.npz")


if __name__ == "__main__":
    main()
