"""Stochastic Lotka-Volterra 2-D example on the PyTorch port (twin of
``examples/lotka_volterra.py``).

Prey/predator populations with demographic noise (chemical Langevin form);
positive state via softplus transform, log-normal theta posterior.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch import Tensor  # noqa: E402

import viforsdes_tpu_torch as vtt  # noqa: E402


class LotkaVolterra:
    state_dim = 2
    sde_param_dim = 3

    def drift(self, x: Tensor, p: Tensor) -> Tensor:
        u, v = x[..., 0], x[..., 1]
        t1, t2, t3 = p[..., 0], p[..., 1], p[..., 2]
        du = t1 * u - t2 * u * v
        dv = t2 * u * v - t3 * v
        return torch.stack([du, dv], dim=-1)

    def diffusion(self, x: Tensor, p: Tensor) -> Tensor:
        """Hand-derived 2x2 Cholesky of the CLE diffusion matrix with clamps."""
        u, v = x[..., 0], x[..., 1]
        t1, t2, t3 = p[..., 0], p[..., 1], p[..., 2]
        uv = u * v
        b11 = t1 * u + t2 * uv
        b12 = -t2 * uv
        b22 = t3 * v + t2 * uv
        L00 = torch.sqrt(torch.clamp(b11, min=1e-6))
        L10 = b12 / torch.clamp(L00, min=1e-6)
        L11 = torch.sqrt(torch.clamp(b22 - L10**2, min=1e-6))
        zeros = torch.zeros_like(L00)
        row0 = torch.stack([L00, zeros], dim=-1)
        row1 = torch.stack([L10, L11], dim=-1)
        return torch.stack([row0, row1], dim=-2)


def main() -> None:
    console = vtt.Console()
    param_names = ["θ₁", "θ₂", "θ₃"]

    observations = vtt.Observations(
        times=[0.0, 10.0, 20.0, 30.0, 40.0],
        values=[
            [71.0, 79.0],
            [47.61225908, 447.20971405],
            [80.53119269, 50.26254069],
            [23.10087379, 339.40432691],
            [158.05238324, 66.79611979],
        ],
    )

    prior = vtt.Prior(type=vtt.PriorType.LOG_NORMAL, mean=0.0, std=1.5, dim=3)

    posterior = vtt.infer(
        sde=LotkaVolterra(),
        observations=observations,
        observation_likelihood=vtt.GaussianObservationLikelihood(variance=1.0),
        prior=prior,
        time_horizon=40.0,
        config=vtt.InferenceConfig(
            training=vtt.TrainingConfig(
                time_step=0.1,
                batch_size=24,
                n_iterations=30000,
                learning_rate=1e-4,
                sde_param_lr=1e-3,
                grad_clip_norm=1.0,
            ),
            encoder=vtt.EncoderConfig(hidden_dim=256, num_heads=4, depth=8),
            head=vtt.HeadConfig(hidden_dim=64, num_layers=2),
            state_positive_dims=[0, 1],
            sde_param_positive_dims=[0, 1, 2],
            console=console,
            param_names=param_names,
            pretrain=vtt.PretrainConfig(),
        ),
    )

    summary = posterior.summary(n_samples=500)
    diag = posterior.diagnostics()
    console.summary_table(summary, diag, param_names=param_names)

    posterior.plot(n_trajectories=30, show=False).savefig(
        "lotka_volterra_posterior.png", dpi=120
    )
    posterior.save("lotka_volterra_posterior.npz")


if __name__ == "__main__":
    main()
