"""High-dimensional OU (d=32) with data-parallel training on the PyTorch
port (twin of ``examples/highdim_ou_dp.py``, BASELINE.md config 5): batch
4096, the global batch over the mesh's ranks.

One process per GPU: ``torchrun --nproc_per_node=4
examples_torch/highdim_ou_dp.py``. Run plainly, the mesh is a world of one
on the current GPU, where batch 4096 in one pass does not fit an 80 GB
card. The observations are the JAX example's, simulated there
from ``jax.random.key(3)`` and carried across in
``data/highdim_example.json``.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch import Tensor  # noqa: E402

import viforsdes_tpu_torch as vtt  # noqa: E402
from examples_torch import load_observations  # noqa: E402

STATE_DIM = 32


class HighDimOU:
    """Independent OU in d=32 dims with shared (kappa, mu, sigma)."""

    state_dim = STATE_DIM
    sde_param_dim = 3

    def drift(self, x: Tensor, p: Tensor) -> Tensor:
        kappa = p[..., 0:1]
        mu = p[..., 1:2]
        return kappa * (mu - x)

    def diffusion(self, x: Tensor, p: Tensor) -> Tensor:
        sigma = p[..., 2:3]
        eye = torch.eye(STATE_DIM, dtype=x.dtype, device=x.device)
        return sigma[..., None] * eye


def simulate_observations(generator: torch.Generator, obs_every: float = 1.0, noise_std: float = 0.0):
    """Simulate the d=32 OU trajectory and observe it every ``obs_every``,
    drawing the path and the observation noise from ``generator`` (the
    port's draws: not the JAX example's bits, which ``load_observations``
    gives).

    ``noise_std`` adds i.i.d. Gaussian observation noise (x0 stays exact:
    the trainer pins it). Noiseless data makes any likelihood that claims a
    variance v > 0 misspecified; set ``noise_std = sqrt(claimed variance)``
    for a correctly specified benchmark.
    """
    sde = HighDimOU()
    device = generator.device
    x0 = 2.0 * torch.ones((1, STATE_DIM), device=device)
    theta = torch.tensor([[1.2, 0.8, 0.5]], device=device)
    traj = vtt.euler_maruyama(sde, x0, theta, 5.0, 0.01, generator=generator)
    idx = list(range(0, 501, round(obs_every / 0.01)))
    values = traj[0, idx]
    if noise_std > 0.0:
        noise = noise_std * torch.randn(values.shape, generator=generator, device=device)
        noise[0] = 0.0
        values = values + noise
    return vtt.Observations(times=[i * 0.01 for i in idx], values=values.cpu())


def main() -> None:
    console = vtt.Console()
    mesh = vtt.make_data_mesh()  # every rank, 1-D "data" axis
    console.print(f"data-parallel over {mesh.size()} devices")

    observations = load_observations("highdim_example")
    prior = vtt.Prior(type=vtt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3)

    posterior = vtt.infer(
        sde=HighDimOU(),
        observations=observations,
        observation_likelihood=vtt.GaussianObservationLikelihood(variance=0.1),
        prior=prior,
        time_horizon=5.0,
        config=vtt.InferenceConfig(
            training=vtt.TrainingConfig(
                time_step=0.05,
                batch_size=4096,  # global batch, split over the mesh
                n_iterations=5000,
            ),
            encoder=vtt.EncoderConfig(hidden_dim=256, num_heads=4, depth=8),
            head=vtt.HeadConfig(hidden_dim=64, num_layers=2),
            sde_param_positive_dims=[0, 2],
            console=console,
            param_names=["κ", "μ", "σ"],
            mesh=mesh,
        ),
    )

    summary = posterior.summary(n_samples=500)
    console.summary_table(summary, posterior.diagnostics(), param_names=["κ", "μ", "σ"])
    print("true params: (1.2, 0.8, 0.5)")
    posterior.save("highdim_ou_posterior.npz")


if __name__ == "__main__":
    main()
