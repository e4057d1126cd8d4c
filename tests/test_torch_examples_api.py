"""The calls the JAX package's examples make (``examples/*.py``), on the port
at a tiny size on the CPU: ``infer()`` with ``console=``, ``param_names=``
and ``pretrain=``, then ``summary``, ``diagnostics``, the console's
``summary_table``, ``plot(show=False)`` and ``save`` -> ``load``. Two shapes:
the OU example (full state: the global pretrain) and the SIR example
(partial observation through ``obs_matrix`` with an explicit ``x0``: the
gradient pretrain).
"""

import io

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from rich.console import Console as RichConsole

import viforsdes_tpu_torch as tvt
from viforsdes_tpu_torch.utils.tree import tree_items

from test_torch_elbo import OU

POPULATION = 1000.0


class SIR:
    """examples/sir_epidemic.py's chemical-Langevin SIR, on torch."""

    state_dim = 2
    sde_param_dim = 2

    def drift(self, x, p):
        s, i = x[..., 0], x[..., 1]
        infection = p[..., 0] * s * i / POPULATION
        return torch.stack([-infection, infection - p[..., 1] * i], dim=-1)

    def diffusion(self, x, p):
        s, i = x[..., 0], x[..., 1]
        a = torch.clamp(p[..., 0] * s * i / POPULATION, min=1e-6)
        b = torch.clamp(p[..., 1] * i, min=1e-6)
        zeros = torch.zeros_like(a)
        row0 = torch.stack([torch.sqrt(a), zeros], dim=-1)
        row1 = torch.stack([-torch.sqrt(a), torch.sqrt(b)], dim=-1)
        return torch.stack([row0, row1], dim=-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _ou():
    obs = tvt.Observations(times=[0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
                           values=[[2.0], [1.5], [0.8], [1.2], [0.9], [1.1]])
    return (OU(), obs, tvt.GaussianObservationLikelihood(variance=0.1),
            tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3), 5.0,
            dict(sde_param_positive_dims=[0, 2], param_names=["κ", "μ", "σ"]))


def _sir():
    obs = tvt.Observations(times=[0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0],
                           values=[[5.0], [14.0], [42.0], [95.0], [155.0], [170.0], [130.0], [85.0], [50.0]])
    return (SIR(), obs, tvt.GaussianObservationLikelihood(variance=4.0, obs_matrix=[[0.0, 1.0]]),
            tvt.Prior(type=tvt.PriorType.LOG_NORMAL, mean=0.0, std=1.0, dim=2), 8.0,
            dict(state_positive_dims=[0, 1], sde_param_positive_dims=[0, 1], param_names=["β", "γ"],
                 x0=torch.tensor([POPULATION - 5.0, 5.0])))


@pytest.mark.parametrize("example", ["ou", "sir"])
def test_example_calls_run_on_the_port(example, tmp_path):
    sde, obs, lik, prior, horizon, extra = _ou() if example == "ou" else _sir()
    history_seen = []
    posterior = tvt.infer(sde, obs, lik, prior, horizon, tvt.InferenceConfig(
        training=tvt.TrainingConfig(time_step=0.25, batch_size=16, n_iterations=4),
        encoder=tvt.EncoderConfig(hidden_dim=16, cond_dim=16, num_heads=2, depth=1),
        head=tvt.HeadConfig(hidden_dim=8, num_layers=2),
        console=tvt.Console(enabled=False),
        pretrain=tvt.PretrainConfig(n_iterations=5, batch_size=32),
        callback=lambda step, elbo: history_seen.append(step),
        device="cpu",
        **extra,
    ))
    p_dim, d = sde.sde_param_dim, sde.state_dim

    summary = posterior.summary(n_samples=20)
    assert tuple(summary.sde_parameter_mean.shape) == (p_dim,)
    assert tuple(summary.diffusion_path_mean.shape) == (round(horizon / 0.25) + 1, d)
    assert bool(torch.isfinite(summary.sde_parameter_mean).all())
    diag = posterior.diagnostics()
    assert diag.n_iterations == 4 and history_seen == [0, 1, 2, 3]
    assert diag.final_evidence_lower_bound == posterior.evidence_lower_bound_history[-1]
    assert np.isfinite(diag.final_evidence_lower_bound)

    console = tvt.Console()
    console._rich = RichConsole(record=True, width=120, file=io.StringIO())
    console.summary_table(summary, diag, param_names=extra["param_names"])
    out = console._rich.export_text()
    assert "posterior summary" in out and extra["param_names"][0] in out and "4 iterations" in out

    fig = posterior.plot(n_trajectories=6, show=False)
    assert len(fig.axes) == 2 * max(d, p_dim)
    fig.savefig(tmp_path / "posterior.png", dpi=40)
    plt.close(fig)

    posterior.save(tmp_path / "posterior.npz")
    loaded = tvt.VariationalPosterior.load(tmp_path / "posterior.npz", posterior.model, prior, obs)
    assert loaded.evidence_lower_bound_history == posterior.evidence_lower_bound_history
    assert torch.equal(loaded._x0_single, posterior._x0_single)
    for (path, a), (_, b) in zip(tree_items(loaded.ema_params), tree_items(posterior.ema_params)):
        assert torch.equal(a, b), path
    again = loaded.summary(n_samples=20)
    assert bool(torch.isfinite(again.sde_parameter_mean).all())
