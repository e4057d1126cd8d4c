"""The port's console (``viforsdes_tpu_torch/utils/console.py``), as
``tests/test_console.py`` holds the JAX package's: the live training panel,
its stats table, the pretrain panel, the config panel and the summary table
rendered into a recording rich console on a ``StringIO``, and a disabled
console that emits nothing. Summaries may hold tensors, as the port's do.
"""

from __future__ import annotations

import io
from types import SimpleNamespace

import numpy as np
import torch
from rich.console import Console as RichConsole

from viforsdes_tpu_torch import Console

COMPONENTS = {
    "observation_log_prob": -50.0,
    "sde_log_prob": -30.0,
    "generative_log_prob": -20.0,
    "prior_log_prob": -3.0,
    "posterior_log_prob": -2.0,
}


def _recording_console() -> Console:
    c = Console(enabled=True)
    c._rich = RichConsole(record=True, width=120, force_terminal=False, file=io.StringIO())
    return c


def test_training_progress_live_panel_renders_updates():
    c = _recording_console()
    with c.training_progress(
        n_iterations=20, update_interval=5, param_names=["kappa", "mu", "sigma"]
    ) as progress:
        for step in range(0, 20, 5):
            progress.update(step=step, loss=100.0 - step, elbo=-100.0 + step, best_elbo=-80.0,
                            components=COMPONENTS, grad_norm=1.23, param_means=np.array([1.2, 0.8, 0.5]))
    out = c._rich.export_text()
    assert "training complete" in out
    assert "it/s avg" in out


def test_training_progress_stats_table_contents():
    c = _recording_console()
    with c.training_progress(n_iterations=4, param_names=["kappa"], device=torch.device("cpu")) as progress:
        progress.update(step=2, loss=12.5, elbo=-12.5, best_elbo=-10.0,
                        components={"observation_log_prob": -5.0}, grad_norm=0.5,
                        param_means=np.array([1.5]))
        assert progress._stats["loss (smoothed)"] == "12.5000"
        assert progress._stats["best ELBO"] == "-10.00"
        assert "kappa=1.5" in progress._stats["posterior means"]
        assert "observation=-5.0" in progress._stats["components"]
        # device memory is read on a CUDA device only
        assert "device memory" not in progress._stats
        assert progress._render() is not None


def test_pretrain_progress_panel():
    c = _recording_console()
    with c.pretrain_progress(n_iterations=10) as progress:
        for step in range(10):
            progress.update(step, mse=1.0 / (step + 1), best_mse=0.05, sigma_median=0.4)
    assert progress.progress.tasks[0].completed == 10
    assert "pretrain" in c._rich.export_text()


def test_config_panel_and_summary_table_render():
    c = _recording_console()
    c.config_panel({"batch_size": 128, "time_step": 0.05})
    summary = SimpleNamespace(
        sde_parameter_mean=torch.tensor([1.2, 0.8]),
        sde_parameter_std=torch.tensor([0.1, 0.05]),
        sde_parameter_quantiles=SimpleNamespace(
            q05=torch.tensor([1.0, 0.7]), q50=torch.tensor([1.2, 0.8]), q95=torch.tensor([1.4, 0.9])),
    )
    diagnostics = SimpleNamespace(final_evidence_lower_bound=-42.0, n_iterations=1000)
    c.summary_table(summary, diagnostics, param_names=["kappa", "mu"])
    out = c._rich.export_text()
    assert "training config" in out
    assert "batch_size" in out
    assert "posterior summary" in out
    assert "kappa" in out and "[1.0000, 1.4000]" in out
    assert "final ELBO: -42.00" in out


def test_disabled_console_emits_nothing():
    c = Console(enabled=False)
    c._rich = RichConsole(record=True, width=120, file=io.StringIO())
    c.print("should not appear")
    c.config_panel({"a": 1})
    with c.training_progress(5) as p:
        p.update(step=1, loss=1.0, elbo=-1.0, best_elbo=-1.0, components={},
                 grad_norm=0.0, param_means=np.zeros(1))
    with c.pretrain_progress(5) as p:
        p.update(0, 1.0, 1.0, 1.0)
    c.summary_table(None, None)
    assert c._rich.export_text() == ""
