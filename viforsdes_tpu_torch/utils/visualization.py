"""Posterior plotting (twin of ``viforsdes_tpu/utils/visualization.py``): per
state dim, posterior path quantile bands (5-95% and 25-75%) with the median
and a few sample paths over the observations; per theta dim, a marginal
histogram annotated with the median and 90% interval; states on the top row,
parameters on the bottom. Plots numpy copies of the samples. ``matplotlib``
is imported by the call, so the port imports where it is absent.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from viforsdes_tpu_torch.core.observations import Observations
    from viforsdes_tpu_torch.posterior.posterior import VariationalPosteriorSamples

_N_SPAGHETTI = 5  # individual sample paths drawn on top of the bands


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_posterior(
    samples: "VariationalPosteriorSamples",
    observations: "Observations",
    time_horizon: float,
    show: bool = True,
):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    paths = _host(samples.diffusion_paths)  # [N, T+1, D]
    thetas = _host(samples.sde_parameters)  # [N, P]
    times = np.linspace(0.0, time_horizon, paths.shape[1])
    state_dim, param_dim = paths.shape[2], thetas.shape[1]

    obs_t = _host(observations.times)
    obs_v = _host(observations.values)

    n_cols = max(state_dim, param_dim)
    fig, axes = plt.subplots(2, n_cols, figsize=(3.6 * n_cols, 6.4), squeeze=False)

    q05, q25, q50, q75, q95 = np.quantile(paths, [0.05, 0.25, 0.5, 0.75, 0.95], axis=0)
    for d in range(state_dim):
        ax = axes[0][d]
        ax.fill_between(times, q05[:, d], q95[:, d], color="C0", alpha=0.15,
                        linewidth=0, label="5-95%")
        ax.fill_between(times, q25[:, d], q75[:, d], color="C0", alpha=0.3,
                        linewidth=0, label="25-75%")
        ax.plot(times, q50[:, d], color="C0", linewidth=1.5, label="median")
        for i in range(min(_N_SPAGHETTI, paths.shape[0])):
            ax.plot(times, paths[i, :, d], color="C0", alpha=0.25, linewidth=0.6)
        if obs_v.shape[-1] > d:
            ax.plot(obs_t, obs_v[:, d], "o", mfc="none", mec="black", ms=6,
                    mew=1.2, zorder=5, label="observations")
        ax.set_xlabel("time")
        ax.set_title(f"state[{d}] posterior paths", fontsize=10)
        if d == 0:
            ax.legend(fontsize=7, frameon=False)
    for d in range(state_dim, n_cols):
        axes[0][d].axis("off")

    for p in range(param_dim):
        ax = axes[1][p]
        vals = thetas[:, p]
        ax.hist(vals, bins="auto", density=True, color="C2", alpha=0.6,
                histtype="stepfilled", edgecolor="C2")
        lo, mid, hi = np.quantile(vals, [0.05, 0.5, 0.95])
        ax.axvline(mid, color="black", linewidth=1.2)
        ax.axvspan(lo, hi, color="black", alpha=0.06)
        ax.set_title(f"theta[{p}]  {mid:.3g}  [{lo:.3g}, {hi:.3g}]", fontsize=10)
        ax.set_yticks([])
    for p in range(param_dim, n_cols):
        axes[1][p].axis("off")

    fig.tight_layout()
    if show:
        plt.show()
    return fig
