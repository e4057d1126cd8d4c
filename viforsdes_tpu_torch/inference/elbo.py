"""Reparameterized Monte-Carlo evidence lower bound (twin of
``viforsdes_tpu/inference/elbo.py``):

  ELBO = E_q[log p(y|x)] + E_q[log p(x|theta)] - E_q[log q(z|y,theta)]
         + logJac + log p(theta) - log q(theta),  mean over batch

with the true-SDE transition ``N(x_t + f dt, g g^T dt)``, the variational
transition from the head's outputs in z-space, static observation indices
``clamp(round(t/dt), max=n_steps)``, and the importance-weighted bound for
``iw_samples > 1``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from viforsdes_tpu_torch.core.observations import ObservationLikelihood
from viforsdes_tpu_torch.core.priors import Prior
from viforsdes_tpu_torch.core.sde import SDE
from viforsdes_tpu_torch.inference.types import (
    DiffusionPathSample,
    EvidenceLowerBoundComponents,
    EvidenceLowerBoundResult,
)
from viforsdes_tpu_torch.models.theta_posterior import ThetaPosterior

_LOG_2PI = math.log(2.0 * math.pi)


def tril_solve_unrolled(L: Tensor, b: Tensor) -> Tensor:
    """Solve ``L y = b`` for lower-triangular ``L [..., D, D]``, ``b [..., D]``,
    unrolled over the static (small) D."""
    ys: list[Tensor] = []
    for i in range(b.shape[-1]):
        acc = b[..., i]
        for j in range(i):
            acc = acc - L[..., i, j] * ys[j]
        ys.append(acc / L[..., i, i])
    return torch.stack(ys, dim=-1)


def gaussian_log_prob(x: Tensor, mu: Tensor, L: Tensor) -> Tensor:
    """``log N(x; mu, L L^T)`` summed over time: ``[B,T,D] -> [B]``. ``L`` is
    lower-triangular ``[..., D, D]`` or a diagonal scale ``[..., D]``."""
    d = x.shape[-1]
    if L.ndim == x.ndim:
        y = (x - mu) / L
        per_step = (
            -0.5 * torch.sum(y * y, dim=-1)
            - torch.sum(torch.log(L), dim=-1)
            - 0.5 * d * _LOG_2PI
        )
        return torch.sum(per_step, dim=-1)
    if d <= 4:
        y = tril_solve_unrolled(L, x - mu)
    else:
        y = torch.linalg.solve_triangular(L, (x - mu)[..., None], upper=False)[..., 0]
    log_det = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    per_step = -0.5 * torch.sum(y * y, dim=-1) - log_det - 0.5 * d * _LOG_2PI
    return torch.sum(per_step, dim=-1)


def observation_indices(
    obs_times: np.ndarray, time_step: float, n_steps: int
) -> np.ndarray:
    """Static observation grid indices."""
    return np.minimum(
        np.round(np.asarray(obs_times) / time_step).astype(np.int64), n_steps
    )


def compute_evidence_lower_bound(
    sde: SDE,
    observation_likelihood: ObservationLikelihood,
    prior: Prior,
    theta_posterior: ThetaPosterior,
    theta_params: dict,
    sde_parameters: Tensor,
    sample: DiffusionPathSample,
    time_step: float,
    *,
    obs_indices: Tensor,
    obs_values: Tensor,
    iw_samples: int = 1,
    obs_variance: Tensor | None = None,
) -> EvidenceLowerBoundResult:
    """``obs_indices`` and ``obs_values`` are the observation slots and values
    on the samples' device (the JAX signature's ``observations``, resolved
    once by the caller)."""
    z = sample.z.float()
    x = sample.x.float()
    sqrt_dt = time_step**0.5
    dt = time_step

    z_t, z_next = z[:, :-1], z[:, 1:]
    x_t, x_next = x[:, :-1], x[:, 1:]

    theta_bt = sde_parameters[:, None, :].expand(x_t.shape[:2] + (sde_parameters.shape[-1],))
    drift = sde.drift(x_t, theta_bt)
    diffusion = sde.diffusion(x_t, theta_bt)

    sde_log_prob = gaussian_log_prob(x_next, x_t + drift * dt, diffusion * sqrt_dt)
    gen_log_prob = gaussian_log_prob(
        z_next,
        z_t + sample.transition_means * dt,
        sample.transition_cholesky * sqrt_dt,
    )
    jacobian = sample.log_jacobian()

    x_at_obs = x[:, obs_indices]
    obs_broadcast = obs_values[None].expand((x.shape[0],) + tuple(obs_values.shape))
    if obs_variance is not None:
        obs_log_prob = observation_likelihood.log_prob(
            obs_broadcast, x_at_obs, variance=obs_variance
        ).sum(dim=-1)
    else:
        obs_log_prob = observation_likelihood.log_prob(obs_broadcast, x_at_obs).sum(dim=-1)

    prior_log_prob = prior.log_prob(sde_parameters)
    posterior_log_prob = theta_posterior.log_prob(theta_params, sde_parameters)

    log_w = obs_log_prob + sde_log_prob - gen_log_prob + jacobian
    if iw_samples > 1:
        # batch = batch/K contiguous groups of K paths sharing one theta
        k = iw_samples
        iw_bound = torch.logsumexp(log_w.reshape(-1, k), dim=1) - math.log(k)
        theta_terms = (prior_log_prob - posterior_log_prob).reshape(-1, k)[:, 0]
        elbo_mean = (iw_bound + theta_terms).mean()
    else:
        elbo_mean = (log_w + prior_log_prob - posterior_log_prob).mean()

    return EvidenceLowerBoundResult(
        evidence_lower_bound=elbo_mean,
        components=EvidenceLowerBoundComponents(
            observation_log_prob=obs_log_prob.mean(),
            sde_log_prob=sde_log_prob.mean(),
            generative_log_prob=gen_log_prob.mean(),
            prior_log_prob=prior_log_prob.mean(),
            posterior_log_prob=posterior_log_prob.mean(),
        ),
    )
