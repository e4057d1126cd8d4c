"""The plain reference of one training step: theta's reparameterized draw,
the encoder and the head's paths (``model.py``), the importance-weighted
ELBO and its five terms, the clipped and guarded two-group AdamW, the EMA.

- ELBO: ``log p(y|x) + log p(x|theta) - log q(z|y, theta) + log|dx/dz| +
  log p(theta) - log q(theta)``, the transitions Gaussian (the SDE's
  ``N(x + f dt, g g^T dt)``, the head's ``N(z + mu dt, L L^T dt)``); groups
  of ``iw`` paths share one theta and take ``logsumexp - log iw``.
- AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01): the gradient
  clipped to global norm ``grad_clip_norm``; a non-finite norm applies no
  update; theta's leaves at ``sde_param_lr``, every other leaf at
  ``learning_rate``; during the theta warmup theta's update is scaled by 0.
- EMA: ``e + (1 - 0.999) (p - e)`` after each update.
- Draws: step ``k`` draws theta's normals ``[B / iw, P]`` then the paths'
  ``[T, B, D]`` from a generator on the run's device seeded by
  ``stream_seed(seed, 1, k)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from portbench.reference import model as M
from portbench.reference.precision import Precision

B1, B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01
EMA_DECAY = 0.999


@dataclass
class Problem:
    """One configuration's inputs on a device, and its training recipe."""

    shapes: M.Shapes
    sde: object
    obs_times: np.ndarray
    obs_values: Tensor
    obs_variance: float
    prior_type: str  # "NORMAL" or "LOG_NORMAL"
    prior_mean: float
    prior_std: float
    param_positive: Tensor  # [P] bool
    state_positive: Tensor  # [D] bool
    time_step: float
    batch_size: int
    iw_samples: int
    grad_accum_steps: int
    learning_rate: float
    sde_param_lr: float
    grad_clip_norm: float
    theta_warmup_steps: int

    @property
    def n_steps(self) -> int:
        return self.shapes.n_grid - 1

    def obs_slots(self) -> Tensor:
        slots = np.minimum(np.round(self.obs_times / self.time_step).astype(np.int64), self.n_steps)
        return torch.as_tensor(slots, device=self.obs_values.device)

    def grid_times(self) -> Tensor:
        horizon = self.n_steps * self.time_step
        return torch.as_tensor(np.linspace(0.0, horizon, self.shapes.n_grid), dtype=torch.float32,
                               device=self.obs_values.device)


def stream_seed(seed: int, stream: int, step: int = 0) -> int:
    return int(np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0] >> 1)


def draws(pb: Problem, seed: int, step: int) -> list[tuple[Tensor, Tensor]]:
    """Theta's and the paths' standard normals of one step, per microbatch."""
    dev = pb.obs_values.device
    gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1, step))
    micro = pb.batch_size // pb.grad_accum_steps
    out = []
    for _ in range(pb.grad_accum_steps):
        eps = torch.randn((micro // pb.iw_samples, pb.shapes.param_dim), generator=gen, device=dev)
        noise = torch.randn((pb.n_steps, micro, pb.shapes.state_dim), generator=gen, device=dev)
        out.append((eps, noise))
    return out


# -------------------------------------------------------------------- ELBO


def to_state(pb: Problem, z: Tensor) -> Tensor:
    return torch.where(pb.state_positive, F.softplus(z), z)


def to_latent(pb: Problem, x: Tensor) -> Tensor:
    xp = torch.clamp(x, min=1e-6)
    return torch.where(pb.state_positive, xp + torch.log(-torch.expm1(-xp)), x)


def gaussian_log_prob(x: Tensor, mu: Tensor, L: Tensor) -> Tensor:
    """``log N(x; mu, L L^T)`` summed over time: ``[B, T, D] -> [B]``."""
    d = x.shape[-1]
    y = torch.linalg.solve_triangular(L, (x - mu)[..., None], upper=False)[..., 0]
    log_det = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
    return torch.sum(-0.5 * torch.sum(y * y, -1) - log_det - 0.5 * d * math.log(2 * math.pi), -1)


def prior_log_prob(pb: Problem, theta: Tensor) -> Tensor:
    if pb.prior_type == "LOG_NORMAL":
        lx = torch.log(theta)
        lp = (-0.5 * ((lx - pb.prior_mean) / pb.prior_std) ** 2 - math.log(pb.prior_std)
              - 0.5 * math.log(2 * math.pi) - lx)
    else:
        lp = (-0.5 * ((theta - pb.prior_mean) / pb.prior_std) ** 2 - math.log(pb.prior_std)
              - 0.5 * math.log(2 * math.pi))
    return torch.sum(lp, -1)


def elbo(pb: Problem, p: dict, eps: Tensor, noise: Tensor, prec: Precision) -> tuple[Tensor, Tensor]:
    """The ELBO of one microbatch and its five terms ``[5]`` (observation,
    SDE, generative, prior, posterior; means over the paths)."""
    s, dt, iw = pb.shapes, pb.time_step, pb.iw_samples
    theta = torch.repeat_interleave(M.theta_rsample(p, pb.param_positive, eps), iw, dim=0)
    bsz = noise.shape[1]
    x0 = pb.obs_values[0].expand(bsz, s.state_dim)
    context = M.encoder(p, s, pb.obs_slots(), pb.grid_times(), pb.obs_values, theta, prec)
    z, means, chol = M.sample_paths(p, s, to_latent(pb, x0), context[:, :-1], theta, noise, dt)
    x = to_state(pb, z)
    x_t, x_next, z_t, z_next = x[:, :-1], x[:, 1:], z[:, :-1], z[:, 1:]
    theta_bt = theta[:, None, :].expand(x_t.shape[:2] + (theta.shape[-1],))
    sde_lp = gaussian_log_prob(x_next, x_t + pb.sde.drift(x_t, theta_bt) * dt,
                               pb.sde.diffusion(x_t, theta_bt) * math.sqrt(dt))
    gen_lp = gaussian_log_prob(z_next, z_t + means * dt, chol * math.sqrt(dt))
    jac = torch.sum(torch.where(pb.state_positive, F.logsigmoid(z[:, 1:]), torch.zeros_like(z[:, 1:])), (-1, -2))
    diff = pb.obs_values[None] - x[:, pb.obs_slots()]
    var = pb.obs_variance
    obs_lp = torch.sum(-0.5 * diff ** 2 / var - 0.5 * math.log(2 * math.pi * var), (-1, -2))
    prior_lp = prior_log_prob(pb, theta)
    post_lp = M.theta_log_prob(p, pb.param_positive, theta)
    log_w = obs_lp + sde_lp - gen_lp + jac
    bound = torch.logsumexp(log_w.reshape(-1, iw), 1) - math.log(iw)
    value = (bound + (prior_lp - post_lp).reshape(-1, iw)[:, 0]).mean()
    terms = torch.stack([obs_lp.mean(), sde_lp.mean(), gen_lp.mean(), prior_lp.mean(), post_lp.mean()])
    return value, terms.detach()


# -------------------------------------------------------------------- step


@dataclass
class State:
    params: dict
    mu: dict
    nu: dict
    ema: dict
    count: int = 0


def init_state(params: dict) -> State:
    return State(
        params={k: v.clone() for k, v in params.items()},
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        ema={k: v.clone() for k, v in params.items()},
    )


@dataclass
class StepOut:
    elbo: float
    terms: list[float]
    clipped: dict  # each leaf's gradient as the optimizer takes it


def step(pb: Problem, st: State, step_draws: list[tuple[Tensor, Tensor]], theta_scale: float,
         prec: Precision, batch_keep: float = 1.0) -> StepOut:
    """One training step on ``st``, in place. ``batch_keep`` below 1 keeps
    that share of the importance groups (a fault for the checks)."""
    grads = {k: torch.zeros_like(v) for k, v in st.params.items()}
    values, terms = [], []
    with prec.matmul():
        for eps, noise in step_draws:
            if batch_keep < 1.0:
                g = max(1, int(eps.shape[0] * batch_keep))
                eps, noise = eps[:g], noise[:, :g * pb.iw_samples]
            leaves = {k: v.detach().requires_grad_() for k, v in st.params.items()}
            value, t = elbo(pb, leaves, eps, noise, prec)
            got = torch.autograd.grad(-value, list(leaves.values()), allow_unused=True)
            for (k, _), g_leaf in zip(leaves.items(), got):
                if g_leaf is not None:
                    grads[k] += g_leaf.detach()
            values.append(value.detach())
            terms.append(t)
    n = len(step_draws)
    grads = {k: g / n for k, g in grads.items()}
    value = torch.stack(values).mean()
    g_norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
    finite = bool(torch.isfinite(g_norm))
    scale = 1.0 if float(g_norm) < pb.grad_clip_norm else pb.grad_clip_norm / float(g_norm)
    clipped = {k: g * scale for k, g in grads.items()}
    if finite:
        st.count += 1
        bc1, bc2 = 1.0 - B1 ** st.count, 1.0 - B2 ** st.count
        with torch.no_grad():
            for k, g in clipped.items():
                st.mu[k] = (1 - B1) * g + B1 * st.mu[k]
                st.nu[k] = (1 - B2) * g * g + B2 * st.nu[k]
                theta = k.startswith("theta/")
                lr = pb.sde_param_lr if theta else pb.learning_rate
                upd = -lr * ((st.mu[k] / bc1) / (torch.sqrt(st.nu[k] / bc2) + ADAM_EPS)
                             + WEIGHT_DECAY * st.params[k])
                if theta:
                    upd = upd * theta_scale
                st.params[k] = st.params[k] + upd
                st.ema[k] = st.ema[k] + (1 - EMA_DECAY) * (st.params[k] - st.ema[k])
    return StepOut(
        elbo=float(value),
        terms=[float(v) for v in torch.stack(terms).mean(0)],
        clipped=clipped,
    )
