"""Theta pretraining of the port (``VariationalInferenceTrainer.
pretrain_sde_parameters``) against the JAX package's, on the JAX package's
own draws.

The JAX methods draw from ``split(pretrain_key)``: the gradient method its
initial mean from the first key and step ``s``'s theta eps and path noise
from ``fold_in(second, s)`` (the noise from ``fold_in`` of that by 1); the
global method sweep chunk ``c``'s candidates from ``fold_in(first, c)`` and
CEM round ``r``'s normals from ``fold_in(second, r)``. The test replays them
with ``jax.random`` and hands them to the port through ``pretrain_draws``.
Both run in fp32 and round at other points (XLA contracts the Euler step
``x + f dt`` into one fused multiply-add), so the returned mean agrees to
rtol 1e-4 / atol 1e-5. The CEM rounds shrink the population until the
elites' scores differ by rounding alone; a parameter the score does not see
would then follow that rounding, so the squared-error objective is held on a
drift that holds every parameter (the NLL sees the OU diffusion too).
Observations are simulated with numpy from a seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viforsdes_tpu as jvt
import viforsdes_tpu_torch as tvt
from viforsdes_tpu.inference.trainer import VariationalInferenceTrainer as JTrainer
from viforsdes_tpu.utils.console import Console as JConsole
from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer as TTrainer

from test_torch_elbo import OU

DT, HORIZON = 0.05, 4.0
TRUE_OU = (2.0, 1.0, 0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


class Rotor:
    """2-D linear SDE with 3 parameters, on jnp or torch (``xp``): decay
    p0, rotation p1, noise p2 on both coordinates."""

    state_dim = 2
    sde_param_dim = 3

    def __init__(self, xp):
        self.xp = xp

    def drift(self, x, p):
        x1, x2 = x[..., 0], x[..., 1]
        return self.xp.stack([-p[..., 0] * x1 + p[..., 1] * x2, -p[..., 1] * x1 - p[..., 0] * x2], -1)

    def diffusion(self, x, p):
        return p[..., 2:3][..., None] * self.xp.eye(2, dtype=x.dtype)


class Cubic:
    """dx = (kappa (m - x) - c x^3) dt + 0.1 dW: every parameter in the drift."""

    state_dim = 1
    sde_param_dim = 3

    def drift(self, x, p):
        return p[..., 0:1] * (p[..., 1:2] - x) - p[..., 2:3] * x * x * x

    def diffusion(self, x, p):
        return 0.1 + 0.0 * x[..., None]


def _ou_observations(seed=3, x0=3.0, every=2, cubic=0.0):
    """One Euler-Maruyama path of OU(2, 1, 0.1) (less ``cubic`` x^3 in the
    drift) from x0, every ``every`` steps."""
    rng = np.random.default_rng(seed)
    kappa, m, sigma = TRUE_OU
    x = [x0]
    for _ in range(round(HORIZON / DT)):
        drift = kappa * (m - x[-1]) - cubic * x[-1] ** 3
        x.append(x[-1] + drift * DT + sigma * np.sqrt(DT) * rng.standard_normal())
    idx = np.arange(0, len(x), every)
    return (idx * DT).tolist(), np.asarray(x, np.float32)[idx, None]


def _rotor_observations():
    """The first coordinate of one Rotor(0.5, 2, 0.3) path from (1, 0)."""
    rng = np.random.default_rng(11)
    x = np.array([1.0, 0.0])
    traj = [x]
    for _ in range(round(HORIZON / DT)):
        drift = np.array([-0.5 * x[0] + 2.0 * x[1], -2.0 * x[0] - 0.5 * x[1]])
        x = x + drift * DT + 0.3 * np.sqrt(DT) * rng.standard_normal(2)
        traj.append(x)
    idx = np.arange(0, len(traj), 5)
    return (idx * DT).tolist(), np.asarray(traj, np.float32)[idx, :1]


def make_pair(problem="ou", prior_type="NORMAL"):
    """A JAX trainer and a port trainer on one pretraining problem."""
    pair = []
    sdes = {"ou": (OU(), OU()), "cubic": (Cubic(), Cubic()), "partial_obs": (Rotor(jnp), Rotor(torch))}[problem]
    for vt, sde, extra in ((jvt, sdes[0], {"console": JConsole(enabled=False)}),
                           (tvt, sdes[1], {"console": tvt.Console(enabled=False), "device": "cpu"})):
        if problem != "partial_obs":
            times, values = _ou_observations(cubic=0.3 if problem == "cubic" else 0.0)
            lik = vt.GaussianObservationLikelihood(variance=0.01)
            x0 = None
        else:
            times, values = _rotor_observations()
            lik = vt.GaussianObservationLikelihood(variance=0.01, obs_matrix=[[1.0, 0.0]])
            x0 = [1.0, 0.0]
        trainer_cls = JTrainer if vt is jvt else TTrainer
        pair.append(trainer_cls(
            sde, vt.Observations(times=times, values=values), lik,
            vt.Prior(type=getattr(vt.PriorType, prior_type), mean=0.0, std=1.0, dim=3), HORIZON,
            vt.TrainingConfig(time_step=DT, batch_size=8, n_iterations=1),
            vt.EncoderConfig(hidden_dim=16, cond_dim=16, num_heads=2, depth=1),
            vt.HeadConfig(hidden_dim=8, num_layers=2),
            state_positive_dims=[], sde_param_positive_dims=[0, 2], x0=x0, **extra,
        ))
    return pair


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def replay_gradient_draws(jt, cfg):
    """The draws of JAX ``_pretrain_gradient``, as ``pretrain_draws``."""
    k_init, k_loop = jax.random.split(jt._pretrain_key)
    d, n_steps = jt.sde.sde_param_dim, round(HORIZON / DT)

    def draws(kind, index, shape, low=None, high=None):
        if kind == "init":
            out = jax.random.normal(k_init, (d,), dtype=jnp.float32)
        else:
            key = jax.random.fold_in(k_loop, index)
            if kind == "theta":
                out = jax.random.normal(key, (cfg.batch_size, d), dtype=jnp.float32)
            else:
                out = jax.random.normal(jax.random.fold_in(key, 1),
                                        (cfg.batch_size, n_steps, jt.sde.state_dim), dtype=jnp.float32)
        assert tuple(out.shape) == tuple(shape), (kind, shape)
        return _t(out)

    return draws


def replay_global_draws(jt, cfg):
    """The draws of JAX ``_pretrain_global``: the box and the keys as it
    makes them."""
    d = jt.sde.sde_param_dim
    pos_mask = np.zeros(d, dtype=bool)
    pos_mask[jt.sde_param_positive_dims] = True
    m, s = jt.prior.mean, jt.prior.std
    if jt.prior.type.name == "LOG_NORMAL":
        lo_pos, hi_pos = m - 3.0 * s - 3.0, m + 3.0 * s
    else:
        hi_pos = float(np.log(max(m + 3.0 * s, 1e-2)))
        lo_pos = hi_pos - 7.0
    lo = jnp.where(pos_mask, lo_pos, m - 3.0 * s)
    hi = jnp.where(pos_mask, hi_pos, m + 3.0 * s)
    k_sweep, k_cem = jax.random.split(jt._pretrain_key)

    def draws(kind, index, shape, low=None, high=None):
        if kind == "sweep":
            np.testing.assert_allclose(low.numpy(), np.asarray(lo), rtol=1e-7)
            np.testing.assert_allclose(high.numpy(), np.asarray(hi), rtol=1e-7)
            out = jax.random.uniform(jax.random.fold_in(k_sweep, index), (cfg.batch_size, d),
                                     minval=lo, maxval=hi, dtype=jnp.float32)
        else:
            out = jax.random.normal(jax.random.fold_in(k_cem, index), (cfg.batch_size, d), dtype=jnp.float32)
        assert tuple(out.shape) == tuple(shape), (kind, shape)
        return _t(out)

    return draws


@pytest.mark.parametrize("problem", ["ou", "partial_obs"])
def test_gradient_method_matches_jax(problem):
    jt, tt = make_pair(problem)
    cfg = dict(n_iterations=10, batch_size=64, method="gradient")
    j_mu = jt.pretrain_sde_parameters(jvt.PretrainConfig(**cfg))
    tt.pretrain_draws = replay_gradient_draws(jt, tvt.PretrainConfig(**cfg))
    t_mu = tt.pretrain_sde_parameters(tvt.PretrainConfig(**cfg))
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(j_mu), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("objective,problem", [("nll", "ou"), ("mse", "cubic")])
@pytest.mark.parametrize("prior_type", ["NORMAL", "LOG_NORMAL"])
def test_global_method_matches_jax(objective, problem, prior_type):
    jt, tt = make_pair(problem, prior_type)
    cfg = dict(batch_size=512, sweep_candidates=4096, cem_rounds=10, global_objective=objective)
    j_mu = jt.pretrain_sde_parameters(jvt.PretrainConfig(**cfg))
    tt.pretrain_draws = replay_global_draws(jt, tvt.PretrainConfig(**cfg))
    t_mu = tt.pretrain_sde_parameters(tvt.PretrainConfig(**cfg))
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(j_mu), rtol=1e-4, atol=1e-5)


def test_global_needs_the_full_state_and_auto_dispatches():
    _, tt = make_pair("partial_obs")
    with pytest.raises(ValueError, match="full-state"):
        tt.pretrain_sde_parameters(tvt.PretrainConfig(n_iterations=2, batch_size=4, method="global"))
    # auto takes the gradient method under partial observation ...
    mu = tt.pretrain_sde_parameters(tvt.PretrainConfig(n_iterations=2, batch_size=4))
    assert mu.shape == (3,) and bool(torch.isfinite(mu).all())
    # ... and the global one when the whole state is observed
    _, tt = make_pair("ou")
    called = []
    tt._pretrain_global = lambda *args: called.append("global") or torch.zeros(3)
    tt._pretrain_gradient = lambda *args: called.append("gradient") or torch.zeros(3)
    tt.pretrain_sde_parameters(tvt.PretrainConfig())
    tt.pretrain_sde_parameters(tvt.PretrainConfig(method="gradient"))
    assert called == ["global", "gradient"]


def test_global_method_recovers_the_ou_parameters():
    """As tests/test_inference.py's recovery case, on the port's own draws:
    the NLL segment score identifies the drift and the diffusion."""
    _, tt = make_pair("ou")
    mu = tt.pretrain_sde_parameters(tvt.PretrainConfig(batch_size=512, sweep_candidates=4096, cem_rounds=10))
    kappa, m, sigma = float(torch.exp(mu[0])), float(mu[1]), float(torch.exp(mu[2]))
    assert abs(kappa - TRUE_OU[0]) < 0.5, kappa
    assert abs(m - TRUE_OU[1]) < 0.25, m
    assert 0.5 * TRUE_OU[2] < sigma < 2.0 * TRUE_OU[2], sigma


def test_pretrain_draws_depend_only_on_kind_and_index():
    _, tt = make_pair("ou")
    a, b = tt.pretrain_draws("cem", 2, (4, 3)), tt.pretrain_draws("cem", 2, (4, 3))
    assert torch.equal(a, b)
    assert not torch.equal(a, tt.pretrain_draws("cem", 3, (4, 3)))
    assert not torch.equal(a, tt.pretrain_draws("init", 2, (4, 3)))
    lo, hi = torch.tensor([-1.0, 0.0, 2.0]), torch.tensor([1.0, 0.5, 3.0])
    z = tt.pretrain_draws("sweep", 0, (1000, 3), lo, hi)
    assert bool((z >= lo).all()) and bool((z < hi).all())


def test_set_theta_mean_resets_the_moments_and_leaves_the_ema():
    _, tt = make_pair("ou")
    tt.config = tt.config.model_copy(update={"n_iterations": 2})
    tt.train()
    ema = {g: v.clone() for g, v in tt.flat_ema.items()}
    assert float(tt.opt_state["mu"]["theta"].abs().sum()) > 0
    mean = torch.tensor([0.5, -0.25, 1.0])
    tt.set_theta_mean(mean)
    assert torch.equal(tt.params["theta"]["mean"], mean)
    assert int(tt.opt_state["count"]) == 0
    for moments in (tt.opt_state["mu"], tt.opt_state["nu"]):
        assert all(float(v.abs().sum()) == 0.0 for v in moments.values())
    for g, v in ema.items():
        assert torch.equal(tt.flat_ema[g], v)
