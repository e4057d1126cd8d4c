"""The diffusion-matched head (``HeadConfig(cholesky="matched")``) in the port,
against the JAX package's (``tests/test_head_matched.py``), in fp32 on the
CPU with the JAX head's weights and inputs drawn with numpy.

The transition scale is ``diag(dz/dx) @ g(to_state(z), theta) *
exp(softcap(c))``, built inside the recurrence from the user's diffusion, so
the mode runs a plain loop over time steps in both packages (no kernel).
Paths, means and Cholesky factors agree at rtol 1e-5, gradients (theta's
through the diffusion included) at rtol 1e-4 / atol 1e-5: fp32 on both
sides, summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import viforsdes_tpu_torch as tvt
from viforsdes_tpu.config import HeadConfig as JHeadConfig
from viforsdes_tpu.core.state_space import StateSpace as JStateSpace
from viforsdes_tpu.models.head import DiffusionTransitionHead as JHead
from viforsdes_tpu_torch.config import HeadConfig
from viforsdes_tpu_torch.core.state_space import StateSpace
from viforsdes_tpu_torch.models.head import DiffusionTransitionHead
from viforsdes_tpu_torch.utils.convert import params_from_numpy
from viforsdes_tpu_torch.utils.tree import tree_leaves, tree_map

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
CTX, PAR, D, HID, DT = 6, 3, 2, 8, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


class JaxVarSDE:
    """2-D SDE with a state- and theta-dependent non-diagonal diffusion, so
    every moving part of the matched scale is exercised (chain rule,
    off-diagonal, theta gradient); as in tests/test_head_matched.py."""

    state_dim = D
    sde_param_dim = PAR

    def drift(self, x, p):
        return p[..., 0:1] * (p[..., 1:2] - x)

    def diffusion(self, x, p):
        s = jax.nn.softplus(p[..., 2])
        d0 = 0.4 + 0.2 * jax.nn.sigmoid(x[..., 0])
        d1 = (0.3 + 0.1 * jax.nn.sigmoid(x[..., 1])) * s
        off = 0.05 * jnp.tanh(x[..., 0])
        L = jnp.zeros(x.shape[:-1] + (2, 2))
        L = L.at[..., 0, 0].set(d0)
        L = L.at[..., 1, 1].set(d1)
        return L.at[..., 1, 0].set(off)


class TorchVarSDE:
    state_dim = D
    sde_param_dim = PAR

    def drift(self, x, p):
        return p[..., 0:1] * (p[..., 1:2] - x)

    def diffusion(self, x, p):
        s = F.softplus(p[..., 2])
        d0 = 0.4 + 0.2 * torch.sigmoid(x[..., 0])
        d1 = (0.3 + 0.1 * torch.sigmoid(x[..., 1])) * s
        off = 0.05 * torch.tanh(x[..., 0])
        zero = torch.zeros_like(d0)
        return torch.stack([torch.stack([d0, zero], -1), torch.stack([off, d1], -1)], -2)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _heads(sampler="auto", num_layers=2):
    return (JHead(D, CTX, PAR, JHeadConfig(hidden_dim=HID, num_layers=num_layers, sampler=sampler,
                                           cholesky="matched")),
            DiffusionTransitionHead(D, CTX, PAR, HeadConfig(hidden_dim=HID, num_layers=num_layers,
                                                            sampler=sampler, cholesky="matched")))


def _params(j_head, seed, active=True):
    """The JAX head's init (as numpy), with random output weights when
    ``active`` (at init the zero ``out_proj`` makes every mean and correction
    zero)."""
    params = jax.tree.map(np.asarray, j_head.init(jax.random.key(seed)))
    if active:
        params["out_proj"]["w"] = 0.3 * _randn(seed + 1, *params["out_proj"]["w"].shape)
    return params


def _inputs(seed, B, T):
    # theta kept away from softplus(p2) ~ 0, so the DIAG_MIN clamp stays off
    return (_randn(seed, B, D), _randn(seed + 1, B, T, CTX),
            np.clip(_randn(seed + 2, B, PAR), -2.0, 2.0), _randn(seed + 3, T, B, D))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def test_matched_output_width_and_init():
    """d mean outputs and d log-corrections, all zero at init (exp(0) = 1:
    the bridge's diffusion is the SDE's), as the JAX head's."""
    j_head, head = _heads()
    params = head.init(torch.Generator().manual_seed(0))
    j_params = j_head.init(jax.random.key(0))
    assert head.n_tril == D
    assert params["out_proj"]["w"].shape == j_params["out_proj"]["w"].shape == (HID, 2 * D)
    assert not bool(params["out_proj"]["b"].any())
    np.testing.assert_array_equal(np.asarray(j_params["out_proj"]["b"]), 0.0)


def test_matched_rejects_pallas_sampler():
    with pytest.raises(ValueError, match="scan sampler") as port:
        DiffusionTransitionHead(D, CTX, PAR, HeadConfig(hidden_dim=HID, sampler="pallas", cholesky="matched"))
    with pytest.raises(ValueError) as jax_err:
        JHead(D, CTX, PAR, JHeadConfig(hidden_dim=HID, sampler="pallas", cholesky="matched"))
    assert str(port.value) == str(jax_err.value)


def test_matched_requires_sde_and_state_space():
    _, head = _heads()
    params = head.init(torch.Generator().manual_seed(0))
    x0, ctx, theta, noise = (_t(a) for a in _inputs(1, 3, 4))
    with pytest.raises(ValueError, match="needs sde"):
        head.sample_diffusion_paths(params, x0, ctx, theta, noise, DT)


def test_zero_init_bridge_equals_sde_diffusion():
    """At init the sampled scale is the chain-ruled SDE diffusion at the
    sampled states (diagonal clamped at DIAG_MIN), and the paths follow the
    Euler recurrence with it."""
    sde, space = TorchVarSDE(), StateSpace(D, positive_dims=[0])
    _, head = _heads()
    params = head.init(torch.Generator().manual_seed(0))
    x0, ctx, theta, noise = (_t(a) for a in _inputs(1, 4, 7))
    paths, means, chol = head.sample_diffusion_paths(params, x0, ctx, theta, noise, DT,
                                                     sde=sde, state_space=space)
    assert chol.shape == (4, 7, D, D)
    assert not bool(means.any())
    z_t = paths[:, :-1]
    theta_bt = theta[:, None, :].expand(4, 7, PAR)
    expected = space.latent_jacobian_diag(z_t)[..., None] * sde.diffusion(space.to_state(z_t), theta_bt)
    diag = torch.clamp(torch.diagonal(expected, dim1=-2, dim2=-1), min=1e-2)
    expected = torch.where(torch.eye(D, dtype=torch.bool), torch.diag_embed(diag), expected)
    np.testing.assert_allclose(chol.numpy(), expected.numpy(), rtol=1e-6, atol=1e-7)
    step = torch.einsum("btij,tbj->bti", chol, noise) * DT**0.5
    np.testing.assert_allclose(paths[:, 1:].numpy(), (z_t + step).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_layers,positive", [(2, [1]), (1, [0, 1]), (3, [])])
def test_matched_paths_match_jax(num_layers, positive):
    """Paths, means and Cholesky factors of the port's loop against the JAX
    scan on the same weights and inputs; the port's single-step ``forward``
    against JAX's along the way."""
    j_head, head = _heads(num_layers=num_layers)
    params = _params(j_head, seed=10 + num_layers)
    inputs = _inputs(20 + num_layers, 4, 6)
    j_out = j_head.sample_diffusion_paths(jax.tree.map(jnp.asarray, params), *map(jnp.asarray, inputs), DT,
                                          sde=JaxVarSDE(), state_space=JStateSpace(D, positive))
    t_params = params_from_numpy(params)
    x0, ctx, theta, noise = (_t(a) for a in inputs)
    sde, space = TorchVarSDE(), StateSpace(D, positive)
    out = head.sample_diffusion_paths(t_params, x0, ctx, theta, noise, DT, sde=sde, state_space=space)
    for a, b in zip(out, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VAL)

    hidden, j_hidden = None, None
    for t in range(6):
        z = out[0][:, t]
        mu, chol, hidden = head.forward(t_params, z, ctx[:, t], theta, hidden, sde=sde, state_space=space)
        j_mu, j_chol, j_hidden = j_head.forward(
            jax.tree.map(jnp.asarray, params), jnp.asarray(z.numpy()), jnp.asarray(inputs[1][:, t]),
            jnp.asarray(inputs[2]), j_hidden, sde=JaxVarSDE(), state_space=JStateSpace(D, positive))
        np.testing.assert_allclose(mu.numpy(), out[1][:, t].numpy(), **VAL)
        np.testing.assert_allclose(chol.numpy(), out[2][:, t].numpy(), **VAL)
        np.testing.assert_allclose(chol.numpy(), np.asarray(j_chol), **VAL)
        np.testing.assert_allclose(hidden.numpy(), np.asarray(j_hidden), **VAL)


def test_matched_gradients_match_jax():
    """Gradients of one loss over paths, means and Cholesky factors, with
    respect to every weight, x0, the context and theta (which reaches the
    scale through the SDE's diffusion), against ``jax.grad``."""
    j_head, head = _heads()
    params = _params(j_head, seed=30)
    inputs = _inputs(31, 3, 5)
    wp, wm = _randn(32, 3, 6, D), _randn(33, 3, 5, D)
    wc = np.cos(np.arange(3 * 5 * D * D)).reshape(3, 5, D, D).astype(np.float32)
    positive = [0]

    def j_loss(p, x0, ctx, theta, eps):
        paths, means, chol = j_head.sample_diffusion_paths(p, x0, ctx, theta, eps, DT, sde=JaxVarSDE(),
                                                           state_space=JStateSpace(D, positive))
        return (paths * wp).sum() + 0.7 * (means * wm).sum() + 0.3 * (chol * wc).sum()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2, 3))(jax.tree.map(jnp.asarray, params),
                                                     *map(jnp.asarray, inputs[:3]), jnp.asarray(inputs[3]))
    j_grads = [*jax.tree.leaves(j_grads[0]), *j_grads[1:]]

    t_params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(params))
    xs = [_t(a, grad=True) for a in inputs[:3]]
    paths, means, chol = head.sample_diffusion_paths(t_params, *xs, _t(inputs[3]), DT, sde=TorchVarSDE(),
                                                     state_space=StateSpace(D, positive))
    loss = (paths * _t(wp)).sum() + 0.7 * (means * _t(wm)).sum() + 0.3 * (chol * _t(wc)).sum()
    grads = torch.autograd.grad(loss, tree_leaves(t_params) + xs)
    assert len(grads) == len(j_grads)
    for a, b in zip(grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
    d_theta = grads[-1].numpy()
    assert np.all(np.abs(d_theta[:, 2]) > 1e-6)  # sigma-like: through the diffusion


def test_matched_theta_gradient_only_through_the_diffusion():
    """With the output projection at zero, the scale is theta's only road to
    the Cholesky factors, and VarSDE's diffusion reads p[..., 2] alone."""
    _, head = _heads()
    params = head.init(torch.Generator().manual_seed(0))
    x0, ctx, theta, noise = (_t(a) for a in _inputs(1, 3, 5))
    theta.requires_grad_()
    _, _, chol = head.sample_diffusion_paths(params, x0, ctx, theta, noise, DT, sde=TorchVarSDE(),
                                             state_space=StateSpace(D))
    (g,) = torch.autograd.grad(chol.sum(), theta)
    assert bool((g[:, 2].abs() > 1e-6).all())
    assert not bool(g[:, :2].any())


def test_matched_correction_is_softcapped():
    """A huge raw correction saturates at exp(CORR_CAP), not inf, as in the
    JAX head."""
    j_head, head = _heads()
    assert head.CORR_CAP == j_head.CORR_CAP
    space = StateSpace(D)
    z, theta = torch.zeros(3, D), torch.zeros(3, PAR)
    raw = torch.full((3, D), 1e4)
    capped = head.matched_chol(z, theta, raw, TorchVarSDE(), space)
    base = head.matched_chol(z, theta, torch.zeros_like(raw), TorchVarSDE(), space)
    np.testing.assert_allclose(capped.numpy(), base.numpy() * np.exp(head.CORR_CAP), rtol=1e-5)
    j_capped = j_head.matched_chol(jnp.zeros((3, D)), jnp.zeros((3, PAR)), jnp.full((3, D), 1e4),
                                   JaxVarSDE(), JStateSpace(D))
    np.testing.assert_allclose(capped.numpy(), np.asarray(j_capped), **VAL)


class PosOU:
    state_dim = 1
    sde_param_dim = 3

    def drift(self, x, p):
        return p[..., 0:1] * (p[..., 1:2] - x)

    def diffusion(self, x, p):
        return p[..., 2:3][..., None]


def test_matched_end_to_end_infer_and_posterior_io(tmp_path):
    """``infer()`` with the matched head (positive theta dims and a positive
    state dim: the full chain rule), then a posterior's summary, the refusal
    of a posterior without the SDE, and save -> load with ``sde=``."""
    obs = tvt.Observations(times=[0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
                           values=[[2.0], [1.5], [0.8], [1.2], [0.9], [1.1]])
    prior = tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3)
    posterior = tvt.infer(
        PosOU(), obs, tvt.GaussianObservationLikelihood(variance=0.1), prior, 5.0,
        tvt.InferenceConfig(
            training=tvt.TrainingConfig(time_step=0.25, batch_size=8, n_iterations=8),
            encoder=tvt.EncoderConfig(hidden_dim=32, cond_dim=32, num_heads=4, depth=2),
            head=tvt.HeadConfig(hidden_dim=16, num_layers=2, cholesky="matched"),
            sde_param_positive_dims=[0, 2],
            state_positive_dims=[0],
            pretrain=tvt.PretrainConfig(batch_size=64, sweep_candidates=256, cem_rounds=2),
            console=tvt.Console(enabled=False),
            device="cpu",
        ),
    )
    history = posterior.evidence_lower_bound_history
    # at batch 8 single steps can go non-finite in both packages (the guard
    # skips them); the JAX test holds the final ELBO, as here
    assert len(history) == 8 and np.isfinite(posterior.diagnostics().final_evidence_lower_bound)
    s = posterior.summary(n_samples=32)
    assert bool(torch.isfinite(s.sde_parameter_mean).all())
    assert s.diffusion_path_mean.shape == (21, 1)

    with pytest.raises(ValueError, match="needs the sde"):
        tvt.VariationalPosterior(posterior.model, posterior.params, posterior.ema_params,
                                 posterior.prior, obs, 5.0, 0.25, posterior.state_space, [])

    path = tmp_path / "matched.npz"
    posterior.save(path)
    with pytest.raises(ValueError, match="needs the sde"):
        tvt.VariationalPosterior.load(path, posterior.model, prior, obs)
    loaded = tvt.VariationalPosterior.load(path, posterior.model, prior, obs, sde=PosOU())
    for a, b in zip(tree_leaves(loaded.ema_params), tree_leaves(posterior.ema_params)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(loaded.evidence_lower_bound_history, history)
    assert bool(torch.isfinite(loaded.summary(n_samples=16).sde_parameter_mean).all())
