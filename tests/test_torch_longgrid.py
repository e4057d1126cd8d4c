"""The long-grid (Lorenz-63) training path of the port against the JAX package.

A Lorenz-shaped problem past the flash threshold: 3-D state, T=6, dt=0.01
(601 grid tokens), batch 4, a ``LOG_NORMAL`` prior with every parameter
positive, fp32 compute, encoder 32 wide / cond 16 / 2 heads / 2 deep, GRU
head 16 x 2. The port takes its flash path (fused QK prep, flash attention,
their plain versions on the CPU); the JAX package on the CPU takes its dense
path, or with ``VIFORSDES_PAD_HOIST=force`` its padded token stream (601 ->
1024 tokens, the pad masked), which must equal the port's masked ragged tail.

Bars are those of ``tests/test_torch_elbo.py`` and ``tests/test_torch_train.py``:
the ELBO to 1e-4 relative, gradients to rtol 1e-4 / atol 1e-5 of their leaf's
largest value, one optimizer step's parameters to rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viforsdes_tpu as jvt
import viforsdes_tpu_torch as tvt
from viforsdes_tpu.inference.trainer import VariationalInferenceTrainer as JTrainer
from viforsdes_tpu.utils.console import Console
from viforsdes_tpu_torch.inference.optimizer import GROUPS
from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer as TTrainer
from viforsdes_tpu_torch.ops.flash_attention import use_flash_attention

from test_torch_elbo import assert_tree_close
from test_torch_train import _assert_params_close, _lr_of, _tiny_grads

HORIZON, DT, BATCH = 6.0, 0.01, 4
ENC = dict(hidden_dim=32, cond_dim=16, num_heads=2, depth=2)
HEAD = dict(hidden_dim=16, num_layers=2)
NOISE = 2.0
TRUE = (10.0, 28.0, 8.0 / 3.0)


class Lorenz63:
    """Stochastic Lorenz-63 on jnp or torch (``xp``), as examples/lorenz63.py."""

    state_dim = 3
    sde_param_dim = 3

    def __init__(self, xp):
        self.xp = xp

    def drift(self, x, p):
        s, r, b = p[..., 0], p[..., 1], p[..., 2]
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        return self.xp.stack([s * (x2 - x1), x1 * (r - x3) - x2, x1 * x2 - b * x3], -1)

    def diffusion(self, x, p):
        eye = self.xp.eye(3, dtype=x.dtype)
        return NOISE * self.xp.broadcast_to(eye, tuple(x.shape) + (3,))


def _observations():
    """Every 0.5 time units of one Euler-Maruyama path (numpy, seeded)."""
    rng = np.random.default_rng(17)
    x = np.array([1.0, 1.0, 25.0])
    traj = [x]
    for _ in range(round(HORIZON / DT)):
        drift = np.array([TRUE[0] * (x[1] - x[0]), x[0] * (TRUE[1] - x[2]) - x[1],
                          x[0] * x[1] - TRUE[2] * x[2]])
        x = x + drift * DT + NOISE * np.sqrt(DT) * rng.standard_normal(3)
        traj.append(x)
    idx = np.arange(0, len(traj), 50)
    return (idx * DT).tolist(), np.asarray(traj, np.float32)[idx]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def make_pair():
    """A JAX trainer and a port trainer holding the same weights."""
    times, values = _observations()
    training = dict(time_step=DT, batch_size=BATCH, n_iterations=3, compute_dtype="float32")
    jt = JTrainer(
        Lorenz63(jnp),
        jvt.Observations(times=times, values=values),
        jvt.GaussianObservationLikelihood(variance=1.0),
        jvt.Prior(type=jvt.PriorType.LOG_NORMAL, mean=1.0, std=1.5, dim=3),
        HORIZON,
        jvt.TrainingConfig(**training),
        jvt.EncoderConfig(**ENC),
        jvt.HeadConfig(**HEAD),
        state_positive_dims=[],
        sde_param_positive_dims=[0, 1, 2],
        console=Console(enabled=False),
    )
    # At init adaLN-Zero makes every SiT block the identity and the head's
    # zero out_proj hides the encoder from the ELBO: give both weights so
    # attention shapes the ELBO and gets a gradient
    params = jax.tree.map(lambda a: a, jt.params)
    for i, block in enumerate(params["encoder"]["sit"]["blocks"]):
        w = block["cond"]["net"]["w"]
        block["cond"]["net"]["w"] = 0.3 * jax.random.normal(jax.random.key(10 + i), w.shape, jnp.float32)
    w = params["head"]["out_proj"]["w"]
    params["head"]["out_proj"]["w"] = 0.1 * jax.random.normal(jax.random.key(9), w.shape, jnp.float32)
    jt.params = params
    jt.opt_state = jt.optimizer.init(jt.params)
    jt.ema_params = jax.tree.map(lambda a: a.copy(), params)
    tt = TTrainer(
        Lorenz63(torch),
        tvt.Observations(times=times, values=values),
        tvt.GaussianObservationLikelihood(variance=1.0),
        tvt.Prior(type=tvt.PriorType.LOG_NORMAL, mean=1.0, std=1.5, dim=3),
        HORIZON,
        tvt.TrainingConfig(**training),
        tvt.EncoderConfig(**ENC),
        tvt.HeadConfig(**HEAD),
        state_positive_dims=[],
        sde_param_positive_dims=[0, 1, 2],
        device="cpu",
    )
    tt.flat_params = tt.layout.pack(jax.tree.map(np.asarray, jt.params), tt.device)
    tt.opt_state = tt.optimizer.init(tt.flat_params)
    tt.flat_ema = {g: p.clone() for g, p in tt.flat_params.items()}
    return jt, tt


def jax_draws(key, n_steps):
    """The numbers JAX ``_elbo_from_params(params, key, BATCH)`` draws."""
    k_theta, k_path = jax.random.split(key)
    theta_eps = jax.random.normal(k_theta, (BATCH, 3), dtype=jnp.float32)
    noise = jax.random.normal(k_path, (n_steps, BATCH, 3), dtype=jnp.float32)
    return torch.from_numpy(np.array(theta_eps)), torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_the_port_takes_its_flash_path(pair):
    _, tt = pair
    assert tt.model.encoder.n_grid == 601
    assert use_flash_attention(tt.model.encoder.n_grid)


@pytest.mark.parametrize("pad_hoist", ["1", "force"])
def test_elbo_and_gradient_match_jax(pair, monkeypatch, pad_hoist):
    monkeypatch.setenv("VIFORSDES_PAD_HOIST", pad_hoist)
    jt, tt = pair
    key = jax.random.key(3)

    def j_elbo(p):
        res = jt._elbo_from_params(p, key, BATCH)
        return res.evidence_lower_bound, res

    (_, j_res), j_grads = jax.jit(jax.value_and_grad(j_elbo, has_aux=True))(jt.params)

    leaves = {g: tt.flat_params[g].detach().requires_grad_() for g in GROUPS}
    t_res = tt._elbo_from_params(tt.layout.unpack(leaves), *jax_draws(key, tt.n_steps))
    grads = torch.autograd.grad(t_res.evidence_lower_bound, [leaves[g] for g in GROUPS])

    assert np.isfinite(float(j_res.evidence_lower_bound))
    np.testing.assert_allclose(float(t_res.evidence_lower_bound.detach()),
                               float(j_res.evidence_lower_bound), rtol=1e-4)
    for t_c, j_c in zip(t_res.components, j_res.components):
        np.testing.assert_allclose(float(t_c.detach()), float(j_c), rtol=1e-4, atol=1e-4)
    t_grads = tt.layout.unpack(dict(zip(GROUPS, grads)))
    assert_tree_close(t_grads, j_grads, rtol=1e-4, atol_scale=1e-5)
    for block in t_grads["encoder"]["sit"]["blocks"]:  # the flash backward ran
        assert float(block["attn"]["qkv_proj"]["w"].abs().max()) > 0.0


def test_step_math_matches_jax():
    jt, tt = make_pair()
    key = jax.random.fold_in(jt._train_key, 0)
    jt.params, jt.opt_state, jt.ema_params, j_m = jax.jit(jt._step_math)(
        jt.params, jt.opt_state, jt.ema_params, key, None
    )
    draws = [jax_draws(key, tt.n_steps)]
    small = _tiny_grads(tt, draws)
    tt.flat_params, tt.opt_state, tt.flat_ema, t_m = tt._step_math(
        tt.flat_params, tt.opt_state, tt.flat_ema, draws, None
    )
    _assert_params_close(tt.params, jt.params, small, _lr_of(tt), 1)
    _assert_params_close(tt.ema_params, jt.ema_params, small, _lr_of(tt), 1)
    for name in ("elbo", "observation_log_prob", "sde_log_prob", "generative_log_prob",
                 "prior_log_prob", "posterior_log_prob", "grad_norm"):
        np.testing.assert_allclose(float(getattr(t_m, name)), float(getattr(j_m, name)), rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(t_m.param_means.numpy(), np.asarray(j_m.param_means), rtol=1e-4)
    assert int(t_m.notfinite_count) == int(j_m.notfinite_count) == 0


def test_euler_maruyama_matches_jax_with_positive_dims():
    rng = np.random.default_rng(2)
    x0 = np.full((3, 3), 0.1, np.float32)
    theta = np.array([[10.0, 28.0, 8.0 / 3.0], [5.0, 10.0, 1.0], [1.0, 2.0, 3.0]], np.float32)
    noise = rng.standard_normal((3, 200, 3)).astype(np.float32)
    want = jvt.euler_maruyama(Lorenz63(jnp), jnp.asarray(x0), jnp.asarray(theta), 2.0, DT,
                              positive_dims=[0, 2], noise=jnp.asarray(noise))
    got = tvt.euler_maruyama(Lorenz63(torch), torch.from_numpy(x0), torch.from_numpy(theta), 2.0, DT,
                             positive_dims=[0, 2], noise=torch.from_numpy(noise))
    assert got.shape == (3, 201, 3)
    assert bool((got[..., [0, 2]] == 1e-6).any())  # the clamp was taken
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_euler_maruyama_draws_from_its_generator():
    sde, x0, theta = Lorenz63(torch), torch.ones(2, 3), torch.tensor([TRUE, TRUE])
    a = tvt.euler_maruyama(sde, x0, theta, 0.5, DT, generator=torch.Generator().manual_seed(4))
    b = tvt.euler_maruyama(sde, x0, theta, 0.5, DT, generator=torch.Generator().manual_seed(4))
    assert a.shape == (2, 51, 3) and torch.equal(a, b) and bool(torch.isfinite(a).all())
    with pytest.raises(ValueError, match="noise"):
        tvt.euler_maruyama(sde, x0, theta, 0.5, DT)


def test_tiny_cpu_infer_at_601_tokens():
    times, values = _observations()
    posterior = tvt.infer(
        Lorenz63(torch),
        tvt.Observations(times=times, values=values),
        tvt.GaussianObservationLikelihood(variance=1.0),
        tvt.Prior(type=tvt.PriorType.LOG_NORMAL, mean=1.0, std=1.5, dim=3),
        HORIZON,
        tvt.InferenceConfig(
            training=tvt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=2),
            encoder=tvt.EncoderConfig(**ENC),
            head=tvt.HeadConfig(**HEAD),
            sde_param_positive_dims=[0, 1, 2],
            device="cpu",
        ),
    )
    history = posterior.evidence_lower_bound_history
    assert len(history) == 2 and np.all(np.isfinite(history))
    summary = posterior.summary(n_samples=8)
    assert summary.diffusion_path_mean.shape == (601, 3)
    assert bool((summary.sde_parameter_mean > 0).all())
    for value in (summary.sde_parameter_std, summary.diffusion_path_std):
        assert bool(torch.isfinite(value).all())
