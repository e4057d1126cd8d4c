"""The port's training step against JAX ``trainer._step_math``, and a tiny CPU
``infer()``.

The JAX step draws from ``fold_in(train_key, step)``; the test reproduces
those draws with ``jax.random`` and injects them into the port's
``_step_math``. Params, EMA and step metrics are compared after one and three
steps. AdamW's first steps move each weight by about ``lr * sign(g)``: where
a gradient entry is tiny (|g| < 1e-7) its sign is rounding noise, so there
the two packages may step in opposite directions and the parameters are held
to ``2 * lr`` per step taken; elsewhere to rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viforsdes_tpu_torch as tvt
from viforsdes_tpu_torch.inference import trainer as trainer_mod
from viforsdes_tpu_torch.inference.optimizer import GROUPS
from viforsdes_tpu_torch.models.head import DiffusionTransitionHead
from viforsdes_tpu_torch.utils.tree import tree_items

from test_torch_elbo import BATCH, OBS_TIMES, OBS_VALUES, OU, flat_paths, jax_draws, make_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _micro_keys(key, accum):
    return [key] if accum == 1 else [jax.random.fold_in(key, i) for i in range(accum)]


def _tiny_grads(tt, draws):
    """Per leaf path: entries where the step's gradient is below 1e-7."""
    leaves = {g: tt.flat_params[g].detach().requires_grad_() for g in GROUPS}
    tree = tt.layout.unpack(leaves)
    total = sum(-tt._elbo_from_params(tree, e, n).evidence_lower_bound for e, n in draws)
    grads = torch.autograd.grad(total / len(draws), [leaves[g] for g in GROUPS])
    return {p: np.abs(g.numpy()) < 1e-7
            for p, g in tree_items(tt.layout.unpack(dict(zip(GROUPS, grads))))}


def _run_steps(jt, tt, n_steps):
    accum = tt.config.grad_accum_steps
    warmup = tt.config.theta_warmup_steps
    j_step = jax.jit(jt._step_math)
    small = {}  # leaf path -> entries whose gradient was tiny at some step
    for step in range(n_steps):
        key = jax.random.fold_in(jt._train_key, step)
        scale = None if warmup == 0 else (0.0 if step < warmup else 1.0)
        jt.params, jt.opt_state, jt.ema_params, j_m = j_step(
            jt.params, jt.opt_state, jt.ema_params, key,
            None if scale is None else jnp.float32(scale),
        )
        draws = [jax_draws(k, BATCH // accum, tt.config.iw_samples, tt.n_steps)
                 for k in _micro_keys(key, accum)]
        for path, tiny in _tiny_grads(tt, draws).items():
            small[path] = small.get(path, False) | tiny
        tt.flat_params, tt.opt_state, tt.flat_ema, t_m = tt._step_math(
            tt.flat_params, tt.opt_state, tt.flat_ema, draws, scale
        )
    return j_m, t_m, small


def _assert_params_close(t_tree, j_tree, small, lr_of, n_steps):
    t_flat = {p: v.detach().numpy() for p, v in tree_items(t_tree)}
    for path, ref in flat_paths(j_tree).items():
        got = t_flat[path]
        loose = small[path]
        np.testing.assert_allclose(got[~loose], ref[~loose], rtol=1e-4, atol=1e-6, err_msg=path)
        np.testing.assert_allclose(got[loose], ref[loose], rtol=0, atol=2 * lr_of(path) * n_steps * 1.01,
                                   err_msg=path)


def _lr_of(tt):
    return lambda path: (tt.config.sde_param_lr if path.split("/")[0] in ("theta", "obs")
                         else tt.config.learning_rate)


@pytest.mark.parametrize(
    "n_steps,training",
    [
        (1, {}),
        (3, {}),
        (3, {"grad_accum_steps": 2, "iw_samples": 2, "theta_warmup_steps": 2}),
    ],
)
def test_step_math_matches_jax(n_steps, training):
    jt, tt = make_pair(**training)
    j_m, t_m, small = _run_steps(jt, tt, n_steps)

    _assert_params_close(tt.params, jt.params, small, _lr_of(tt), n_steps)
    _assert_params_close(tt.ema_params, jt.ema_params, small, _lr_of(tt), n_steps)
    for name in ("elbo", "observation_log_prob", "sde_log_prob", "generative_log_prob",
                 "prior_log_prob", "posterior_log_prob", "grad_norm"):
        np.testing.assert_allclose(float(getattr(t_m, name)), float(getattr(j_m, name)), rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(t_m.param_means.numpy(), np.asarray(j_m.param_means), rtol=1e-4)
    assert int(t_m.notfinite_count) == int(j_m.notfinite_count) == 0
    assert int(tt.opt_state["count"]) == int(jt.opt_state.inner_state[1].inner_states["rest"].inner_state[0].count)


def test_non_finite_step_is_rejected_like_jax():
    jt, tt = make_pair()
    # poison one encoder weight in both: the ELBO and every gradient go NaN
    bridge = np.asarray(jt.params["encoder"]["bridge_token"]).copy()
    bridge[0] = np.nan
    jt.params["encoder"]["bridge_token"] = jnp.asarray(bridge)
    tt.params["encoder"]["bridge_token"][0] = float("nan")
    before = {g: p.clone() for g, p in tt.flat_params.items()}
    j_m, t_m, _ = _run_steps(jt, tt, 1)

    assert int(j_m.notfinite_count) == int(t_m.notfinite_count) == 1
    assert not np.isfinite(float(t_m.grad_norm))
    for g in before:  # params untouched, NaN included
        np.testing.assert_array_equal(tt.flat_params[g].numpy(), before[g].numpy())
    assert int(tt.opt_state["count"]) == 0
    assert all(float(m.abs().sum()) == 0.0 for m in tt.opt_state["mu"].values())
    t_ema = {p: v.numpy() for p, v in tree_items(tt.ema_params)}
    for path, ref in flat_paths(jt.ema_params).items():
        np.testing.assert_allclose(t_ema[path], ref, rtol=1e-6, atol=1e-7, err_msg=path)


def test_draws_depend_only_on_the_step():
    _, tt = make_pair()
    a, b = tt.draws(3), tt.draws(3)
    c = tt.draws(4)
    assert torch.equal(a[0][0], b[0][0]) and torch.equal(a[0][1], b[0][1])
    assert not torch.equal(a[0][1], c[0][1])


def _problem():
    return (
        OU(),
        tvt.Observations(times=OBS_TIMES, values=OBS_VALUES),
        tvt.GaussianObservationLikelihood(variance=0.1),
        tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
        2.0,
    )


def _config(**overrides):
    base = dict(
        training=tvt.TrainingConfig(time_step=0.1, batch_size=8, n_iterations=12),
        encoder=tvt.EncoderConfig(hidden_dim=32, cond_dim=16, num_heads=2, depth=2),
        head=tvt.HeadConfig(hidden_dim=16, num_layers=2),
        sde_param_positive_dims=[0, 2],
        console=tvt.Console(enabled=False),
        device="cpu",
    )
    return tvt.InferenceConfig(**{**base, **overrides})


def test_tiny_cpu_infer_and_summary():
    seen = []
    posterior = tvt.infer(*_problem(), _config(callback=lambda s, e: seen.append(s)))
    history = posterior.evidence_lower_bound_history
    assert len(history) == 12 and np.all(np.isfinite(history))
    assert seen == list(range(12))
    summary = posterior.summary(n_samples=40)
    assert summary.sde_parameter_mean.shape == (3,)
    assert summary.diffusion_path_mean.shape == (21, 1)
    for value in (summary.sde_parameter_mean, summary.sde_parameter_std,
                  summary.sde_parameter_quantiles.q05, summary.diffusion_path_std):
        assert bool(torch.isfinite(value).all())
    assert bool((summary.sde_parameter_quantiles.q05 <= summary.sde_parameter_quantiles.q95).all())


def test_divergence_aborts(monkeypatch):
    monkeypatch.setattr(trainer_mod, "MAX_CONSECUTIVE_NONFINITE_STEPS", 3)
    sde, obs, lik, prior, horizon = _problem()
    cfg = _config()
    tt = trainer_mod.VariationalInferenceTrainer(
        sde, obs, lik, prior, horizon, cfg.training, cfg.encoder, cfg.head, [], [0, 2],
        console=tvt.Console(enabled=False), device="cpu"
    )
    tt.params["encoder"]["bridge_token"][0] = float("nan")
    with pytest.raises(RuntimeError, match="diverged"):
        tt.train(update_interval=2)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_matched_head_refuses_the_pallas_sampler(device):
    """The diffusion-matched head runs the user's diffusion inside the
    recurrence, which no kernel does: ``sampler="pallas"`` is refused when the
    head is built, for any device, as in the JAX package."""
    head = tvt.HeadConfig(hidden_dim=16, num_layers=2, cholesky="matched", sampler="pallas")
    with pytest.raises(ValueError, match="requires the scan sampler"):
        DiffusionTransitionHead(1, 16, 3, head, device=torch.device(device))


def test_missing_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvt.infer(*_problem(), _config(device="cuda"))
