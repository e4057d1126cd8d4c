"""Encoder -> path sampler -> ELBO of the port against the JAX package's
trainer, on the JAX trainer's own initial weights and the very draws its
``_elbo_from_params`` makes from a key (reproduced with ``jax.random`` and
injected into the port).

ELBO and its components agree to 1e-4 relative (the bar of
``tests/test_reference_parity.py``); gradients to rtol 1e-4 / atol 1e-5 of
the largest gradient of their leaf (fp32 on both sides; ELBOs of ~1e3 summed
in another order leave absolute noise on the small entries). With bf16
encoder activations, both sides round at the same points but in other
kernels, so the ELBO agrees to 2e-2 relative.
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
from viforsdes_tpu_torch.utils.tree import tree_items

# dx = kappa (mu - x) dt + sigma dW: the example's class, whose code runs on
# jnp arrays and torch tensors alike
from examples_torch.ornstein_uhlenbeck import OrnsteinUhlenbeck as OU

OBS_TIMES = [0.0, 0.5, 1.0, 1.5, 2.0]
OBS_VALUES = [[2.0], [1.5], [0.8], [1.2], [0.9]]
HORIZON, DT, BATCH = 2.0, 0.1, 8
ENC = dict(hidden_dim=32, cond_dim=16, num_heads=2, depth=2)
HEAD = dict(hidden_dim=16, num_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def make_pair(*, state_positive_dims=(), theta_perturb=False, encoder_perturb=False, mesh=None,
              **training):
    """A JAX trainer and a port trainer holding the same weights.
    ``encoder_perturb`` gives the SiT modulators and the head's output
    projection weights: at init adaLN-Zero makes every block the identity and
    the zero out_proj hides the encoder from the ELBO, so every encoder
    gradient would be zero. ``mesh`` goes to the JAX trainer."""
    training = {"time_step": DT, "batch_size": BATCH, "n_iterations": 3,
                "compute_dtype": "float32", **training}
    variance = 0.1
    jt = JTrainer(
        OU(),
        jvt.Observations(times=OBS_TIMES, values=OBS_VALUES),
        jvt.GaussianObservationLikelihood(variance=variance),
        jvt.Prior(type=jvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
        HORIZON,
        jvt.TrainingConfig(**training),
        jvt.EncoderConfig(**ENC),
        jvt.HeadConfig(**HEAD),
        state_positive_dims=list(state_positive_dims),
        sde_param_positive_dims=[0, 2],
        console=Console(enabled=False),
        mesh=mesh,
    )
    if theta_perturb:  # leave the zero-init so the coupling is exercised
        params = jax.tree.map(lambda a: a, jt.params)
        params["theta"]["tril"] = jnp.asarray(np.tril(np.full((3, 3), 0.3, np.float32), -1))
        params["theta"]["mean"] = jnp.asarray([0.2, -0.1, 0.1], jnp.float32)
        jt.params = params
        jt.opt_state = jt.optimizer.init(jt.params)
        jt.ema_params = jax.tree.map(lambda a: a.copy(), params)
    if encoder_perturb:
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
        OU(),
        tvt.Observations(times=OBS_TIMES, values=OBS_VALUES),
        tvt.GaussianObservationLikelihood(variance=variance),
        tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
        HORIZON,
        tvt.TrainingConfig(**training),
        tvt.EncoderConfig(**ENC),
        tvt.HeadConfig(**HEAD),
        state_positive_dims=list(state_positive_dims),
        sde_param_positive_dims=[0, 2],
        device="cpu",
    )
    tt.flat_params = tt.layout.pack(jax.tree.map(np.asarray, jt.params), tt.device)
    tt.opt_state = tt.optimizer.init(tt.flat_params)
    tt.flat_ema = {g: p.clone() for g, p in tt.flat_params.items()}
    return jt, tt


def jax_draws(key, batch, iw, n_steps):
    """The numbers JAX ``_elbo_from_params(params, key, batch)`` draws."""
    k_theta, k_path = jax.random.split(key)
    theta_eps = jax.random.normal(k_theta, (batch // iw, 3), dtype=jnp.float32)
    noise = jax.random.normal(k_path, (n_steps, batch, 1), dtype=jnp.float32)
    return torch.from_numpy(np.array(theta_eps)), torch.from_numpy(np.array(noise))


def flat_paths(tree):
    return {path: np.asarray(leaf) for path, leaf in tree_items(tree)}


def assert_tree_close(t_tree, j_tree, rtol, atol_scale):
    t_flat = {p: v.detach().numpy() for p, v in tree_items(t_tree)}
    j_flat = flat_paths(j_tree)
    assert set(t_flat) == set(j_flat)
    for path, ref in j_flat.items():
        atol = atol_scale * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(t_flat[path], ref, rtol=rtol, atol=atol, err_msg=path)


CASES = {
    "mean_field": {},
    "iw2": {"iw_samples": 2},
    "full_cov_positive_state": {"theta_full_covariance": True, "state_positive_dims": [0],
                                "theta_perturb": True},
    "learned_obs_variance": {"learn_obs_variance": True},
    "annealed_obs_variance": {"obs_variance_final": 0.01, "obs_variance_anneal_steps": 10},
    "encoder_in_the_gradient": {"encoder_perturb": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_elbo_and_gradient_match_jax(case):
    jt, tt = make_pair(**CASES[case])
    key = jax.random.key(3)
    step = 4 if "obs_variance_final" in CASES[case] else None
    iw = tt.config.iw_samples

    def j_elbo(p):
        res = jt._elbo_from_params(p, key, BATCH, step=step)
        return res.evidence_lower_bound, res

    (_, j_res), j_grads = jax.jit(jax.value_and_grad(j_elbo, has_aux=True))(jt.params)

    theta_eps, noise = jax_draws(key, BATCH, iw, tt.n_steps)
    leaves = {g: tt.flat_params[g].detach().requires_grad_() for g in GROUPS}
    t_res = tt._elbo_from_params(tt.layout.unpack(leaves), theta_eps, noise, step=step)
    grads = torch.autograd.grad(t_res.evidence_lower_bound, [leaves[g] for g in GROUPS])

    np.testing.assert_allclose(float(t_res.evidence_lower_bound.detach()),
                               float(j_res.evidence_lower_bound), rtol=1e-4)
    for t_c, j_c in zip(t_res.components, j_res.components):
        np.testing.assert_allclose(float(t_c.detach()), float(j_c), rtol=1e-4, atol=1e-4)
    t_grads = tt.layout.unpack(dict(zip(GROUPS, grads)))
    assert_tree_close(t_grads, j_grads, rtol=1e-4, atol_scale=1e-5)
    if CASES[case].get("encoder_perturb"):
        for block in t_grads["encoder"]["sit"]["blocks"]:
            assert float(block["attn"]["qkv_proj"]["w"].abs().max()) > 0.0


def test_bf16_encoder_elbo_close_to_jax():
    jt, tt = make_pair(compute_dtype="bfloat16")
    key = jax.random.key(5)
    j_res = jax.jit(lambda p: jt._elbo_from_params(p, key, BATCH))(jt.params)
    t_res = tt._elbo_from_params(tt.params, *jax_draws(key, BATCH, 1, tt.n_steps))
    np.testing.assert_allclose(float(t_res.evidence_lower_bound), float(j_res.evidence_lower_bound), rtol=2e-2)
