"""One training step of the Lotka-Volterra rung's problem, the port against the
JAX package, in fp32 and in bf16.

The problem is ``examples_torch/quality_eval.py``'s ``run_lv``: its
observations (up to 447.2), likelihood variance 1.0, the log-normal prior,
401 grid tokens, ``state_positive_dims=[0, 1]``, with the SiT cut to width
64, 2 heads, depth 2 and a batch of 8. Both trainers hold the same weights
(the SiT modulators and the head's output projection perturbed, as
``test_torch_elbo.py``'s ``encoder_perturb`` does, so that every encoder
leaf gets a gradient), theta's mean at log(0.5, 0.0025, 0.3), and the port
takes the draws JAX makes from each key.

- fp32: the port's ELBO, its components and every gradient leaf equal the
  JAX package's at ``test_torch_elbo.py``'s bars (1e-4).
- bf16: the port's ELBO within 2e-2 of the JAX package's bf16 ELBO; its
  gradient's total relative error against its own fp32 gradient no larger
  than the JAX package's against JAX's fp32 gradient; and each leaf's
  relative error under ``LEAF_BAR``. The JAX package's bf16 step on the CPU
  sums some of its reductions over the batch and grid in bf16 (ROADMAP,
  "Known defects of the JAX package"): those leaves (the SiT biases,
  ``v_residual_lambda``) miss fp32 by far more than one bf16 rounding, and
  the port is never asked to match them, only fp32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viforsdes_tpu as jvt
import viforsdes_tpu_torch as tvt
from test_torch_elbo import assert_tree_close, flat_paths
from test_torch_ladder import REPO, load_file
from viforsdes_tpu.inference.trainer import VariationalInferenceTrainer as JTrainer
from viforsdes_tpu.utils.console import Console
from viforsdes_tpu_torch.inference.optimizer import GROUPS
from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer as TTrainer

from examples_torch.lotka_volterra import LotkaVolterra as PortLV
from examples_torch.quality_eval import LV_OBSERVATIONS

# run_lv's problem (examples_torch/quality_eval.py)
HORIZON, DT, VARIANCE = 40.0, 0.1, 1.0
PRIOR = dict(mean=0.0, std=1.5, dim=3)
THETA_MEAN = np.log([0.5, 0.0025, 0.3]).astype(np.float32)
# cut to size: the rung runs SiT 256 x 4 heads x 8 deep and a batch of 24
ENC = dict(hidden_dim=64, num_heads=2, depth=2)
HEAD = dict(hidden_dim=64, num_layers=2)
BATCH = 8
KEYS = [3, 11, 29]

# Each gradient leaf of the port's bf16 step against its fp32 step,
# ||g_bf16 - g_fp32|| / ||g_fp32||, stays under its bar: LEAF_BAR for every
# leaf but the scalar ``v_residual_lambda``. One bf16 rounding of the
# activations leaves at most 9e-3 on any other leaf at this size (the
# SiT biases 1.5e-3 to 7.4e-3, where the JAX package's bf16 sums leave
# 4.9e-3 to 3.2e-2); a bias gradient summed row by row in bf16 over the
# batch's 3,208 rows misses its bar by far (0.49 to 0.77 on the qkv bias).
# ``v_residual_lambda``'s gradient is the difference of two sums
# over every value entry, each rounded to bf16 as the JAX package's code
# rounds them (lambda is cast to the activations' dtype), and cancels: it
# stays under LAMBDA_BAR and under the JAX package's own error there.
LEAF_BAR = 1.5e-2
LAMBDA_BAR = 0.25
LAMBDA = "v_residual_lambda"


def _jax_lv():
    return load_file("jax_example_lotka_volterra", REPO / "examples" / "lotka_volterra.py").LotkaVolterra()


def _perturbed(params: dict) -> dict:
    params = jax.tree.map(lambda a: a, params)
    for i, block in enumerate(params["encoder"]["sit"]["blocks"]):
        w = block["cond"]["net"]["w"]
        block["cond"]["net"]["w"] = 0.3 * jax.random.normal(jax.random.key(10 + i), w.shape, jnp.float32)
    w = params["head"]["out_proj"]["w"]
    params["head"]["out_proj"]["w"] = 0.1 * jax.random.normal(jax.random.key(9), w.shape, jnp.float32)
    params["theta"]["mean"] = jnp.asarray(THETA_MEAN)
    return params


def _jax_trainer(dtype: str) -> JTrainer:
    return JTrainer(
        _jax_lv(),
        jvt.Observations(**LV_OBSERVATIONS),
        jvt.GaussianObservationLikelihood(variance=VARIANCE),
        jvt.Prior(type=jvt.PriorType.LOG_NORMAL, **PRIOR),
        HORIZON,
        jvt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=3, compute_dtype=dtype),
        jvt.EncoderConfig(**ENC),
        jvt.HeadConfig(**HEAD),
        state_positive_dims=[0, 1],
        sde_param_positive_dims=[0, 1, 2],
        console=Console(enabled=False),
    )


def _port_trainer(dtype: str, params: dict) -> TTrainer:
    tt = TTrainer(
        PortLV(),
        tvt.Observations(**LV_OBSERVATIONS),
        tvt.GaussianObservationLikelihood(variance=VARIANCE),
        tvt.Prior(type=tvt.PriorType.LOG_NORMAL, **PRIOR),
        HORIZON,
        tvt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=3, compute_dtype=dtype),
        tvt.EncoderConfig(**ENC),
        tvt.HeadConfig(**HEAD),
        state_positive_dims=[0, 1],
        sde_param_positive_dims=[0, 1, 2],
        device="cpu",
    )
    tt.flat_params = tt.layout.pack(jax.tree.map(np.asarray, params), tt.device)
    return tt


@functools.lru_cache(maxsize=None)
def _pair():
    """The JAX package's jitted step and the port's trainer per dtype, on one
    set of weights."""
    out = {}
    params = None
    for dtype in ("float32", "bfloat16"):
        jt = _jax_trainer(dtype)
        params = _perturbed(jt.params) if params is None else params

        def j_elbo(p, key, jt=jt):
            res = jt._elbo_from_params(p, key, BATCH)
            return res.evidence_lower_bound, res

        out[dtype] = (jax.jit(jax.value_and_grad(j_elbo, has_aux=True)), _port_trainer(dtype, params))
    return params, out


@functools.lru_cache(maxsize=None)
def _steps(seed: int) -> dict:
    """(package, dtype) -> (ELBO result, gradient tree) from ``seed``'s key."""
    params, fns = _pair()
    key = jax.random.key(seed)
    out = {}
    for dtype, (j_step, tt) in fns.items():
        (_, j_res), j_grads = j_step(params, key)
        out["jax", dtype] = (j_res, j_grads)
        out["port", dtype] = _port_step(tt, key)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _jax_draws(key, n_steps: int):
    """The numbers JAX ``_elbo_from_params(params, key, BATCH)`` draws."""
    k_theta, k_path = jax.random.split(key)
    theta_eps = jax.random.normal(k_theta, (BATCH, 3), dtype=jnp.float32)
    noise = jax.random.normal(k_path, (n_steps, BATCH, 2), dtype=jnp.float32)
    return torch.from_numpy(np.array(theta_eps)), torch.from_numpy(np.array(noise))


def _port_step(tt: TTrainer, key):
    """The port's ELBO result and gradient tree from JAX's draws of ``key``."""
    leaves = {g: tt.flat_params[g].detach().requires_grad_() for g in GROUPS}
    res = tt._elbo_from_params(tt.layout.unpack(leaves), *_jax_draws(key, tt.n_steps))
    grads = torch.autograd.grad(res.evidence_lower_bound, [leaves[g] for g in GROUPS])
    return res, tt.layout.unpack(dict(zip(GROUPS, grads)))


def _flat64(tree) -> dict:
    return {p: np.asarray(v, dtype=np.float64) for p, v in flat_paths(tree).items()}


def _errors(low: dict, ref: dict) -> tuple[dict, dict]:
    """Relative error of one gradient tree against another: in total (over
    every leaf, and over the encoder's leaves) and per leaf."""
    def total(paths):
        return float(np.sqrt(sum(np.sum((low[p] - ref[p]) ** 2) for p in paths)
                             / sum(np.sum(ref[p] ** 2) for p in paths)))

    per = {p: float(np.linalg.norm(low[p] - ref[p]) / max(np.linalg.norm(ref[p]), 1e-30)) for p in ref}
    return {"all": total(ref), "encoder": total([p for p in ref if p.startswith("encoder/")])}, per


@pytest.mark.parametrize("seed", KEYS)
def test_lv_step_fp32_matches_jax(seed):
    steps = _steps(seed)
    (j_res, j_grads), (t_res, t_grads) = steps["jax", "float32"], steps["port", "float32"]
    np.testing.assert_allclose(float(t_res.evidence_lower_bound.detach()),
                               float(j_res.evidence_lower_bound), rtol=1e-4)
    for t_c, j_c in zip(t_res.components, j_res.components):
        np.testing.assert_allclose(float(t_c.detach()), float(j_c), rtol=1e-4, atol=1e-4)
    assert_tree_close(t_grads, j_grads, rtol=1e-4, atol_scale=1e-5)
    flat = _flat64(t_grads)
    sit = [p for p in flat if p.startswith("encoder/sit/blocks") and p.endswith("/w")]
    assert sit and all(np.abs(flat[p]).max() > 0.0 for p in sit)


@pytest.mark.parametrize("seed", KEYS)
def test_lv_step_bf16_no_further_from_fp32_than_jax(seed):
    steps = _steps(seed)
    np.testing.assert_allclose(float(steps["port", "bfloat16"][0].evidence_lower_bound.detach()),
                               float(steps["jax", "bfloat16"][0].evidence_lower_bound), rtol=2e-2)
    port = _errors(*(_flat64(steps["port", d][1]) for d in ("bfloat16", "float32")))
    jax_ = _errors(*(_flat64(steps["jax", d][1]) for d in ("bfloat16", "float32")))
    for which in ("all", "encoder"):
        assert port[0][which] <= jax_[0][which], (which, port[0][which], jax_[0][which])
    for path, err in port[1].items():
        if path.endswith(LAMBDA):
            assert err < LAMBDA_BAR and err <= jax_[1][path], (path, err, jax_[1][path])
        else:
            assert err < LEAF_BAR, (path, err, jax_[1][path])
