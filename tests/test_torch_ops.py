"""Dense-path primitives of the port against the JAX package, on the same
weights (initialized in JAX) and inputs (numpy, seeded): norms, RoPE, time
embedding, SwiGLU, adaLN cond, ``lower_bound``, dense attention and SiT.
Values at rtol/atol 1e-5, gradients at rtol 1e-4 / atol 1e-5 (fp32 on both
sides; the residual difference is summation order)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viforsdes_tpu.ops import bounds as j_bounds
from viforsdes_tpu.ops import cond as j_cond
from viforsdes_tpu.ops import embeddings as j_emb
from viforsdes_tpu.ops import mlp as j_mlp
from viforsdes_tpu.ops import norms as j_norms
from viforsdes_tpu_torch.ops import attention as t_attn
from viforsdes_tpu_torch.ops import bounds as t_bounds
from viforsdes_tpu_torch.ops import cond as t_cond
from viforsdes_tpu_torch.ops import embeddings as t_emb
from viforsdes_tpu_torch.ops import mlp as t_mlp
from viforsdes_tpu_torch.ops import norms as t_norms
from viforsdes_tpu_torch.ops import sit as t_sit
from viforsdes_tpu_torch.utils.convert import params_from_numpy
from viforsdes_tpu_torch.utils.tree import tree_leaves, tree_map

# the JAX package's ops/__init__ re-exports functions named like these modules
j_attn = importlib.import_module("viforsdes_tpu.ops.attention")
j_sit = importlib.import_module("viforsdes_tpu.ops.sit")

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach") else a), np.asarray(b), **tol)


def _grad_parity(j_fn, t_fn, params_np, x_np, seed=0):
    """Value and gradient (w.r.t. params and input) of ``sum(f(p, x) * w)``."""
    out_shape = np.asarray(j_fn(jax.tree.map(jnp.asarray, params_np), jnp.asarray(x_np))).shape
    w = _randn(seed + 100, *out_shape)

    def j_loss(p, x):
        return jnp.sum(j_fn(p, x) * w)

    j_val, (j_gp, j_gx) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(x_np)
    )
    p = tree_map(lambda t: t.requires_grad_(), params_from_numpy(params_np))
    x = torch.from_numpy(x_np.copy()).requires_grad_()
    t_val = (t_fn(p, x) * torch.from_numpy(w)).sum()
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(t_val, leaves + [x], allow_unused=True)
    _close(t_val, j_val, VAL)
    for g_t, g_j, leaf in zip(grads, jax.tree.leaves(j_gp) + [j_gx], leaves + [x]):
        g_t = torch.zeros_like(leaf) if g_t is None else g_t
        _close(g_t, g_j, GRAD)


def test_norms():
    x = _randn(0, 2, 5, 8) * 3 + 1
    _close(t_norms.rms_norm(torch.from_numpy(x)), j_norms.rms_norm(jnp.asarray(x)), VAL)
    _close(t_norms.layer_norm(torch.from_numpy(x)), j_norms.layer_norm(jnp.asarray(x)), VAL)


def test_sinusoidal_embedding():
    t = np.linspace(0.0, 5.0, 21).astype(np.float32)
    _close(
        t_emb.sinusoidal_embedding(torch.from_numpy(t), 16),
        j_emb.sinusoidal_embedding(jnp.asarray(t), 16),
        VAL,
    )


@pytest.mark.parametrize("dim,extra", [(8, 0), (8, 4)])
def test_rope_tables_and_rotation(dim, extra):
    j_tab = j_emb.precompute_rope(dim, end=32)
    t_tab = t_emb.precompute_rope(dim, end=32)
    _close(t_tab.cos, j_tab.cos, VAL)
    _close(t_tab.sin, j_tab.sin, VAL)
    # [real || imag] halves layout; lanes past 2F pass through
    x = _randn(1, 2, 3, 20, dim + extra)
    j_out = j_emb.apply_rope_1d(jnp.asarray(x), j_tab)
    t_out = t_emb.apply_rope_1d(torch.from_numpy(x), t_tab)
    _close(t_out, j_out, VAL)


def test_swiglu():
    params = _np_tree(j_mlp.swiglu_init(jax.random.key(0), 8, 12))
    _grad_parity(j_mlp.swiglu, t_mlp.swiglu, params, _randn(2, 3, 5, 8))


def test_cond_modulator():
    params = _np_tree(j_cond.cond_modulator_init(jax.random.key(1), 6, 8, branches=2))
    # adaLN-Zero starts at zero; perturb so the product is exercised
    params["net"]["w"] = _randn(3, *params["net"]["w"].shape) * 0.1

    def j_fn(p, c):
        return jnp.concatenate([jnp.concatenate(b, -1) for b in j_cond.cond_modulator(p, c, branches=2)], -1)

    def t_fn(p, c):
        return torch.cat([torch.cat(tuple(b), -1) for b in t_cond.cond_modulator(p, c, branches=2)], -1)

    _grad_parity(j_fn, t_fn, params, _randn(4, 3, 6))


def test_lower_bound_value_and_ste_gradient():
    bound = 0.01
    x = np.array([-1.0, bound, bound, 0.5, -0.2, bound / 2], np.float32)
    g = np.array([1.0, 1.0, -1.0, 2.0, -3.0, 0.5], np.float32)
    j_val, j_vjp = jax.vjp(lambda v: j_bounds.lower_bound(v, bound), jnp.asarray(x))
    (j_g,) = j_vjp(jnp.asarray(g))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    t_val = t_bounds.lower_bound(xt, bound)
    (t_g,) = torch.autograd.grad(t_val, xt, torch.from_numpy(g))
    _close(t_val, j_val, VAL)
    np.testing.assert_array_equal(t_g.numpy(), np.asarray(j_g))
    # passes iff x >= bound or the cotangent is negative
    np.testing.assert_array_equal(t_g.numpy(), [0.0, 1.0, -1.0, 2.0, -3.0, 0.0])


def _attn_params(cfg, seed):
    params = _np_tree(j_attn.attention_init(jax.random.key(seed), cfg))
    if "gate_proj" in params:  # zero-init gate: perturb so it matters
        params["gate_proj"]["w"] = _randn(seed + 7, *params["gate_proj"]["w"].shape) * 0.2
    return params


@pytest.mark.parametrize("real_len", [None, 9])
@pytest.mark.parametrize("residual_v", [False, True])
def test_dense_attention(real_len, residual_v):
    cfg = j_attn.AttentionConfig(embed_dim=16, num_heads=2, residual_v=residual_v)
    tcfg = t_attn.AttentionConfig(*cfg)
    params = _attn_params(cfg, 5)
    s = 12
    j_rot = j_emb.precompute_rope(cfg.head_dim, end=s)
    t_rot = t_emb.precompute_rope(cfg.head_dim, end=s)
    v0 = _randn(6, 2, s, 2, 8) if residual_v else None

    def j_fn(p, x):
        v = None if v0 is None else jnp.asarray(v0)
        return j_attn.attention(p, cfg, x, rotary=j_rot, v0=v, real_len=real_len)[0]

    def t_fn(p, x):
        v = None if v0 is None else torch.from_numpy(v0)
        return t_attn.attention(p, tcfg, x, rotary=t_rot, v0=v, real_len=real_len)[0]

    _grad_parity(j_fn, t_fn, params, _randn(7, 2, s, 16))


def test_sit_stack():
    cfg = j_sit.SiTConfig(
        in_dim=16, hidden_dim=16, out_dim=16, cond_dim=8, num_heads=2, depth=2, mlp_hidden_dim=24
    )
    tcfg = t_sit.SiTConfig(*cfg)
    params = _np_tree(j_sit.sit_init(jax.random.key(3), cfg))
    for b, block in enumerate(params["blocks"]):  # leave adaLN-Zero's zero start
        block["cond"]["net"]["w"] = _randn(20 + b, *block["cond"]["net"]["w"].shape) * 0.1
    s = 10
    j_rot = j_emb.precompute_rope(8, end=s)
    t_rot = t_emb.precompute_rope(8, end=s)
    cond = _randn(8, 2, 8)

    def j_fn(p, x):
        return j_sit.sit(p, cfg, x, cond=jnp.asarray(cond), rotary=j_rot, remat=False)

    def t_fn(p, x):
        return t_sit.sit(p, tcfg, x, cond=torch.from_numpy(cond), rotary=t_rot)

    _grad_parity(j_fn, t_fn, params, _randn(9, 2, s, 16))
