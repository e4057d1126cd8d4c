"""The port's path sampler against the JAX package's, on JAX-initialized head
weights and seeded numpy inputs.

- The plain loop (``sampler="scan"``, autograd) against the JAX ``lax.scan``
  sampler: values and gradients, full and diag modes.
- The ``FusedPathSampler`` autograd bridge on the CPU, whose forward and
  backward are the plain versions of the CUDA kernels K1/K2 (same streams,
  same recompute, same per-step gate cotangents), against the JAX
  ``FusedPathSampler`` in Pallas interpret mode: the time-major contract, the
  noise cotangent, and the clamp boundary of the Cholesky diagonal.

Values at rtol/atol 1e-5; gradients at rtol 1e-4 / atol 1e-5 (fp32 on both
sides, summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viforsdes_tpu.config import HeadConfig as JHeadConfig
from viforsdes_tpu.models.head import DiffusionTransitionHead as JHead
from viforsdes_tpu.ops.pallas.sde_sampler import FusedPathSampler as JFused
from viforsdes_tpu.ops.pallas.sde_sampler import SamplerSpec as JSpec
from viforsdes_tpu_torch.config import HeadConfig
from viforsdes_tpu_torch.inference.constants import DIAG_MIN
from viforsdes_tpu_torch.models.head import DiffusionTransitionHead
from viforsdes_tpu_torch.ops import sde_sampler as ss
from viforsdes_tpu_torch.utils.convert import params_from_numpy
from viforsdes_tpu_torch.utils.tree import tree_leaves, tree_map

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
CTX, PAR, HID, DT = 6, 3, 8, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params(d, n_layers, cholesky, seed, diag_bias=None, hid=HID):
    head = JHead(d, CTX, PAR, JHeadConfig(hidden_dim=hid, num_layers=n_layers, cholesky=cholesky))
    params = jax.tree.map(np.asarray, head.init(jax.random.key(seed)))
    params["out_proj"]["w"] = 0.3 * _randn(seed + 1, *params["out_proj"]["w"].shape)
    if diag_bias is not None:
        params["out_proj"]["b"] = params["out_proj"]["b"].copy()
        params["out_proj"]["b"][d] = diag_bias  # first Cholesky diagonal
    return params


def _inputs(seed, B, T, d):
    return _randn(seed, B, d), _randn(seed + 1, B, T, CTX), _randn(seed + 2, B, PAR), _randn(seed + 3, T, B, d)


def _weights(seed, B, T, d):
    """Cotangent weights of the three outputs (paths, means, chol)."""
    return _randn(seed + 10, B, T + 1, d), _randn(seed + 11, B, T, d)


def _loss_terms(paths, means, chol, wp, wm, chol_w):
    return (paths * wp).sum() + 0.7 * (means * wm).sum() + 0.3 * (chol * chol_w).sum()


def _jax_grads(sampler, d, n_layers, cholesky, params, inputs, ws):
    head = JHead(d, CTX, PAR, JHeadConfig(hidden_dim=HID, num_layers=n_layers, sampler=sampler, cholesky=cholesky))

    def loss(p, x0, ctx, theta, eps):
        out = head.sample_diffusion_paths(p, x0, ctx, theta, eps, DT)
        chol_w = jnp.asarray(np.cos(np.arange(out[2].size)).reshape(out[2].shape).astype(np.float32))
        return _loss_terms(*out, *ws, chol_w), out

    args = [jax.tree.map(jnp.asarray, params)] + [jnp.asarray(a) for a in inputs]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    return out, [*jax.tree.leaves(grads[0]), *grads[1:]]


def _torch_grads(sampler, d, n_layers, cholesky, params, inputs, ws):
    head = DiffusionTransitionHead(d, CTX, PAR, HeadConfig(hidden_dim=HID, num_layers=n_layers, sampler=sampler, cholesky=cholesky))
    p = tree_map(lambda t: t.requires_grad_(), params_from_numpy(params))
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    out = head.sample_diffusion_paths(p, *xs, DT)
    chol_w = torch.from_numpy(np.cos(np.arange(out[2].numel())).reshape(out[2].shape).astype(np.float32))
    loss = _loss_terms(*out, *(torch.from_numpy(w) for w in ws), chol_w)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves + xs, allow_unused=True)
    return out, [torch.zeros_like(t) if g is None else g for t, g in zip(leaves + xs, grads)]


def _assert_parity(t_res, j_res):
    (t_out, t_grads), (j_out, j_grads) = t_res, j_res
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **VAL)
    assert len(t_grads) == len(j_grads)
    for a, b in zip(t_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("cholesky", ["full", "diag"])
@pytest.mark.parametrize("d,n_layers", [(1, 1), (2, 2), (3, 3), (1, 5)])
def test_plain_sampler_matches_jax_scan(d, n_layers, cholesky):
    params = _params(d, n_layers, cholesky, seed=d * 10 + n_layers)
    inputs = _inputs(1, 5, 7, d)
    ws = _weights(1, 5, 7, d)
    args = (d, n_layers, cholesky, params, inputs, ws)
    _assert_parity(_torch_grads("scan", *args), _jax_grads("scan", *args))


@pytest.mark.parametrize(
    "d,n_layers,cholesky,diag_bias,hid",
    [
        pytest.param(1, 2, "full", None, HID, id="1-2-full-None"),
        pytest.param(2, 1, "full", -0.5, HID, id="2-1-full--0.5"),
        pytest.param(3, 2, "full", DIAG_MIN, HID, id=f"3-2-full-{DIAG_MIN}"),
        pytest.param(2, 2, "diag", -0.5, HID, id="2-2-diag--0.5"),
        # the ladder's heads: Lorenz r3 (128 x 3, D=3) and highdim r5 (128 x 2, D=32),
        # which the card runs on clusters of 8 and 16
        pytest.param(3, 3, "full", None, 128, id="3-3-full-None-128"),
        pytest.param(32, 2, "full", None, 128, id="32-2-full-None-128"),
    ],
)
def test_fused_bridge_matches_jax_fused_sampler(d, n_layers, cholesky, diag_bias, hid):
    """Port ``FusedPathSampler`` (CPU: the kernels' plain versions) against JAX
    ``FusedPathSampler`` at ``interpret=True`` on the time-major contract, at
    a diagonal inside, below and exactly at ``DIAG_MIN``, and at the ladder
    rungs' head widths."""
    B, T = 4, 6
    params = _params(d, n_layers, cholesky, seed=40 + d, diag_bias=diag_bias, hid=hid)
    x0, _, _, eps = _inputs(50 + d, B, T, d)
    gc = _randn(60 + d, T, B, 3 * hid)
    ws = _weights(70 + d, B, T, d)
    n_tril = d if cholesky == "diag" else d * (d + 1) // 2
    chol_w = np.cos(np.arange(B * T * n_tril)).reshape(B, T, n_tril).astype(np.float32)

    j_spec = JSpec(state_dim=d, hidden_dim=hid, num_layers=n_layers, time_step=DT,
                   diag_min=DIAG_MIN, interpret=True, cholesky=cholesky)
    j_sampler = JFused(j_spec)

    def j_loss(p, x0_, gc_, eps_):
        out = j_sampler(p, x0_, gc_, eps_)
        return _loss_terms(*out, *ws, chol_w), out

    jargs = [jax.tree.map(jnp.asarray, params), jnp.asarray(x0), jnp.asarray(gc), jnp.asarray(eps)]
    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))(*jargs)

    head = DiffusionTransitionHead(d, CTX, PAR, HeadConfig(hidden_dim=hid, num_layers=n_layers, cholesky=cholesky))
    p = tree_map(lambda t: t.requires_grad_(), params_from_numpy(params))
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in (x0, gc, eps)]
    t_out = ss.sample_paths(head.spec(DT), ss.prep_weights(head.spec(DT), p), *xs)
    loss = _loss_terms(*t_out, *(torch.from_numpy(w) for w in ws), torch.from_numpy(chol_w))
    leaves = tree_leaves(p)
    t_grads = torch.autograd.grad(loss, leaves + xs, allow_unused=True)

    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **VAL)
    j_flat = jax.tree.leaves(j_grads[0]) + list(j_grads[1:])
    for t, g, b in zip(leaves + xs, t_grads, j_flat):
        g = torch.zeros_like(t) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(b), **GRAD)
    # the noise cotangent is exercised, not trivially zero
    assert float(np.abs(np.asarray(j_grads[3])).max()) > 1e-3


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_kernel_backward_plain_at_clamp_matches_autograd(sign):
    """K2's plain version (hand-written BPTT with the summed-cotangent
    lower_bound rule) against autograd through the plain forward, with a
    diagonal below the clamp and both signs of its cotangent."""
    d, n_layers, B, T = 2, 2, 3, 5
    params = params_from_numpy(_params(d, n_layers, "full", seed=80, diag_bias=-0.5))
    head = DiffusionTransitionHead(d, CTX, PAR, HeadConfig(hidden_dim=HID, num_layers=n_layers))
    spec = head.spec(DT)
    w = ss.prep_weights(spec, params)
    x0, _, _, eps = (torch.from_numpy(a) for a in _inputs(81, B, T, d))
    gc = torch.from_numpy(_randn(82, T, B, 3 * HID))
    cot = (
        torch.from_numpy(_randn(83, B, T + 1, d)),
        torch.zeros(B, T, d),
        torch.full((B, T, spec.n_tril), sign),
    )

    ins = [t.clone().requires_grad_() for t in (x0, gc, eps, *w)]
    outs = ss.sample_paths_scan(spec, ss.SamplerWeights(*ins[3:]), *ins[:3])
    ref = torch.autograd.grad(outs, ins, grad_outputs=cot)

    fwd = ss.sampler_forward(spec, w, x0, gc, eps, save_h=True)
    t_major = [c.transpose(0, 1).contiguous() for c in (cot[0][:, 1:], cot[1], cot[2])]
    got = ss.sampler_backward(spec, w, x0, gc, eps, fwd, *t_major)
    d_x0 = got.d_x0 + cot[0][:, 0]
    for a, b in zip([d_x0, got.d_gc, got.d_eps, *got.weights], ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_dispatch_on_the_cpu():
    """``auto`` takes the plain loop on CPU tensors; the wrappers refuse a
    device that is neither CPU nor CUDA instead of falling back."""
    head = DiffusionTransitionHead(1, CTX, PAR, HeadConfig(hidden_dim=HID, num_layers=1))
    params = params_from_numpy(_params(1, 1, "full", seed=90))
    x0, ctx, theta, eps = (torch.from_numpy(a) for a in _inputs(91, 2, 3, 1))
    before = ss.FORWARD_LAUNCHES.count
    paths, _, _ = head.sample_diffusion_paths(params, x0, ctx, theta, eps, DT)
    assert paths.shape == (2, 4, 1)
    assert ss.FORWARD_LAUNCHES.count == before
    spec = head.spec(DT)
    w = ss.SamplerWeights(*(t.to("meta") for t in ss.prep_weights(spec, params)))
    with pytest.raises(NotImplementedError):
        ss.sampler_forward(spec, w, x0.to("meta"), torch.empty(3, 2, 3 * HID, device="meta"),
                           eps.to("meta"), save_h=False)

