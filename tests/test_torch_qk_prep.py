"""The port's fused QK-prep (``viforsdes_tpu_torch/ops/qk_prep.py``) against the
JAX package's Pallas kernel run in interpret mode, on the same inputs (numpy,
seeded) and the same cos/sin tables.

On the CPU the port's wrappers take their plain versions, so these tests pin
the arithmetic the CUDA kernels K3/K4 are held to on the card. Tolerances are
those of ``tests/test_qk_prep.py``: values atol 1e-6 in fp32 and 2e-2 in bf16
(one bf16 rounding of values of order one); gradients in fp32 to rtol 2e-5 /
atol 2e-6 (the same formula summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viforsdes_tpu.ops.embeddings import precompute_rope
from viforsdes_tpu.ops.pallas.qk_prep import qk_prep as j_qk_prep
from viforsdes_tpu_torch.ops import qk_prep as tq

EPS = 1e-6


def _case(shape, seed):
    """x and a cotangent [B, H, S, D] from numpy, and the fp32 RoPE tables."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    tables = precompute_rope(shape[-1], end=shape[2])
    return x, ct, np.array(tables.cos), np.array(tables.sin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [64, 701, 1001])
def test_forward_matches_jax_interpret(s, d, dtype):
    x, _, cos, sin = _case((1, 2, s, d), seed=s + d)
    want = j_qk_prep(jnp.asarray(x, dtype), jnp.asarray(cos), jnp.asarray(sin), EPS, True)
    got = tq.qk_prep(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(cos), torch.from_numpy(sin), EPS)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    atol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("s", [96, 701])
def test_gradient_matches_jax_interpret(s):
    import jax

    x, ct, cos, sin = _case((2, 2, s, 32), seed=7 + s)
    j_grad = jax.grad(
        lambda x: jnp.sum(j_qk_prep(x, jnp.asarray(cos), jnp.asarray(sin), EPS, True) * ct)
    )(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tq.qk_prep(tx, torch.from_numpy(cos), torch.from_numpy(sin), EPS)
    (t_grad,) = torch.autograd.grad(out, tx, grad_outputs=torch.from_numpy(ct))
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=2e-5, atol=2e-6)


def test_plain_backward_matches_autograd_through_plain_forward():
    """The explicit VJP of K4 equals autograd through the composition (fp32,
    where the bf16 cast of the scale is the identity)."""
    x, ct, cos, sin = _case((2, 3, 77, 64), seed=3)
    x, ct, cos, sin = (torch.from_numpy(a) for a in (x, ct, cos, sin))
    xg = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(tq._forward_plain(xg, cos, sin, EPS), xg, grad_outputs=ct)
    got = tq._backward_plain(x, cos, sin, ct, EPS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_tables_get_no_gradient():
    x, ct, cos, sin = _case((1, 2, 40, 32), seed=4)
    tx = torch.from_numpy(x).requires_grad_()
    tcos = torch.from_numpy(cos).requires_grad_()
    tsin = torch.from_numpy(sin).requires_grad_()
    (tq.qk_prep(tx, tcos, tsin, EPS) * torch.from_numpy(ct)).sum().backward()
    assert tx.grad is not None and bool(tx.grad.abs().sum() > 0)
    assert tcos.grad is None and tsin.grad is None


def test_strided_view_takes_the_same_values():
    """q as the attention block passes it: a [B, H, S, D] view of a [B, S, 3E]
    projection output."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 50, 2, 32
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32))
    q = torch.chunk(qkv, 3, dim=-1)[0].reshape(b, s, h, d).transpose(1, 2)
    tables = precompute_rope(d, end=s)
    cos, sin = torch.from_numpy(np.array(tables.cos)), torch.from_numpy(np.array(tables.sin))
    assert not q.is_contiguous()
    torch.testing.assert_close(tq.qk_prep(q, cos, sin, EPS), tq.qk_prep(q.contiguous(), cos, sin, EPS),
                               rtol=0, atol=0)


def test_kernel_checks_name_the_supported_widths():
    x = torch.zeros(1, 2, 8, 16)
    cos = sin = torch.zeros(8, 8)
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        tq._check(x, cos, sin)
    with pytest.raises(ValueError, match="dtype"):
        tq._check(torch.zeros(1, 2, 8, 32, dtype=torch.float16), torch.zeros(8, 16), torch.zeros(8, 16))


def test_other_devices_raise():
    x = torch.empty(1, 2, 8, 32, device="meta")
    tables = torch.empty(8, 16, device="meta")
    with pytest.raises(NotImplementedError):
        tq.qk_prep_forward(x, tables, tables, EPS)
    with pytest.raises(NotImplementedError):
        tq.qk_prep_backward(x, tables, tables, x, EPS)
