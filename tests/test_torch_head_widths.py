"""Attention heads of every width on the long grid, and the sampler choice
for heads wider than K1 takes, against the JAX package.

Past 512 tokens the port runs its flash path. The kernels take head widths
32, 64 and 128: a narrower or in-between head is zero-padded to the next
kernel width (``flash_sdpa``), with the scale of its real width, and takes
the unfused RMSNorm and RoPE (RMSNorm divides by the width, so it is never
padded); a head wider than 128 takes the dense path, as the JAX package does
off the TPU. On the CPU the wrappers run their plain versions, so these tests
pin the dispatch and the padding that the CUDA kernels see on the card.

Inputs are standard normals from numpy, seeded; weights cross into both
packages through ``utils/convert.py``. Bars: values and gradients in fp32 to
rtol 1e-5 and atol 1e-6 times the largest value; at head width 256, where both
packages run their dense attention over 512-wide projections and 600 tokens,
their fp32 sums in other orders differ by up to 5.2e-6 of the largest value
(the QKV weight gradient), so there the atol is 1e-5 times it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viforsdes_tpu.ops.attention import AttentionConfig as JAttentionConfig
from viforsdes_tpu.ops.attention import attention as j_attention
from viforsdes_tpu.ops.embeddings import precompute_rope as j_precompute_rope
from viforsdes_tpu.ops.flash_attention import _reference_masked_attention
from viforsdes_tpu.ops.flash_attention import flash_sdpa as j_flash_sdpa
from viforsdes_tpu_torch.config import HeadConfig
from viforsdes_tpu_torch.models.head import DiffusionTransitionHead
from viforsdes_tpu_torch.ops import attention as t_attn
from viforsdes_tpu_torch.ops import flash_attention as tfa
from viforsdes_tpu_torch.ops import qk_prep as tqp
from viforsdes_tpu_torch.ops import sde_sampler as ss
from viforsdes_tpu_torch.ops.embeddings import precompute_rope as t_precompute_rope
from viforsdes_tpu_torch.utils.convert import params_from_numpy

S = 600
HEADS = 2
RTOL, ATOL = 1e-5, 1e-6
DENSE_ATOL = 1e-5  # head width 256: dense attention in both packages
WIDTHS = (8, 16, 48, 96, 256)


def _close(got, ref, what, atol=ATOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol * np.abs(ref).max(), err_msg=what)


def _case(d: int):
    """Attention weights (numpy) and inputs [2, S, HEADS * d] at head width d."""
    e = HEADS * d
    rng = np.random.default_rng(d)
    params = {
        "qkv_proj": {"w": (rng.standard_normal((e, 3 * e)) / math.sqrt(e)).astype(np.float32),
                     "b": (0.1 * rng.standard_normal(3 * e)).astype(np.float32)},
        "out_proj": {"w": (rng.standard_normal((e, e)) / math.sqrt(e)).astype(np.float32),
                     "b": np.zeros(e, np.float32)},
        "gate_proj": {"w": (0.1 * rng.standard_normal((e, d))).astype(np.float32),
                      "b": np.zeros(d, np.float32)},
    }
    x = rng.standard_normal((2, S, e)).astype(np.float32)
    ct = rng.standard_normal((2, S, e)).astype(np.float32)
    return params, x, ct


@pytest.mark.parametrize("d", WIDTHS)
def test_attention_at_every_head_width_matches_jax(d):
    """The port's ``attention()`` at S=600 (its flash path, padded at 8, 16,
    48 and 96; its dense path at 256) against the JAX package's on the CPU:
    values, the input gradient, and the gradient of the QKV projection (the
    cotangents of q, k and v, summed over the tokens)."""
    params, x, ct = _case(d)
    t_cfg = t_attn.AttentionConfig(embed_dim=HEADS * d, num_heads=HEADS)
    j_cfg = JAttentionConfig(embed_dim=HEADS * d, num_heads=HEADS)

    tp = params_from_numpy(params)
    for leaf in (tp["qkv_proj"]["w"], tp["qkv_proj"]["b"]):
        leaf.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    t_out, _ = t_attn.attention(tp, t_cfg, tx, rotary=t_precompute_rope(d, end=S))
    t_grads = torch.autograd.grad(t_out, [tx, tp["qkv_proj"]["w"], tp["qkv_proj"]["b"]],
                                  grad_outputs=torch.from_numpy(ct))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    j_rotary = j_precompute_rope(d, end=S)

    def j_fn(xx, w, b):
        p = {**jp, "qkv_proj": {"w": w, "b": b}}
        return j_attention(p, j_cfg, xx, rotary=j_rotary)[0]

    j_out, vjp = jax.vjp(j_fn, jnp.asarray(x), jp["qkv_proj"]["w"], jp["qkv_proj"]["b"])
    j_grads = vjp(jnp.asarray(ct))

    atol = ATOL if d <= tfa.FLASH_MAX_HEAD_DIM else DENSE_ATOL
    _close(t_out.detach().numpy(), j_out, f"values at head_dim {d}", atol)
    for name, tg, jg in zip(("d_hidden", "d_qkv_w", "d_qkv_b"), t_grads, j_grads):
        _close(tg.numpy(), jg, f"{name} at head_dim {d}", atol)


@pytest.mark.parametrize("d", [w for w in WIDTHS if w <= tfa.FLASH_MAX_HEAD_DIM])
def test_padded_flash_sdpa_matches_jax_in_q_k_v(d):
    """``flash_sdpa`` at a width without a kernel, with a ``real_len`` tail,
    against the JAX package's ``flash_sdpa`` (its dense masked reference on
    the CPU): values of the real rows and the gradients of q, k and v (pad
    rows carry no cotangent, as in the encoder)."""
    rng = np.random.default_rng(100 + d)
    q, k, v, ct = (rng.standard_normal((2, S, HEADS, d)).astype(np.float32) for _ in range(4))
    real_len = S - 37
    ct[:, real_len:] = 0.0
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_sdpa(*ins, real_len=real_len)
    t_grads = torch.autograd.grad(out, ins, grad_outputs=torch.from_numpy(ct))
    j_out, vjp = jax.vjp(lambda a, b, c: j_flash_sdpa(a, b, c, impl=_reference_masked_attention,
                                                       real_len=real_len),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(ct))
    _close(out.detach().numpy()[:, :real_len], np.asarray(j_out)[:, :real_len], f"o at head_dim {d}")
    for name, tg, jg in zip(("dq", "dk", "dv"), t_grads, j_grads):
        _close(tg.numpy(), jg, f"{name} at head_dim {d}")


@pytest.mark.parametrize("d,flash_width", [(16, 32), (48, 64), (64, 64), (96, 128), (256, None)])
def test_head_width_dispatch(monkeypatch, d, flash_width):
    """Only the kernel widths take the fused QK prep; every head up to 128
    takes the flash Function at its kernel width; a wider one takes the dense
    path. On the CPU no CUDA branch runs."""
    calls = {"dense": 0, "flash": [], "qk_prep": 0}

    def count_dense(*args, **kwargs):
        calls["dense"] += 1
        return dense(*args, **kwargs)

    def count_flash(q, k, v, real_len, sm_scale):
        calls["flash"].append((q.shape[-1], sm_scale))
        return flash(q, k, v, real_len, sm_scale)

    def count_prep(*args):
        calls["qk_prep"] += 1
        return prep(*args)

    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA branch ran on the CPU")

    dense, flash, prep = t_attn.dense_sdpa, tfa.FlashAttention.apply, tqp.QKPrep.apply
    monkeypatch.setattr(t_attn, "dense_sdpa", count_dense)
    monkeypatch.setattr(tfa.FlashAttention, "apply", count_flash)
    monkeypatch.setattr(tqp.QKPrep, "apply", count_prep)
    for mod in (tfa, tqp):
        monkeypatch.setattr(mod, "_forward_cuda", no_cuda)
        monkeypatch.setattr(mod, "_backward_cuda", no_cuda)

    params, x, _ = _case(d)
    cfg = t_attn.AttentionConfig(embed_dim=HEADS * d, num_heads=HEADS)
    out, _ = t_attn.attention(params_from_numpy(params), cfg, torch.from_numpy(x),
                              rotary=t_precompute_rope(d, end=S))
    assert out.shape == x.shape
    assert calls["qk_prep"] == (2 if d in tqp.SUPPORTED_HEAD_DIMS else 0)
    if flash_width is None:
        assert calls["dense"] == 1 and calls["flash"] == []
    else:
        assert calls["dense"] == 0
        assert calls["flash"] == [(flash_width, 1.0 / math.sqrt(d))]


@pytest.mark.parametrize("d", [8, 48, 96])
def test_padded_route_keeps_the_real_scale(d):
    """The padded flash route scales by ``1/sqrt(d)`` of the real width, not
    of the padded one: its output equals ``dense_sdpa`` at width d, and the
    padded width's scale would not."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 200, 2, d)).astype(np.float32)) for _ in range(3))
    out = tfa.flash_sdpa(q, k, v)
    assert out.shape == q.shape
    torch.testing.assert_close(out, t_attn.dense_sdpa(q, k, v), rtol=1e-5, atol=1e-6)
    width = tfa.kernel_head_dim(d)
    assert width > d
    wrong = tfa.FlashAttention.apply(*(torch.nn.functional.pad(t.transpose(1, 2), (0, width - d))
                                       for t in (q, k, v)), 200, 1.0 / math.sqrt(width))
    assert not torch.allclose(wrong[..., :d].transpose(1, 2), out, rtol=1e-3, atol=1e-4)


def test_kernel_head_dim_names_the_next_width_and_refuses_wider():
    assert [tfa.kernel_head_dim(d) for d in (1, 16, 32, 33, 48, 64, 80, 112, 128)] == [
        32, 32, 32, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="dense path"):
        tfa.kernel_head_dim(129)


@pytest.mark.parametrize("sampler,kernels,refused", [
    ("auto", False, False),    # the plain loop on the card, as JAX's auto takes its scan off the TPU
    ("pallas", True, True),    # the kernels were asked for: refused, naming the limit
    ("scan", False, False),
])
def test_a_head_of_320_under_each_sampler(sampler, kernels, refused):
    """``HeadConfig(hidden_dim=320)`` on a CUDA device: ``"auto"`` builds and
    samples with the plain loop, ``"pallas"`` raises at construction naming
    K1's limit (no card is touched: the device only says where paths run)."""
    config = HeadConfig(hidden_dim=320, num_layers=2, sampler=sampler)
    cuda = torch.device("cuda")
    if refused:
        with pytest.raises(ValueError, match=rf"hidden_dim <= {ss.K1_MAX_HIDDEN}"):
            DiffusionTransitionHead(3, 8, 3, config, device=cuda)
        head = DiffusionTransitionHead(3, 8, 3, config)
    else:
        head = DiffusionTransitionHead(3, 8, 3, config, device=cuda)
    assert head.uses_kernels(cuda) is kernels
    assert head.uses_kernels(torch.device("cpu")) is False
    narrow = DiffusionTransitionHead(3, 8, 3, HeadConfig(hidden_dim=ss.K1_MAX_HIDDEN, sampler=sampler), device=cuda)
    assert narrow.uses_kernels(cuda) is (sampler != "scan")
