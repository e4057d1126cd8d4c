"""The port's flash attention (``viforsdes_tpu_torch/ops/flash_attention.py``)
against the JAX package, its dispatch, and the kernel build's cache key.

On the CPU the port's wrappers take their plain versions, so these tests pin
the arithmetic the CUDA kernels K5-K7 are held to on the card:

- against the JAX package's forked Pallas flash kernel (``flash_attention_dqfix``)
  in TPU interpret mode at (1, 2, 512, 64) with 128-wide blocks: o to atol
  2e-6, dq, dk, dv to atol 3e-6 (the bars of ``tests/test_flash_attention.py``);
  in bf16, the working dtype of the tensor-core K6/K7, at S = 512 and at a
  ragged S with ``real_len``: o, dq, dk, dv to 1e-2 of their largest value;
- against JAX ``flash_sdpa`` with the dense masked reference and ``real_len``
  below S: values of the real rows to atol 2e-6, gradients (pad rows carry no
  cotangent, as in the encoder) to atol 1e-5 (fp32 sums over up to 1000 keys
  in another order).

Inputs are standard normals from numpy, seeded.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viforsdes_tpu.ops.flash_attention import _reference_masked_attention
from viforsdes_tpu.ops.flash_attention import flash_sdpa as j_flash_sdpa
from viforsdes_tpu_torch.ops import attention as t_attn
from viforsdes_tpu_torch.ops import flash_attention as tfa
from viforsdes_tpu_torch.ops import kernel_build
from viforsdes_tpu_torch.ops import qk_prep as tqp
from viforsdes_tpu_torch.ops.embeddings import precompute_rope
from viforsdes_tpu_torch.utils.convert import params_from_numpy


def _normals(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _torch_grads(fn, arrays, ct):
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ins)
    grads = torch.autograd.grad(out, ins, grad_outputs=torch.from_numpy(ct))
    return out.detach().numpy(), [g.numpy() for g in grads]


def test_matches_pallas_flash_kernel_in_interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes

    from viforsdes_tpu.ops.pallas.flash_fixed import flash_attention_dqfix

    b, h, s, d = 1, 2, 512, 64
    q, k, v, ct = _normals((b, h, s, d), 7, 4)
    bs = BlockSizes(
        block_q=128, block_k_major=128, block_k=128, block_b=1,
        block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
        block_q_dkv=128, block_k_major_dq=128, block_k_dq=128, block_q_dq=128,
    )
    sm = 1.0 / math.sqrt(d)

    def fix(q, k, v):
        return flash_attention_dqfix(q, k, v, sm_scale=sm, block_sizes=bs)

    with pltpu.force_tpu_interpret_mode():
        j_out = fix(q, k, v)
        j_grads = jax.grad(lambda *a: jnp.sum(fix(*a) * ct), argnums=(0, 1, 2))(q, k, v)
    t_out, t_grads = _torch_grads(lambda q, k, v: tfa.flash_sdpa(q, k, v, kernel_layout=True),
                                  (q, k, v), ct)
    np.testing.assert_allclose(t_out, np.asarray(j_out), atol=2e-6)
    for name, got, want in zip("qkv", t_grads, j_grads):
        np.testing.assert_allclose(got, np.asarray(want), atol=3e-6, err_msg=f"d{name}")


@pytest.mark.parametrize("s,real_len", [(512, None), (200, 150)])
def test_bf16_matches_pallas_flash_kernel_in_interpret_mode(s, real_len):
    """bf16 inputs, the Lorenz path's working dtype: the port's ``flash_sdpa``
    (its plain versions on the CPU: fp32 inside, results rounded to bf16)
    against the Pallas kernel in TPU interpret mode, which also rounds p and ds
    to bf16 before its products, as the tensor-core K6/K7 do on the card.
    The ragged S is padded to 256 for the Pallas kernel with the pad in the
    ``real_len`` segment, as the JAX package's ``flash_sdpa`` pads it; pad rows
    carry no cotangent, as in the encoder. Bar: max |err| <= 1e-2 * max |ref|
    for o and each gradient, a few bf16 roundings (2^-8 relative) of the
    largest value; the card's bf16 bars are 2e-2 and 3e-2."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, SegmentIds

    from viforsdes_tpu.ops.pallas.flash_fixed import flash_attention_dqfix

    b, h, d = 1, 2, 64
    padded = -(-s // 128) * 128
    q, k, v, ct = (jnp.asarray(a, jnp.bfloat16) for a in _normals((b, h, s, d), 8, 4))
    valid = s if real_len is None else real_len
    ct = ct.at[:, :, valid:].set(0)
    bs = BlockSizes(
        block_q=128, block_k_major=128, block_k=128, block_b=1,
        block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
        block_q_dkv=128, block_k_major_dq=128, block_k_dq=128, block_q_dq=128,
    )
    seg = None
    if padded != s or valid < s:
        ids = jnp.zeros((b, padded), jnp.int32).at[:, valid:].set(1)
        seg = SegmentIds(q=ids, kv=ids)
    sm = 1.0 / math.sqrt(d)

    def fix(q, k, v):
        q, k, v = (jnp.pad(t, ((0, 0), (0, 0), (0, padded - s), (0, 0))) for t in (q, k, v))
        out = flash_attention_dqfix(q, k, v, segment_ids=seg, sm_scale=sm, block_sizes=bs)
        return out[:, :, :s]

    with pltpu.force_tpu_interpret_mode():
        j_out = fix(q, k, v)
        j_grads = jax.grad(
            lambda *a: jnp.sum(fix(*a).astype(jnp.float32) * ct.astype(jnp.float32)),
            argnums=(0, 1, 2),
        )(q, k, v)

    def to_torch(t):
        return torch.tensor(np.asarray(t, np.float32)).bfloat16()

    ins = [to_torch(t).requires_grad_() for t in (q, k, v)]
    t_out = tfa.flash_sdpa(*ins, kernel_layout=True, real_len=real_len)
    t_grads = torch.autograd.grad(t_out, ins, grad_outputs=to_torch(ct))
    assert t_out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in t_grads)

    def check(got, want, what):
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        err, top = np.abs(got - want).max(), np.abs(want).max()
        assert err <= 1e-2 * top, f"{what}: max |err| {err:.3e}, max |ref| {top:.3e}"

    check(t_out[:, :, :valid], j_out[:, :, :valid], "o")
    for name, got, want in zip("qkv", t_grads, j_grads):
        check(got, want, f"d{name}")


@pytest.mark.parametrize("s,real_len", [(37, 30), (513, 400), (1000, 999)])
def test_matches_jax_flash_sdpa_reference_with_real_len(s, real_len):
    b, h, d = 2, 2, 32
    q, k, v, ct = _normals((b, s, h, d), s, 4)
    ct[:, real_len:] = 0.0  # the encoder gives pad rows no cotangent

    def j_fn(q, k, v):
        return j_flash_sdpa(q, k, v, impl=_reference_masked_attention, real_len=real_len)

    j_out = j_fn(q, k, v)
    j_grads = jax.grad(lambda *a: jnp.sum(j_fn(*a) * ct), argnums=(0, 1, 2))(q, k, v)
    t_out, t_grads = _torch_grads(lambda q, k, v: tfa.flash_sdpa(q, k, v, real_len=real_len),
                                  (q, k, v), ct)
    assert t_out.shape == (b, s, h, d)
    np.testing.assert_allclose(t_out[:, :real_len], np.asarray(j_out)[:, :real_len], atol=2e-6)
    for name, got, want in zip("qkv", t_grads, j_grads):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("real_len", [77, 50])
def test_plain_backward_matches_autograd(real_len):
    """The plain backward (``mha_reference_bwd`` with the scale, p from the
    saved log-sum-exp) equals autograd through the plain forward; the pad
    segment (rows from ``real_len`` on) included."""
    q, k, v, do = (torch.from_numpy(a) for a in _normals((2, 3, 77, 32), 11, 4))
    sm = 1.0 / math.sqrt(32)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tfa._forward_plain(*ins, real_len, sm)
    want = torch.autograd.grad(o, ins, grad_outputs=do)
    got = tfa._backward_plain(q, k, v, o.detach(), lse.detach(), do, real_len, sm)
    for name, a, r in zip("qkv", got, want):
        atol = 1e-6 * float(r.abs().max())
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=atol, err_msg=f"d{name}")


def test_plain_forward_segments():
    """Real queries see only real keys, pad queries only pad keys, and the lse
    is the log-sum-exp of the visible logits."""
    q, k, v = (torch.from_numpy(a) for a in _normals((1, 1, 9, 32), 12, 3))
    o, lse = tfa._forward_plain(q, k, v, 6, 0.5)
    real, _ = tfa._forward_plain(q[:, :, :6], k[:, :, :6], v[:, :, :6], 6, 0.5)
    pad, _ = tfa._forward_plain(q[:, :, 6:], k[:, :, 6:], v[:, :, 6:], 3, 0.5)
    torch.testing.assert_close(o, torch.cat([real, pad], dim=2))
    logits = (q @ k.transpose(-1, -2))[0, 0, 0, :6] * 0.5
    torch.testing.assert_close(lse[0, 0, 0], torch.logsumexp(logits, dim=0))


def _attention_case(s):
    cfg = t_attn.AttentionConfig(embed_dim=64, num_heads=2)
    params = params_from_numpy(
        {
            "qkv_proj": {"w": 0.2 * np.random.default_rng(0).standard_normal((64, 192)).astype(np.float32),
                         "b": np.zeros(192, np.float32)},
            "out_proj": {"w": 0.2 * np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32),
                         "b": np.zeros(64, np.float32)},
            "gate_proj": {"w": np.zeros((64, 32), np.float32), "b": np.zeros(32, np.float32)},
        }
    )
    x = torch.from_numpy(_normals((2, s, 64), 3, 1)[0]).requires_grad_()
    rotary = precompute_rope(32, end=2048).slice_to(s)
    return params, cfg, x, rotary


@pytest.mark.parametrize("s,flash", [(101, False), (512, False), (601, True)])
def test_dispatch_by_grid_length(monkeypatch, s, flash):
    """Grids of at most 512 tokens take dense_sdpa; longer ones the flash
    Function and the fused QK-prep, which take their plain versions on the CPU
    and never their CUDA branches."""
    calls = {"dense": 0, "flash": 0, "qk_prep": 0}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA branch ran on the CPU")

    monkeypatch.setattr(t_attn, "dense_sdpa", count("dense", t_attn.dense_sdpa))
    monkeypatch.setattr(tfa.FlashAttention, "apply", count("flash", tfa.FlashAttention.apply))
    monkeypatch.setattr(tqp.QKPrep, "apply", count("qk_prep", tqp.QKPrep.apply))
    for mod in (tfa, tqp):
        monkeypatch.setattr(mod, "_forward_cuda", no_cuda)
        monkeypatch.setattr(mod, "_backward_cuda", no_cuda)
    counters = [tfa.FORWARD_LAUNCHES, tfa.BACKWARD_DKV_LAUNCHES, tfa.BACKWARD_DQ_LAUNCHES,
                tqp.FORWARD_LAUNCHES, tqp.BACKWARD_LAUNCHES]
    for c in counters:
        c.reset()

    params, cfg, x, rotary = _attention_case(s)
    out, v_state = t_attn.attention(params, cfg, x, rotary=rotary)
    out.sum().backward()
    assert v_state.shape == (2, s, 2, 32)
    assert calls == {"dense": int(not flash), "flash": int(flash), "qk_prep": 2 * int(flash)}
    assert all(c.count == 0 for c in counters)
    assert tfa.use_flash_attention(s) is flash


def test_flash_and_dense_paths_agree_past_the_threshold(monkeypatch):
    """At 601 tokens the flash path (fused QK prep, flash SDPA) gives the dense
    path's values and input gradient (fp32; the two paths sum in other orders)."""
    params, cfg, x, rotary = _attention_case(601)
    out_f, v_f = t_attn.attention(params, cfg, x, rotary=rotary)
    (g_f,) = torch.autograd.grad(out_f.sum(), x)
    monkeypatch.setattr(t_attn, "use_flash_attention", lambda s: False)
    out_d, v_d = t_attn.attention(params, cfg, x, rotary=rotary)
    (g_d,) = torch.autograd.grad(out_d.sum(), x)
    torch.testing.assert_close(out_f, out_d, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v_f, v_d, rtol=0, atol=0)
    torch.testing.assert_close(g_f, g_d, rtol=1e-4, atol=1e-5)


def test_other_devices_raise():
    x = torch.empty(1, 2, 8, 32, device="meta")
    with pytest.raises(NotImplementedError):
        tfa.flash_forward(x, x, x, 8, 0.1)
    with pytest.raises(NotImplementedError):
        tfa.flash_backward(x, x, x, x, x[..., 0], x, 8, 0.1)
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        tfa._check(torch.zeros(1, 2, 8, 48), torch.zeros(1, 2, 8, 48), torch.zeros(1, 2, 8, 48))


@pytest.mark.parametrize("sm_scale", [0.0, -0.125, float("nan")])
def test_kernels_refuse_a_scale_that_is_not_positive(sm_scale):
    """K5 takes its row max on unscaled scores and K7 folds log2(scale) into
    its exponent, so the CUDA path refuses a scale that is not positive before
    it builds or launches anything."""
    with pytest.raises(ValueError, match="sm_scale must be positive"):
        tfa._check_scale(sm_scale)


def test_kernel_operand_keeps_aligned_views():
    qkv = torch.zeros(2, 10, 3 * 4 * 32, dtype=torch.bfloat16)
    q = torch.chunk(qkv, 3, dim=-1)[1].reshape(2, 10, 4, 32).transpose(1, 2)
    assert kernel_build.kernel_operand(q) is q
    odd = torch.zeros(2, 10, 3 * 4 * 32 + 1)[..., 1:].reshape(2, 10, 4, 96).transpose(1, 2)
    copy = kernel_build.kernel_operand(odd)
    assert copy is not odd and copy.is_contiguous() and torch.equal(copy, odd)


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 127, 128, 129, 2001])
def test_wgmma_plan_covers_every_row_and_fits(kernel, d, s):
    """The bf16 K5/K6/K7 launch plan: the grid's blocks cover every output row
    and no block starts past S; the streamed tiles cover every row of the
    other side; a block is two 64-row warpgroups and a producer warpgroup; a
    streamed tile is whole 16-row depth steps and one TMA box (at most 256
    rows); the ring's shared memory fits an H100 block's 232,448 bytes."""
    plan = tfa.flash_plan(kernel, d)
    blocks = -(-s // plan.rows)  # the kernels' grid: (blocks, H, B)
    assert blocks * plan.rows >= s > (blocks - 1) * plan.rows
    n_tiles = -(-s // plan.tile_rows)
    assert n_tiles * plan.tile_rows >= s > (n_tiles - 1) * plan.tile_rows
    assert plan.rows == 2 * 64 and plan.threads == 3 * 128
    assert plan.tile_rows % 16 == 0 and plan.tile_rows <= 256 and plan.stages >= 2
    assert plan.smem_bytes <= 232_448  # what an H100 block may opt in to
    # the tiles the ring holds, in bf16, below the total
    tiles = plan.stages * 2 * plan.tile_rows * d * 2
    assert tiles < plan.smem_bytes


def test_wgmma_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head_dim 48"):
        tfa.flash_plan("fwd", 48)
    with pytest.raises(ValueError, match="unknown kernel"):
        tfa.flash_plan("bwd", 64)


def test_tma_operand_keeps_readable_views_and_copies_the_rest():
    """The Lorenz path's strided q/k/v (1536-byte row strides, 128-byte head
    offsets) are read in place; views with a stride that is not a multiple of
    16 bytes, a misaligned base or a zero stride are copied first."""
    b, s, h, d = 2, 10, 4, 64
    qkv = torch.zeros(b, s, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in torch.chunk(qkv, 3, dim=-1))
    for t in (q, k, v):
        assert tfa.tma_readable(t) and tfa._tma_operand(t) is t
    odd = torch.zeros(b, s, h * d + 4, dtype=torch.bfloat16)[..., 4:].reshape(b, s, h * d)
    odd = odd.unflatten(-1, (h, d)).transpose(1, 2)  # rows 2 * (h d + 4) bytes apart
    shifted = torch.zeros(b * h * s * d + 1, dtype=torch.bfloat16)[1:].view(b, h, s, d)
    expanded = torch.zeros(1, h, s, d, dtype=torch.bfloat16).expand(b, h, s, d)
    for t in (odd, shifted, expanded):
        assert not tfa.tma_readable(t)
        copy = tfa._tma_operand(t)
        assert copy is not t and tfa.tma_readable(copy) and torch.equal(copy, t)


def test_unreadable_operand_is_refused_before_any_launch(monkeypatch):
    """A view TMA cannot read even after a copy raises in the wrapper, before
    the kernel library is built or anything is launched."""
    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(tfa, "tma_readable", lambda t: False)
    monkeypatch.setattr(tfa.ATTENTION, "get", no_library)
    counters = (tfa.FORWARD_LAUNCHES, tfa.BACKWARD_DKV_LAUNCHES, tfa.BACKWARD_DQ_LAUNCHES)
    before = [c.count for c in counters]
    x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA cannot read"):
        tfa._forward_cuda(x, x, x, 8, 0.125)
    with pytest.raises(ValueError, match="TMA cannot read"):
        tfa._backward_cuda(x, x, x, x, x[..., 0].float(), x, 8, 0.125)
    assert [c.count for c in counters] == before


def test_library_cache_key_covers_only_its_own_sources(tmp_path, monkeypatch):
    """Editing an attention source leaves the sampler library's cached path
    alone, and the reverse; a shared header edit changes its users' paths."""
    for src in kernel_build.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernel_build, "CSRC_DIR", tmp_path)
    sampler, attention = kernel_build.SDE_SAMPLER, kernel_build.ATTENTION

    def paths():
        return (kernel_build.library_path(sampler.name, sampler.sources),
                kernel_build.library_path(attention.name, attention.sources))

    assert "flash_attn.cuh" in kernel_build.dependencies(attention.sources)
    assert "attn_common.cuh" in kernel_build.dependencies(attention.sources)
    assert "hopper.cuh" in kernel_build.dependencies(attention.sources)
    assert kernel_build.dependencies(sampler.sources) == [
        "sde_sampler.cuh", "sde_sampler_bwd.cu", "sde_sampler_fwd.cu"]

    s0, a0 = paths()
    for name in ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "attn_common.cuh"):
        (tmp_path / name).write_text((tmp_path / name).read_text() + "\n// edited\n")
        s1, a1 = paths()
        assert s1 == s0 and a1 != a0
        a0 = a1
    (tmp_path / "sde_sampler.cuh").write_text((tmp_path / "sde_sampler.cuh").read_text() + "\n")
    s2, a2 = paths()
    assert s2 != s0 and a2 == a0
