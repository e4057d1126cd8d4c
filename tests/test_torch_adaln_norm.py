"""The SiT's fused norm site (``viforsdes_tpu_torch/ops/adaln_norm.py``):
gated residual, LayerNorm and adaLN modulation in one pass.

On the CPU: the explicit VJP that the backward kernel computes against
autograd through the eager composition; the rewired ``sit()`` against the
block-by-block composition it replaced, bit for bit; which operands the
kernels take. The tests marked ``card`` hold the kernels to the eager
composition on a CUDA device and skip without one:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adaln_norm.py -m card

(``--noconftest``: the suite's conftest sets up JAX, which this file does not use.)
"""

from __future__ import annotations

import pytest
import torch

from viforsdes_tpu_torch.ops import adaln_norm as an
from viforsdes_tpu_torch.ops.attention import attention
from viforsdes_tpu_torch.ops.cond import cond_modulator
from viforsdes_tpu_torch.ops.initializers import linear
from viforsdes_tpu_torch.ops.mlp import swiglu
from viforsdes_tpu_torch.ops.norms import layer_norm
from viforsdes_tpu_torch.ops.sit import SiTConfig, sit, sit_init

EPS = 1e-5
H = 256


def _site(shape, dtype, residual: bool, seed: int, device="cpu"):
    """x, y, gate, scale, shift and the cotangents of x_new and m; y and gate
    None without a residual."""
    gen = torch.Generator().manual_seed(seed)
    b, s, h = shape

    def draw(*dims, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*dims, generator=gen)).to(dtype).to(device)

    x, y = draw(b, s, h, mean=0.3), draw(b, s, h)
    gate, scale, shift = (draw(b, 1, h, std=0.3) for _ in range(3))
    dx_new, dm = draw(b, s, h), draw(b, s, h)
    if not residual:
        y = gate = None
    return x, y, gate, scale, shift, dx_new, dm


def _autograd(x, y, gate, scale, shift, dx_new, dm, dtype=None):
    """Gradients ``(dx, dy, dgate, dscale, dshift)`` by autograd through the
    eager composition, in ``dtype`` (the inputs' own by default)."""
    leaves = [None if t is None else t.detach().to(dtype or t.dtype).requires_grad_()
              for t in (x, y, gate, scale, shift)]
    x_new, m = an._forward_plain(*leaves, EPS)
    outs, cots = [m], [dm.to(m.dtype)]
    if y is not None:
        outs.append(x_new)
        cots.append(dx_new.to(m.dtype))
    live = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(outs, live, cots))
    return tuple(None if t is None else next(grads) for t in leaves)


def _plain_vjp(x, y, gate, scale, shift, dx_new, dm):
    x_new, _ = an._forward_plain(x, y, gate, scale, shift, EPS)
    stats = an._row_stats(x_new, EPS)
    return an._backward_plain(x_new, y, gate, scale, stats, None if y is None else dx_new, dm)


def _rel_err(a, ref) -> float:
    a, ref = a.detach().double(), ref.detach().double()
    return float((a - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("s", [1, 101, 2001])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_vjp_matches_autograd_through_the_composition(dtype, residual, s):
    """In fp32 the two agree to rounding (sums in another order); in bf16
    within one bf16 rounding of the largest gradient, and the VJP's fp32 math
    lies nearer fp32 autograd than bf16 autograd does, on every gradient."""
    case = _site((2, s, H), dtype, residual, seed=s + 7 * residual)
    got = _plain_vjp(*case)
    want = _autograd(*case)
    exact = _autograd(*case, dtype=torch.float64)
    for name, g, w, e in zip(("dx", "dy", "dgate", "dscale", "dshift"), got, want, exact):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        assert g.dtype == dtype and g.shape == w.shape, name
        if dtype == torch.float32:
            assert _rel_err(g, w) < 2e-6, name
        else:
            assert _rel_err(g, w) < 3e-2, name
            assert float((g.double() - e).norm()) <= float((w.double() - e).norm()), name


def _old_sit(params, cfg, x, *, cond, rotary=None):
    """``sit()`` as it ran before its norm sites were fused: block by block,
    each block's two residual adds, LayerNorms and modulations as eager ops."""
    tokens = linear(params["input_proj"], x)
    cached_v = None
    for idx, p in enumerate(params["blocks"]):
        a, m = cond_modulator(p["cond"], cond, branches=2)
        if cond.ndim == 2:
            a = type(a)(*(f.unsqueeze(1) for f in a))
            m = type(m)(*(f.unsqueeze(1) for f in m))
        modulated = (1 + a.scale) * layer_norm(tokens, eps=cfg.norm_eps) + a.shift
        attn_out, v = attention(p["attn"], cfg.block_attention_config(idx), modulated,
                                rotary=rotary, v0=cached_v)
        tokens = tokens + attn_out * a.gate_value
        modulated = (1 + m.scale) * layer_norm(tokens, eps=cfg.norm_eps) + m.shift
        tokens = tokens + swiglu(p["mlp"], modulated) * m.gate_value
        if cached_v is None:
            cached_v = v
    return linear(params["output_proj"], tokens)


def _random_tree(tree, gen):
    """Every leaf redrawn (std 0.1), so the zero-initialized modulations and
    gates carry gradient."""
    if isinstance(tree, dict):
        return {k: _random_tree(v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_random_tree(v, gen) for v in tree]
    return (0.1 * torch.randn(tree.shape, generator=gen)).requires_grad_()


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("per_token_cond", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sit_equals_the_block_by_block_composition(dtype, per_token_cond):
    """Outputs and every gradient (params, tokens, cond) to the bit."""
    cfg = SiTConfig(in_dim=32, hidden_dim=32, out_dim=16, cond_dim=8, num_heads=2, depth=3,
                    mlp_hidden_dim=48)
    gen = torch.Generator().manual_seed(11)
    params = _random_tree(sit_init(gen, cfg), gen)
    x = torch.randn(2, 9, 32, generator=gen).to(dtype).requires_grad_()
    cond_shape = (2, 9, 8) if per_token_cond else (2, 8)
    cond = torch.randn(cond_shape, generator=gen).to(dtype).requires_grad_()
    cot = torch.randn(2, 9, 16, generator=gen).to(dtype)
    leaves = [x, cond, *_leaves(params)]
    outs = []
    for fn in (sit, _old_sit):
        y = fn(params, cfg, x, cond=cond)
        outs.append((y, torch.autograd.grad(y, leaves, cot)))
    (y_new, g_new), (y_old, g_old) = outs
    assert torch.equal(y_new, y_old)
    for i, (a, b) in enumerate(zip(g_new, g_old)):
        assert torch.equal(a, b), i


def test_kernel_fits_only_the_broadcast_width_256_site():
    x = torch.zeros(2, 5, H, dtype=torch.bfloat16)
    row = torch.zeros(2, 1, H, dtype=torch.bfloat16)
    assert an.kernel_fits(x, x, row, row, row)
    assert an.kernel_fits(x, None, None, row, row)
    assert an.kernel_fits(x.float(), x.float(), row.float(), row.float(), row.float())
    per_token = torch.zeros(2, 5, H, dtype=torch.bfloat16)  # chunks of a [B, S, C] cond
    assert not an.kernel_fits(x, x, per_token, per_token, per_token)
    narrow, narrow_row = torch.zeros(2, 5, 64, dtype=torch.bfloat16), torch.zeros(2, 1, 64, dtype=torch.bfloat16)
    assert not an.kernel_fits(narrow, narrow, narrow_row, narrow_row, narrow_row)
    half, half_row = x.half(), row.half()
    assert not an.kernel_fits(half, half, half_row, half_row, half_row)
    assert not an.kernel_fits(x, x, row.float(), row, row)
    assert not an.kernel_fits(x[:, :0], x[:, :0], row, row, row)


def test_cpu_operands_take_the_eager_composition():
    x, y, gate, scale, shift, _, _ = _site((2, 7, H), torch.bfloat16, True, seed=3)
    before = (an.FORWARD_LAUNCHES.count, an.BACKWARD_LAUNCHES.count)
    got = an.gated_norm_modulate(x, y, gate, scale, shift, eps=EPS)
    want = an._forward_plain(x, y, gate, scale, shift, EPS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x_new, m = an.gated_norm_modulate(x, None, None, scale, shift, eps=EPS)
    assert x_new is x and torch.equal(m, an._forward_plain(x, None, None, scale, shift, EPS)[1])
    assert (an.FORWARD_LAUNCHES.count, an.BACKWARD_LAUNCHES.count) == before


# ------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


CARD_SHAPES = [(32, 2001, H), (512, 101, H)]  # the Lorenz r3 and highdim r5 cells' sites


def _ulps(a, ref, dtype):
    """|a - ref| in units of the data type's ulp at max(|ref|, 1): one unit is
    one rounding of a value of order one (the LayerNorm's output scale)."""
    mant = 7 if dtype == torch.bfloat16 else 23
    mag = ref.double().abs().clamp(min=1.0)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    return (a.double() - ref.double()).abs() / ulp


# m against the eager composition. The kernel's row statistics differ from the
# eager ones by a few fp32 roundings (summation order): in bf16 that flips the
# bf16 rounding of the mean or rstd in a few rows, one ulp more there; fp32
# keeps them unrounded, so they move m by |n| times as many roundings.
BF16_ULPS = 2.0
FP32_ULPS = 16.0


def _modulate_given(x_new, stats, scale, shift):
    """The modulated LayerNorm at ``layer_norm``'s rounding points, from the
    given fp32 (mean, rstd) instead of its own."""
    mean, rstd = stats[..., :1].to(x_new.dtype), stats[..., 1:].to(x_new.dtype)
    return (1 + scale) * ((x_new - mean) * rstd) + shift


@pytest.mark.card
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_the_composition_on_the_card(card, shape, dtype, residual):
    """x_new to the bit; m to the bit given the kernel's row statistics,
    which lie within a few fp32 roundings of the eager ones, and within
    ``BF16_ULPS`` / ``FP32_ULPS`` of the eager composition; the backward within fp32
    rounding of the plain VJP and within the bf16 bars of fp32 autograd;
    two runs bitwise equal."""
    case = _site(shape, dtype, residual, seed=shape[0] + 2 * residual, device=card)
    x, y, gate, scale, shift, dx_new, dm = case
    runs = []
    for _ in range(2):
        fwd = an._forward_cuda(x, y, gate, scale, shift, EPS)
        bwd = an._backward_cuda(fwd[0], y, gate, scale, fwd[2], dx_new if residual else None, dm)
        torch.cuda.synchronize()
        runs.append((*fwd, *(t for t in bwd if t is not None)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    x_new, m, stats = runs[0][:3]
    want_x_new, want_m = an._forward_plain(x, y, gate, scale, shift, EPS)
    assert torch.equal(x_new, want_x_new)
    assert torch.equal(m, _modulate_given(x_new, stats, scale, shift))
    assert torch.allclose(stats, an._row_stats(want_x_new, EPS), rtol=1e-5, atol=1e-6)
    assert float(_ulps(m, want_m, dtype).max()) <= (BF16_ULPS if dtype == torch.bfloat16 else FP32_ULPS)

    got = an._backward_cuda(x_new, y, gate, scale, stats, dx_new if residual else None, dm)
    plain = an._backward_plain(x_new, y, gate, scale, stats, dx_new if residual else None, dm)
    exact = _autograd(*case, dtype=torch.float32)
    for name, g, p, e in zip(("dx", "dy", "dgate", "dscale", "dshift"), got, plain, exact):
        if g is None:
            assert p is None and (e is None or not residual), name
            continue
        assert _rel_err(g, p) < (1e-5 if dtype == torch.float32 else 8e-3), name
        assert _rel_err(g, e) < (5e-5 if dtype == torch.float32 else 3e-2), name


@pytest.mark.card
def test_the_card_takes_the_eager_path_where_the_kernel_does_not_fit(card):
    x, y, gate, scale, shift, _, _ = _site((2, 9, 64), torch.bfloat16, True, seed=5, device=card)
    per_token = torch.zeros(2, 9, H, dtype=torch.bfloat16, device=card)
    before = an.FORWARD_LAUNCHES.count
    an.gated_norm_modulate(x, y, gate, scale, shift, eps=EPS)
    xx = torch.zeros(2, 9, H, dtype=torch.bfloat16, device=card)
    an.gated_norm_modulate(xx, xx, per_token, per_token, per_token, eps=EPS)
    assert an.FORWARD_LAUNCHES.count == before


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sit_on_the_card_launches_one_kernel_a_site(card, dtype):
    """Eight blocks at width 256: 16 forward and 16 backward launches; the
    output and the gradients near the block-by-block eager composition on the
    same card (the whole gradient's difference over its norm)."""
    cfg = SiTConfig(in_dim=H, hidden_dim=H, out_dim=H, cond_dim=32, num_heads=4, depth=8,
                    mlp_hidden_dim=512)
    gen = torch.Generator().manual_seed(13)
    params = _to(_random_tree(sit_init(gen, cfg), gen), card)
    x = torch.randn(2, 33, H, generator=gen).to(dtype).to(card)
    cond = torch.randn(2, 32, generator=gen).to(dtype).to(card)
    cot = torch.randn(2, 33, H, generator=gen).to(dtype).to(card)
    leaves = _leaves(params)
    out = {}
    for fn in (sit, _old_sit):
        an.FORWARD_LAUNCHES.reset()
        an.BACKWARD_LAUNCHES.reset()
        y = fn(params, cfg, x, cond=cond)
        grads = torch.cat([g.flatten().double() for g in torch.autograd.grad(y, leaves, cot)])
        out[fn] = (y, grads, an.FORWARD_LAUNCHES.count, an.BACKWARD_LAUNCHES.count)
    assert out[sit][2:] == (16, 16) and out[_old_sit][2:] == (0, 0)
    bar = 1e-5 if dtype == torch.float32 else 3e-2
    assert _rel_err(out[sit][0], out[_old_sit][0]) < bar
    assert float((out[sit][1] - out[_old_sit][1]).norm() / out[_old_sit][1].norm()) < bar


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.detach().to(device).requires_grad_()
