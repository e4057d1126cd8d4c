"""K5, K6 and K7 with fp32 inputs (``csrc/flash_attn_fwd.cu``,
``fwd_tf32_kernel``; ``csrc/flash_attn_bwd.cu``, ``dkv_tf32_kernel`` and
``dq_tf32_kernel``): their launch plans as ``flash_plan`` mirrors them, and
why they run every product as three TF32 products.

The kernels split each fp32 operand x into hi = tf32(x) (10 mantissa bits,
rounded to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and lo =
tf32(x - hi), and take a b = a_hi b_hi + a_hi b_lo + a_lo b_hi with fp32
sums. Here that arithmetic is emulated in plain PyTorch (tf32 rounding by a
bit mask; tf32 x tf32 products are exact in fp32) on a small long-grid case
with a ``real_len`` segment: through the flash forward as K5 runs it (s, an
online softmax in base 2 over kv tiles of its plan's height, p split into
hi and lo, o += p v) and through the whole flash backward (s, p, dv, dp, ds,
dk, dq with p from the log-sum-exp). Against float64, 3xTF32 stays within
``chip_smoke.py``'s fp32 bars for the kernels on the card (elementwise
1e-4 |ref| + 1e-5 max|ref| for o and lse, 1e-3 |ref| + 1e-4 max|ref| for the
gradients), and one TF32 pass does not; the emulated o and gradients also
agree with the JAX package's reference attention (fp32, autodiff) within
those bars.

The CUDA kernels themselves run only on the card (``chip_smoke.py``); on the
CPU the wrappers take the plain forward and backward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viforsdes_tpu.ops.flash_attention import _reference_masked_attention
from viforsdes_tpu.ops.flash_attention import flash_sdpa as j_flash_sdpa
from viforsdes_tpu_torch.ops import flash_attention as tfa

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5  # chip_smoke.py's fp32 forward bars
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4  # chip_smoke.py's fp32 backward bars
SMEM_OPT_IN = 232_448            # what an H100 block may opt in to
SHAPE, REAL_LEN = (2, 2, 333, 64), 250


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to tf32: half an ulp (bit 12) added to the
    magnitude, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def _inputs(seed: int = 12):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _same_segment(s: int, real_len: int) -> torch.Tensor:
    seg = torch.arange(s) >= real_len
    return seg[:, None] == seg[None, :]


def _reference(q, k, v, do, real_len):
    """o, lse and (dq, dk, dv) in float64."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v, do = (t.double() for t in (q, k, v, do))
    logits = torch.where(_same_segment(q.shape[2], real_len), q @ k.transpose(-1, -2) * scale, -math.inf)
    lse = torch.logsumexp(logits, -1, keepdim=True)
    p = torch.exp(logits - lse)
    o = p @ v
    dv = p.transpose(-1, -2) @ do
    ds = p * (do @ v.transpose(-1, -2) - (o * do).sum(-1, keepdim=True)) * scale
    return o, lse, (ds @ k, ds.transpose(-1, -2) @ q, dv)


def _backward(q, k, v, do, o, lse, real_len, mm):
    """The kernels' backward with every product through ``mm``: p from the
    log-sum-exp, di = rowsum(o do) in fp32 outside the kernels."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.where(_same_segment(q.shape[2], real_len), torch.exp(s - lse), 0.0)
    dv = mm(p.transpose(-1, -2), do)
    ds = p * (mm(do, v.transpose(-1, -2)) - (o * do).sum(-1, keepdim=True)) * scale
    return mm(ds, k), mm(ds.transpose(-1, -2), q), dv


def _forward(q, k, v, real_len, mm):
    """K5's forward with both products through ``mm``: per kv tile of the
    plan's height, s = q k^T, the online softmax in base 2 with the scale
    folded into log2(e) (masked scores at the kernel's finite mask value),
    o += p v with p unrounded; then o / l and lse = m ln 2 + log l."""
    b, h, s, d = q.shape
    bk = tfa.flash_plan("fwd", d, torch.float32).tile_rows
    scale2 = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    same = _same_segment(s, real_len)
    m = torch.full((b, h, s, 1), -math.inf)
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros_like(q)
    for kv0 in range(0, s, bk):
        sc = mm(q, k[:, :, kv0:kv0 + bk].transpose(-1, -2))
        sc = torch.where(same[:, kv0:kv0 + bk], sc * scale2, tfa.DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)  # 0 on the first tile
        p = torch.exp2(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, v[:, :, kv0:kv0 + bk])
        m = m_new
    return o / l, (m * math.log(2.0) + torch.log(l))[..., 0]


def _worst_over_bar(got, want, rtol: float = BWD_RTOL, atol: float = BWD_ATOL) -> float:
    """Largest elementwise |got - want| over its bar rtol |want| + atol max|want|."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    bar = rtol * want.abs() + atol * want.abs().max()
    return float(((got - want).abs() / bar).max())


def _emulated(mm):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    o, lse, ref = _reference(q, k, v, do, REAL_LEN)
    return _backward(q, k, v, do, o.float(), lse.float(), REAL_LEN, mm), ref


def _emulated_forward(mm):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    o, lse, _ = _reference(q, k, v, do, REAL_LEN)
    return _forward(q, k, v, REAL_LEN, mm), (o, lse[..., 0])


def test_3xtf32_forward_holds_the_fp32_bars_and_one_tf32_pass_does_not():
    """K5's arithmetic over its 32-row kv tiles at head_dim 64: o and lse
    within ~0.03 of the forward bars in 3xTF32; one TF32 pass puts o ~30x
    past its bar (its lse stays within: the log-sum-exp averages the
    scores' rounding)."""
    (o, lse), (o_ref, lse_ref) = _emulated_forward(mm_3xtf32)
    assert _worst_over_bar(o, o_ref, FWD_RTOL, FWD_ATOL) < 0.1
    assert _worst_over_bar(lse, lse_ref, FWD_RTOL, FWD_ATOL) < 0.1
    (o1, _), _ = _emulated_forward(mm_tf32)
    assert _worst_over_bar(o1, o_ref, FWD_RTOL, FWD_ATOL) > 1.0


def test_3xtf32_forward_matches_the_jax_reference_attention():
    """The emulated K5 against the JAX package's ``flash_sdpa`` with its dense
    masked reference, fp32, on the real rows (rows from ``real_len`` on see
    the JAX function's zero padding, which the kernels mask instead)."""
    q, k, v, _ = _inputs()
    to_bshd = (0, 2, 1, 3)
    want = j_flash_sdpa(*(np.transpose(a, to_bshd) for a in (q, k, v)), impl=_reference_masked_attention,
                        real_len=REAL_LEN)
    want = np.transpose(np.array(want), to_bshd)[:, :, :REAL_LEN]
    o, _ = _forward(*(torch.from_numpy(a) for a in (q, k, v)), REAL_LEN, mm_3xtf32)
    assert _worst_over_bar(o[:, :, :REAL_LEN], want, FWD_RTOL, FWD_ATOL) < 1.0


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    r = tf32(x)
    assert bool((r.view(torch.int32) & 0x1FFF == 0).all())
    assert float(((x - r).abs() / x.abs()).max()) <= 2.0**-11
    # a tie (bit 12 alone below the kept bits) goes away from zero
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])
    assert tf32(tie).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]


@pytest.mark.parametrize("which", ["dq", "dk", "dv"])
def test_3xtf32_backward_holds_the_fp32_bars_and_one_tf32_pass_does_not(which):
    i = "dq dk dv".split().index(which)
    three, ref = _emulated(mm_3xtf32)
    one, _ = _emulated(mm_tf32)
    assert _worst_over_bar(three[i], ref[i]) < 0.05  # ~0.004 of the bar
    assert _worst_over_bar(one[i], ref[i]) > 1.0     # 2-4x the bar: TF32 alone keeps ~3 digits


def test_3xtf32_backward_matches_the_jax_reference_attention():
    """The emulated kernels' gradients against ``jax.grad`` through the JAX
    package's ``flash_sdpa`` with its dense masked reference, fp32, on the
    real rows (the encoder gives rows from ``real_len`` on no cotangent)."""
    q, k, v, do = _inputs()
    do[:, :, REAL_LEN:] = 0.0
    to_bshd = (0, 2, 1, 3)

    def j_fn(q, k, v):
        return j_flash_sdpa(q, k, v, impl=_reference_masked_attention, real_len=REAL_LEN)

    ct = np.transpose(do, to_bshd)
    j_grads = jax.grad(lambda *a: jnp.sum(j_fn(*a) * ct), argnums=(0, 1, 2))(
        *(np.transpose(a, to_bshd) for a in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse, _ = _reference(tq, tk, tv, tdo, REAL_LEN)
    got = _backward(tq, tk, tv, tdo, o.float(), lse.float(), REAL_LEN, mm_3xtf32)
    for name, a, want in zip(("dq", "dk", "dv"), got, j_grads):
        want = np.transpose(np.array(want), to_bshd)
        assert _worst_over_bar(a, want) < 1.0, name


def test_accumulator_as_a_fragment_meets_the_permuted_depth():
    """The register A fragment of a tf32 m64nNk8 step holds, in thread t of a
    quad, columns t and t + 4 (a0: row g, a1: g + 8, a2: g at t + 4, a3:
    g + 8 at t + 4); the accumulator chunk holds 2t and 2t + 1. The kernels
    pass (c0, c2, c1, c3) as (a0, a1, a2, a3), so depth p reads column 2p
    (p < 4) or 2(p - 4) + 1, and store B's depth u at (u >> 1) + 4 (u & 1)
    (``tf32_depth_pos``): the product is unchanged."""
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((16, 8)), rng.standard_normal((8, 4))
    pos = [(u >> 1) + 4 * (u & 1) for u in range(8)]
    assert sorted(pos) == list(range(8))
    b_stored = np.empty_like(b)
    b_stored[pos] = b  # depth u of B at position pos[u]
    a_hw = np.empty_like(a)  # what the tensor core reads at (row, depth)
    for g in range(8):
        for t in range(4):
            c = {0: a[g, 2 * t], 1: a[g, 2 * t + 1], 2: a[g + 8, 2 * t], 3: a[g + 8, 2 * t + 1]}
            a0, a1, a2, a3 = c[0], c[2], c[1], c[3]
            a_hw[g, t], a_hw[g + 8, t], a_hw[g, t + 4], a_hw[g + 8, t + 4] = a0, a1, a2, a3
    np.testing.assert_allclose(a_hw @ b_stored, a @ b, rtol=1e-12)


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 127, 128, 129, 2001])
def test_tf32_plan_covers_every_row_and_fits(kernel, d, s):
    """The fp32 K5/K6/K7 plan: blocks cover every output row, no block starts
    past S, the streamed tiles cover the other side; a block is one or two
    64-row consumer warpgroups and a producer warpgroup; a tile is whole
    8-row tf32 depth steps and one TMA box; the tiles with their lo parts
    (and K5's v^T, K6's q^T, do^T, K7's k^T) fit an H100 block's shared
    memory."""
    plan = tfa.flash_plan(kernel, d, torch.float32)
    blocks = -(-s // plan.rows)
    assert blocks * plan.rows >= s > (blocks - 1) * plan.rows
    n_tiles = -(-s // plan.tile_rows)
    assert n_tiles * plan.tile_rows >= s > (n_tiles - 1) * plan.tile_rows
    assert plan.rows in (64, 128) and plan.threads == 128 * (plan.rows // 64 + 1)
    assert plan.tile_rows % 8 == 0 and plan.tile_rows <= 32 and plan.stages >= 2
    assert plan.smem_bytes <= SMEM_OPT_IN
    # per stage, each hi and lo in fp32 (K5's v lands as TMA's rows alone)
    operands = {"fwd": 2.5, "dkv": 4, "dq": 3}[kernel]
    fixed = 1 if kernel == "fwd" else 2  # q; or q and do (K7), k and v (K6)
    tiles = fixed * (2 * plan.rows * d * 4) + plan.stages * operands * (2 * plan.tile_rows * d * 4)
    assert tiles < plan.smem_bytes


# The bf16 plans of K5-K7 (rows, tile rows, stages, threads,
# shared bytes), which the 3xTF32 kernels leave alone.
BF16_PLANS = {
    ("fwd", 32): (128, 128, 4, 384, 74824), ("fwd", 64): (128, 128, 4, 384, 148552),
    ("fwd", 128): (128, 64, 4, 384, 164936),
    ("dkv", 32): (128, 32, 4, 384, 34888), ("dkv", 64): (128, 32, 4, 384, 67656),
    ("dkv", 128): (128, 16, 4, 384, 99912),
    ("dq", 32): (128, 64, 4, 384, 50248), ("dq", 64): (128, 64, 4, 384, 99400),
    ("dq", 128): (128, 32, 4, 384, 132168),
}


@pytest.mark.parametrize("kernel,d", sorted(BF16_PLANS))
def test_bf16_plan_is_unchanged(kernel, d):
    assert tuple(tfa.flash_plan(kernel, d)) == BF16_PLANS[kernel, d]
    assert tfa.flash_plan(kernel, d, torch.bfloat16) == tfa.flash_plan(kernel, d)


def test_fp32_plan_at_the_lorenz_width():
    """Head_dim 64 (the Lorenz encoder's 256 / 4): 128-row blocks, 16-row
    tiles, K6 in 3 stages and K7 in 4, within 2 KB of the opt-in limit; K5,
    with only q fixed, 32-row kv tiles in 4 stages."""
    assert tuple(tfa.flash_plan("dkv", 64, torch.float32)) == (128, 16, 3, 384, 230872)
    assert tuple(tfa.flash_plan("dq", 64, torch.float32)) == (128, 16, 4, 384, 230512)
    assert tuple(tfa.flash_plan("fwd", 64, torch.float32)) == (128, 32, 4, 384, 230512)


def test_fp32_forward_has_no_wgmma_plan_and_other_dtypes_none():
    """(Named before K5 had a 3xTF32 kernel.) The fp32 forward now has its
    plan, a 3xTF32 one like K6's and K7's; float16 still has none."""
    plan = tfa.flash_plan("fwd", 64, torch.float32)
    assert plan.tile_rows % 8 == 0 and plan.threads == 384
    assert plan != tfa.flash_plan("fwd", 64, torch.bfloat16)
    for kernel in ("fwd", "dq"):
        with pytest.raises(ValueError, match="no kernel for"):
            tfa.flash_plan(kernel, 64, torch.float16)
