"""The host side of K1's launch (``ops/sde_sampler.py``): the unit-major
packed weights its matvecs read, the rows per block it picks by batch, and
the widest head it takes, checked when the model is built. The kernel itself
runs only on the card (``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from viforsdes_tpu_torch.config import HeadConfig
from viforsdes_tpu_torch.models.head import DiffusionTransitionHead
from viforsdes_tpu_torch.ops import sde_sampler as ss

# H=12 is not a whole number of 8-unit warps: units 12..15 are padding
D, H, L = 3, 12, 3
UNITS = 16
LD_OUT = 40  # at least UNITS and 8 mod 32
SPEC = ss.SamplerSpec(state_dim=D, hidden_dim=H, num_layers=L, time_step=0.01, diag_min=1e-3)


def _weights(seed: int) -> ss.SamplerWeights:
    rng = np.random.default_rng(seed)
    g, n_out = 3 * H, SPEC.n_out

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return ss.SamplerWeights(
        w_x=t(D, g), w_hh0=t(H, g), b_hh0=t(g), w_ih_st=t(L - 1, H, g), w_hh_st=t(L - 1, H, g),
        b_ih_st=t(L - 1, g), b_hh_st=t(L - 1, g), w_out=t(H, n_out), b_out=t(n_out),
    )


def _layer_rows(layer: int) -> int:
    return (D if layer == 0 else H) + H + 2


def _plan() -> ss.ForwardPlan:
    n_out = SPEC.n_out
    layers = sum(_layer_rows(l) for l in range(L)) * UNITS * 4
    out = n_out * LD_OUT + n_out + (-n_out % 4)
    return ss.ForwardPlan(True, 32 * 3, 0, 0, layers + out, LD_OUT, UNITS)


def _vec(rows: int, cols: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, cols)).astype(np.float32))


def _unpack(block: torch.Tensor) -> torch.Tensor:
    """[n, units, 4] -> the [n, 3H] matrix whose column g*H + k is {r, z, n}[g] of unit k."""
    return block[:, :H, :3].transpose(1, 2).reshape(block.shape[0], 3 * H)


@pytest.mark.parametrize("layer", range(L))
def test_packed_layer_gives_its_input_and_hidden_products(layer):
    """Rows 0..in-1 of a layer's block give the input product (x @ W_x for
    layer 0, h_below @ W_ih above), the next H rows h @ W_hh, the last two
    the input bias (zero for layer 0) and the hidden bias; the fourth slot
    and the units past H are zero."""
    w = _weights(layer)
    packed = ss.pack_forward_weights(SPEC, w, _plan())
    offset = sum(_layer_rows(l) for l in range(layer)) * UNITS * 4
    n_in = D if layer == 0 else H
    block = packed[offset : offset + _layer_rows(layer) * UNITS * 4].reshape(-1, UNITS, 4)
    w_in = w.w_x if layer == 0 else w.w_ih_st[layer - 1]
    w_hh = w.w_hh0 if layer == 0 else w.w_hh_st[layer - 1]
    b_in = torch.zeros(3 * H) if layer == 0 else w.b_ih_st[layer - 1]
    b_hh = w.b_hh0 if layer == 0 else w.b_hh_st[layer - 1]
    x, h = _vec(5, n_in, 1), _vec(5, H, 2)
    torch.testing.assert_close(x @ _unpack(block[:n_in]), x @ w_in, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(h @ _unpack(block[n_in : n_in + H]), h @ w_hh, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(_unpack(block[n_in + H : n_in + H + 1])[0], b_in, rtol=0, atol=0)
    torch.testing.assert_close(_unpack(block[n_in + H + 1 :])[0], b_hh, rtol=0, atol=0)
    assert not block[..., 3].any()
    assert not block[:, H:].any()


def test_packed_output_projection():
    """After the layers: W_out^T with row stride ld_out (zero past H), then
    b_out padded to whole float4s."""
    w = _weights(9)
    plan = _plan()
    packed = ss.pack_forward_weights(SPEC, w, plan)
    n_out = SPEC.n_out
    offset = sum(_layer_rows(l) for l in range(L)) * UNITS * 4
    out_t = packed[offset : offset + n_out * LD_OUT].reshape(n_out, LD_OUT)
    h = _vec(5, H, 3)
    torch.testing.assert_close(h @ out_t[:, :H].T, h @ w.w_out, rtol=1e-6, atol=1e-5)
    assert not out_t[:, H:].any()
    tail = packed[offset + n_out * LD_OUT :]
    torch.testing.assert_close(tail[:n_out], w.b_out, rtol=0, atol=0)
    assert tail.numel() % 4 == 0 and not tail[n_out:].any()


def test_forward_pack_refuses_a_plan_of_another_size():
    with pytest.raises(ValueError, match="the plan wants"):
        ss.pack_forward_weights(SPEC, _weights(0), _plan()._replace(packed_floats=1))


@pytest.mark.parametrize(
    "batch,want",
    [(1, 1), (32, 1), (128, 1), (132, 1), (133, 2), (264, 2), (265, 4), (528, 4), (5000, 4)],
)
def test_forward_rows_keeps_one_wave(batch, want):
    """K1 takes its rows per block by K2's rule: the fewest of 1, 2, 4 whose
    blocks fit one wave on 132 SMs (4 past that)."""
    rows = ss.rows_per_block(batch, n_sms=132)
    assert rows == want
    blocks = -(-batch // rows)
    assert blocks <= 132 or rows == ss.ROWS_PER_BLOCK[-1]
    smaller = [r for r in ss.ROWS_PER_BLOCK if r < rows]
    assert all(-(-batch // r) > 132 for r in smaller)


@pytest.mark.parametrize(
    "hidden,sampler,device,refused",
    [
        (256, "auto", "cuda", False),   # 32 warps of units: K1's widest, the last warp runs the output phase
        (264, "auto", "cuda", True),
        (264, "pallas", "cuda", True),
        (264, "scan", "cuda", False),   # the plain loop takes any width
        (264, "auto", "cpu", False),    # auto on the CPU is the plain loop
    ],
)
def test_a_head_wider_than_k1_takes_is_refused_at_construction(hidden, sampler, device, refused):
    """K1 runs one warp per 8 hidden units in at most 1024 threads, so it
    takes H <= 256; a wider head that would reach it is refused when the
    model is built, naming the limit and the plain sampler, not at the first
    step (no card is touched: the device only says where the paths run)."""
    assert ss.K1_MAX_HIDDEN == 1024 // 32 * 8
    config = HeadConfig(hidden_dim=hidden, num_layers=2, sampler=sampler)
    if refused:
        with pytest.raises(ValueError, match=r'hidden_dim <= 256; pass sampler="scan"'):
            DiffusionTransitionHead(3, 8, 3, config, device=torch.device(device))
    else:
        head = DiffusionTransitionHead(3, 8, 3, config, device=torch.device(device))
        assert head.hidden_dim == hidden
