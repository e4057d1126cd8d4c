"""The host side of K2's BPTT launch (``ops/sde_sampler.py``): the packed
matrices its transposed matvecs read, and the rows per block it picks by
batch (the rule K1 shares). The kernel itself runs only on the card
(``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from viforsdes_tpu_torch.ops import sde_sampler as ss

D, H, L = 3, 16, 3


def _weights(seed: int) -> ss.SamplerWeights:
    rng = np.random.default_rng(seed)
    g = 3 * H

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return ss.SamplerWeights(
        w_x=t(D, g), w_hh0=t(H, g), b_hh0=t(g), w_ih_st=t(L - 1, H, g), w_hh_st=t(L - 1, H, g),
        b_ih_st=t(L - 1, g), b_hh_st=t(L - 1, g), w_out=t(H, D + 6), b_out=t(D + 6),
    )


def _plan(ld0: int, ld1: int) -> ss.BackwardPlan:
    return ss.BackwardPlan(ss.PATH_STAGED, 1, 1, 128, 0, 3 * H * (ld0 + (L - 1) * ld1), ld0, ld1, 0, 0, 0, 0)


SPEC = ss.SamplerSpec(state_dim=D, hidden_dim=H, num_layers=L, time_step=0.01, diag_min=1e-3)


@pytest.mark.parametrize("layer", range(L))
def test_packed_block_gives_both_transposed_matvecs(layer):
    """Columns 0..H-1 of a layer's block send d_gh back through W_hh (to
    h_{t-1}); the next columns send d_gi down through W_x (layer 0) or W_ih;
    the padding is zero."""
    w = _weights(layer)
    plan = _plan(40, 40)
    packed = ss.pack_bptt_weights(SPEC, w, plan)
    offset = 0 if layer == 0 else 3 * H * plan.ld0 + (layer - 1) * 3 * H * plan.ld1
    ld = plan.ld0 if layer == 0 else plan.ld1
    block = packed[offset : offset + 3 * H * ld].reshape(3 * H, ld)
    w_hh = w.w_hh0 if layer == 0 else w.w_hh_st[layer - 1]
    w_down = w.w_x if layer == 0 else w.w_ih_st[layer - 1]
    n_down = w_down.shape[0]
    dg = torch.from_numpy(np.random.default_rng(7).standard_normal((5, 3 * H)).astype(np.float32))
    torch.testing.assert_close(dg @ block[:, :H], dg @ w_hh.T, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dg @ block[:, H : H + n_down], dg @ w_down.T, rtol=1e-6, atol=1e-5)
    assert not block[:, H + n_down :].any()


def test_pack_refuses_a_plan_of_another_size():
    with pytest.raises(ValueError, match="the plan wants"):
        ss.pack_bptt_weights(SPEC, _weights(0), _plan(40, 48)._replace(packed_floats=1))


@pytest.mark.parametrize(
    "batch,want",
    [(1, 1), (32, 1), (128, 1), (132, 1), (133, 2), (264, 2), (265, 4), (528, 4), (5000, 4)],
)
def test_backward_rows_keeps_one_wave(batch, want):
    assert ss.cluster_rows(batch, 132, 4) == want
