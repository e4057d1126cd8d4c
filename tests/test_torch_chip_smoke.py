"""The bound arithmetic of ``chip_smoke.py``: the least time the card could
take for each kernel (``bound_ms`` of its kernels line), the larger of its
operations over the peak rate of their type and its bytes over the memory
rate, at the Lorenz shapes. Tensors on the ``meta`` device carry the shapes
without memory. The expected figures are worked out by hand from the shapes:
one [S, S] x D product at [32, 4, 2001, 64] is 65.6 GFLOP, one bf16
[32, 4, 2001, 64] tensor 32.8 MB.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from viforsdes_tpu_torch.ops.sde_sampler import SamplerSpec

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

B, H, S, D = 32, 4, 2001, 64
PRODUCT = 2 * B * H * S * S * D


def _bhsd(dtype):
    return torch.empty((B, H, S, D), dtype=dtype, device="meta")


def _rows():
    return torch.empty((B, H, S), dtype=torch.float32, device="meta")


@pytest.mark.parametrize(
    "products,n_tensors,n_rows,dtype,peak,want_ms,want_by",
    [
        (2, 4, 1, torch.bfloat16, "bf16", 0.133, "operations"),  # K5: q, k, v -> o, lse
        (4, 6, 2, torch.bfloat16, "bf16", 0.265, "operations"),  # K6: q, k, v, do, lse, di -> dk, dv
        (3, 5, 2, torch.bfloat16, "bf16", 0.199, "operations"),  # K7: q, k, v, do, lse, di -> dq
        (4, 6, 2, torch.float32, "fp32", 3.92, "operations"),    # K6 on fp32 FMA
        (2, 4, 1, torch.float32, "fp32", 1.96, "operations"),    # K5 on fp32 FMA
        (0, 2, 0, torch.bfloat16, "fp32", 0.0196, "bytes"),      # K3: 65.6 MB, x -> out
        (0, 3, 0, torch.bfloat16, "fp32", 0.0294, "bytes"),      # K4: 98.4 MB, x, dy -> dx
    ],
)
def test_attention_bounds_at_the_lorenz_shape(products, n_tensors, n_rows, dtype, peak,
                                              want_ms, want_by):
    tensors = [_bhsd(dtype) for _ in range(n_tensors)] + [_rows() for _ in range(n_rows)]
    got = chip_smoke.bound(products * PRODUCT, chip_smoke.nbytes(tensors), peak)
    assert got["bound_ms"] == pytest.approx(want_ms, rel=5e-3)
    assert got["bound_by"] == want_by


def test_sampler_flop_at_the_lorenz_shape():
    """Per row and step (D=3, H=64, L=2, 9 outputs): gate products
    2*192*(3 + 64 + 128) = 74,880 and the output projection 2*64*9 = 1,152;
    K1 does each once, K2 the gates three times and the projection twice."""
    spec = SamplerSpec(state_dim=3, hidden_dim=64, num_layers=2, time_step=0.01, diag_min=1e-3)
    fwd, bwd = chip_smoke.sampler_flop(spec, 32, 2000)
    assert fwd == 64_000 * (74_880 + 1_152)
    assert bwd == 64_000 * (3 * 74_880 + 2 * 1_152)
    assert chip_smoke.bound(fwd, 0, "fp32")["bound_ms"] == pytest.approx(0.0726, rel=5e-3)


@pytest.mark.parametrize(
    "ms,steps,want_us",
    [
        (32.981, 2000, 16.4905),   # a 33 ms sampler call at T=2000: 16.5 us a step
        (10.429, 2000, 5.2145),    # a 10.4 ms one: 5.2 us a step
        (0.0726, 2000, 0.0363),    # K1's roofline bound at B=32, spread over the steps
    ],
)
def test_us_per_step_at_the_lorenz_shape(ms, steps, want_us):
    assert chip_smoke.us_per_step(ms, steps) == pytest.approx(want_us, rel=1e-9)


def test_nbytes_walks_containers_and_skips_the_rest():
    t = torch.empty((5, 7), dtype=torch.bfloat16, device="meta")
    spec = SamplerSpec(3, 64, 2, 0.01, 1e-3)
    assert chip_smoke.nbytes(t, (spec, None, [t, 3.0])) == 2 * 5 * 7 * 2


def _round_f32(v):
    """The float32 nearest to the exact rational ``v``, ties to even."""
    import fractions

    import numpy as np

    r = np.float32(float(v))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    dist = [abs(fractions.Fraction(float(c)) - v) for c in cands]
    best = min(dist)
    ties = [c for c, e in zip(cands, dist) if e == best]
    return min(ties, key=lambda c: int(np.float32(c).view(np.int32)) & 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_fma_gru_update_rounds_once(seed):
    """``fma_gru_update`` gives ``fmaf(z, h, (1 - z) * n)``: the product and
    the sum rounded once to fp32, checked against exact rationals on random
    values and on sums built to fall exactly between two floats."""
    import fractions

    import numpy as np

    rng = np.random.default_rng(seed)
    z = rng.uniform(0, 1, 400).astype(np.float32)
    h = rng.uniform(-1, 1, 400).astype(np.float32)
    n = rng.uniform(-1, 1, 400).astype(np.float32)
    # ties: z * h exactly half an ulp of p away from p, with p = (1 - z) * n
    z[:4], n[:4] = np.float32(0.5), np.float32(1.0)
    h[:4] = np.float32(2.0) ** np.float32(-24) * np.array([1, -1, 3, -3], np.float32)
    got = chip_smoke.fma_gru_update(torch, *(torch.from_numpy(a) for a in (z, h, n))).numpy()
    for i in range(len(z)):
        p = np.float32(np.float32(1.0) - z[i]) * n[i]
        exact = fractions.Fraction(float(z[i])) * fractions.Fraction(float(h[i])) + fractions.Fraction(float(p))
        assert got[i] == _round_f32(exact), i
