"""The yardstick's arithmetic, pinned to PERF.md's recorded figures."""

from __future__ import annotations

import pytest

from portbench.harness import work


def test_sampler_flop_at_lorenz_r3():
    # D=3, H=128, three layers, 9 outputs, batch 32, 2000 steps
    fwd, bwd = work.sampler_flop(3, 128, 3, 9, 32, 2000)
    assert round(fwd / 1e9, 2) == 31.75
    assert round(bwd / 1e9, 2) == 95.11


def test_flash_forward_flop_at_lorenz():
    assert round(2 * work.flash_product(32, 4, 2001, 64) / 1e9, 1) == 131.2


def test_bound_picks_the_larger_time():
    b = work.bound(989e9, 1.0, "bf16")
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "operations"
    b = work.bound(1.0, 3.35e9, "tf32")
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"


def test_sampler_work_leaves_out_the_recomputed_gates():
    fwd, bwd = work.sampler_flop(3, 128, 3, 9, 32, 2000)
    flop, n_bytes = work.sampler_work(3, 128, 3, 9, 32, 2000)
    gates = 2 * 3 * 128 * (3 + 128 + 2 * 2 * 128) * 32 * 2000
    assert flop == fwd + bwd - gates and n_bytes > 0


def test_step_flop_at_the_two_configurations():
    lorenz = work.step_flop(batch=32, n_grid=2001, hidden=256, cond=128, heads=4, depth=8, mlp_hidden=682,
                            param_dim=3, obs_dim=3, n_obs=401, state_dim=3, head_hidden=128, head_layers=3,
                            n_out=9)
    highdim = work.step_flop(batch=512, n_grid=101, hidden=256, cond=128, heads=4, depth=8, mlp_hidden=682,
                             param_dim=3, obs_dim=32, n_obs=21, state_dim=32, head_hidden=128, head_layers=2,
                             n_out=560)
    assert lorenz / 1e12 == pytest.approx(5.80, abs=0.01)
    assert highdim / 1e12 == pytest.approx(2.27, abs=0.01)


def test_kernel_names_cover_k1_to_k7():
    assert sorted(work.KERNEL_NAMES) == [f"K{i}" for i in range(1, 8)]
