"""The traced window and each per-layer reader, on a synthetic timeline
with overlapping kernels, a copy and idle gaps."""

from __future__ import annotations

import pytest

from portbench.harness import spec, work
from portbench.harness.trace import WINDOW, from_events
from portbench.tests.conftest import tiny


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(WINDOW, "user_annotation", 1000.0, 1000.0),
    _x("cudaGraphLaunch", "cuda_runtime", 1000.0, 60.0),
    _x("aten::randn", "cpu_op", 1705.0, 295.0),
    _x("void sde_sampler::fwd_cluster_kernel<3, 128>(Args)", "kernel", 1100.0, 200.0),
    _x("void sde_sampler::bptt_cluster_kernel<3, 128>(Args)", "kernel", 1150.0, 100.0),  # overlaps
    _x("void flash::fwd_wgmma_kernel<64>(Params)", "kernel", 1300.0, 100.0),
    _x("void qk_prep::qk_prep_kernel<64, false>(Args)", "kernel", 1400.0, 50.0),
    _x("void flash::dq_tf32_kernel<64>(Params)", "kernel", 1450.0, 50.0),
    _x("sm90_xmma_gemm_bf16bf16", "kernel", 1500.0, 200.0),
    _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1700.0, 10.0),
    _x("void elementwise_kernel", "kernel", 950.0, 100.0),  # starts before the window
    _x("void late_kernel", "kernel", 2500.0, 10.0),  # after it
]


@pytest.fixture
def run():
    from portbench import run as run_mod
    from portbench.harness import problem

    cell = spec.load_cell("lorenz_r3.bf16")
    sde = problem.make_sde(cell.config)
    times, values = problem.observations(cell.config)
    shapes = problem.shapes(cell.config, values.shape[-1], sde)
    return run_mod.LayerRun(from_events(EVENTS, steps=2), 100.0, cell.config, cell.traffic, shapes)


def test_window_busy_and_gaps(run):
    t = run.trace
    assert t.window_s == pytest.approx(1e-3)
    # union: [1000, 1050] (clipped), [1100, 1710]
    assert t.busy_s == pytest.approx((50 + 610) * 1e-6)
    gaps = t.named_gaps(10)
    assert [g[1] for g in gaps] == pytest.approx([290e-6, 50e-6])
    assert [g[0] for g in gaps] == ["aten::randn", "cudaGraphLaunch"]
    b = t.breakdown(3)
    assert b["device_ops"][0] == ["void sde_sampler::fwd_cluster_kernel<3, 128>(Args)", pytest.approx(200e-6)]
    assert len(b["device_ops"]) == 3 and len(b["idle_gaps"]) == 2


def test_gap_named_by_the_innermost_host_span():
    events = [*EVENTS, _x("outer", "user_annotation", 1700.0, 300.0), _x("inner", "cpu_op", 1708.0, 10.0)]
    gaps = from_events(events, 2).named_gaps(1)
    assert gaps[0][0] == "inner"


def _read(run, name):
    cell = spec.load_cell("lorenz_r3.bf16")
    return cell.metric_module({"name": name}).read(run)


def test_device_idle_share(run):
    assert _read(run, "device_idle_share") == pytest.approx(100 * (1 - 660 / 1000))


def test_sampler_ms_and_roofline(run):
    assert _read(run, "sampler_ms") == pytest.approx(300e-6 * 1e3 / 2)
    s = run.shapes
    flop, n_bytes = work.sampler_work(s.state_dim, s.head_hidden, s.head_layers, s.n_out, 32, s.n_grid - 1)
    expect = 100 * work.bound(flop, n_bytes, "tf32")["bound_ms"] / 0.15
    assert _read(run, "sampler_roofline") == pytest.approx(expect)


def test_attention_and_flash(run):
    assert _read(run, "attn_kernels_ms") == pytest.approx(200e-6 * 1e3 / 2)
    s = run.shapes
    flop, n_bytes = work.flash_work(32, s.heads, s.n_grid, s.head_dim, 2)
    expect = 100 * 8 * work.bound(flop, n_bytes, "bf16")["bound_ms"] / (150e-6 * 1e3 / 2)
    assert _read(run, "flash_roofline") == pytest.approx(expect)


def test_dense_ops_counts_kernels_only(run):
    # the gemm, and the clipped elementwise kernel; not the copy
    assert _read(run, "dense_ops_ms") == pytest.approx((200 + 50) * 1e-6 * 1e3 / 2)


def test_mfu(run):
    value = _read(run, "mfu")
    assert value == pytest.approx(100 * 5.798457291264e12 / 0.1 / 989e12, rel=1e-6)


def test_readers_return_nothing_where_nothing_ran(run):
    run.trace = from_events([EVENTS[0], EVENTS[1]], steps=2)
    for name in ("device_idle_share", "sampler_ms", "sampler_roofline", "attn_kernels_ms", "flash_roofline",
                 "dense_ops_ms"):
        assert _read(run, name) is None


def test_one_window_span_required():
    with pytest.raises(RuntimeError):
        from_events(EVENTS[1:], 2)
