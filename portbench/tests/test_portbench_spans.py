"""The span reader (``harness/spans.py``) and its per-layer metrics, on
synthetic Chrome traces: nesting and self time, markers counted in no
span, dropped marker records, a trace without markers; the benchmark's
span table against the program's; the new ``BENCHMARK.json`` entries."""

from __future__ import annotations

import json

import pytest

from portbench.harness import spans, spec
from portbench.harness.trace import WINDOW, from_events

NEW_METRICS = ("encoder_span_ms", "attention_span_ms", "sampler_span_ms", "elbo_span_ms", "optimizer_span_ms",
               "unspanned_ms", "launches_per_step", "dense_launches_per_step")


def _x(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _marker(span, begins, ts):
    kind = "begin" if begins else "end"
    return _x(f"void spans::{kind}<{spans.SPANS.index(span)}>(unsigned long long*)", ts, 1.0)


def _step(t0):
    """One step's device timeline from ``t0`` (microseconds), one record
    every 50 us: 24 markers, 12 kernels (durations in the list) and a
    fill."""
    spec_ = [
        ("+step",), ("+theta",), ("k", 1), ("-theta",),
        ("+encoder",), ("k", 4), ("+attention",), ("k", 7), ("-attention",), ("k", 5), ("-encoder",),
        ("+sampler",), ("k", 20), ("-sampler",),
        ("+elbo",), ("k", 6), ("-elbo",),
        ("+elbo.bwd",), ("k", 2), ("-elbo.bwd",),
        ("+sampler.bwd",), ("k", 30), ("-sampler.bwd",),
        ("+encoder.bwd",), ("+attention.bwd",), ("k", 8), ("-attention.bwd",), ("k", 3), ("-encoder.bwd",),
        ("+grads.tail",), ("k", 3), ("-grads.tail",),
        ("+optimizer",), ("k", 9), ("fill", 1), ("-optimizer",),
        ("-step",),
    ]
    events, t = [], t0
    for item in spec_:
        if item[0] == "k":
            events.append(_x("void at::native::elementwise_kernel<128, 4>(int, Fn)", t, item[1]))
        elif item[0] == "fill":
            events.append(_x("Memset (Device)", t, item[1], cat="gpu_memset"))
        else:
            events.append(_marker(item[0][1:], item[0][0] == "+", t))
        t += 50.0
    return events, t


def _window(n_steps=2):
    events, t = [], 1000.0
    events.append(_x("Memcpy HtoD (Pinned -> Device)", t, 4.0, cat="gpu_memcpy"))  # the draws' copy
    events.append(_x("void at::native::normal_kernel(Gen)", t + 10, 2.0))  # a draw
    t += 20.0
    for _ in range(n_steps):
        step, t = _step(t)
        events += step
    return [_x(WINDOW, 900.0, t - 800.0, cat="user_annotation"), *events]


class _Run:
    def __init__(self, events, steps=2):
        self.trace = from_events(events, steps)


def _read(name, run):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py", name).read(run)


def test_families_are_self_times_per_step():
    run = _Run(_window())
    got = {name: _read(name, run) for name in NEW_METRICS}
    us = 1e-3  # one microsecond in ms
    assert got["encoder_span_ms"] == pytest.approx((4 + 5 + 3) * us)
    assert got["attention_span_ms"] == pytest.approx((7 + 8) * us)
    assert got["sampler_span_ms"] == pytest.approx((20 + 30) * us)
    assert got["elbo_span_ms"] == pytest.approx((6 + 2) * us)
    assert got["optimizer_span_ms"] == pytest.approx(9 * us)  # kernels only: the fill is not timed
    # theta 1, grads.tail 3 per step, the draw kernel 2 over 2 steps
    assert got["unspanned_ms"] == pytest.approx((1 + 3 + 1) * us)
    # kernels, copies and fills, markers excluded: 13 a step, and the copy and the draw over 2 steps
    assert got["launches_per_step"] == pytest.approx(13 + 1)
    # encoder self 3, elbo 2, optimizer kernel and fill 2
    assert got["dense_launches_per_step"] == pytest.approx(7)


def test_the_families_and_the_rest_partition_the_kernels():
    """The five families and ``unspanned_ms`` add up to every kernel that
    is not a marker: the sum of ``sampler_ms``, ``attn_kernels_ms`` and
    ``dense_ops_ms`` less the markers."""
    run = _Run(_window())
    total = sum(_read(n, run) for n in NEW_METRICS[:6])
    kernels = run.trace.kernel_s(lambda name: not spans.MARKER.search(name)) * 1e3 / run.trace.steps
    assert total == pytest.approx(kernels)
    assert spans.split(run.trace).markers == 2 * 24


def _without(span: str, kind: str) -> list[dict]:
    """The window with the first step's ``kind`` marker of ``span`` lost."""
    events = _window()
    lost = f"void spans::{kind}<{spans.SPANS.index(span)}>"
    index = next(i for i, e in enumerate(events) if e["name"].startswith(lost))
    return events[:index] + events[index + 1:]


def test_a_dropped_begin_moves_no_later_operation():
    """The first step's ``+sampler`` record lost: its kernel falls to the
    step (unspanned), the unmatched end is passed over, and the second
    step reads as before."""
    run = _Run(_without("sampler", "begin"))
    us = 1e-3
    assert _read("sampler_span_ms", run) == pytest.approx((20 / 2 + 30) * us)
    assert _read("unspanned_ms", run) == pytest.approx((1 + 3 + 1 + 20 / 2) * us)
    for name in ("encoder_span_ms", "attention_span_ms", "elbo_span_ms", "optimizer_span_ms"):
        assert _read(name, run) == pytest.approx(_read(name, _Run(_window())))


def test_a_dropped_end_is_closed_by_its_parent():
    """The first step's ``-attention`` record lost: the encoder's end closes
    it, so only the encoder's second forward kernel moves into attention."""
    run = _Run(_without("attention", "end"))
    us = 1e-3
    assert _read("attention_span_ms", run) == pytest.approx((7 + 8 + 5 / 2) * us)
    assert _read("encoder_span_ms", run) == pytest.approx((4 + 5 / 2 + 3) * us)
    assert _read("sampler_span_ms", run) == pytest.approx(50 * us)


def test_no_marker_reads_none():
    """A program without spans (the parent of the change that added them):
    every new metric is left out."""
    events = [e for e in _window() if "spans::" not in e["name"]]
    run = _Run(events)
    assert all(_read(name, run) is None for name in NEW_METRICS)
    assert spans.split(run.trace) is None


def test_markers_are_kernels_of_no_family():
    s = spans.split(_Run(_window()).trace)
    assert s.total_ops() == 2 * 13 + 2
    assert spans.MARKER.search("void spans::end<11>(unsigned long long*)").groups() == ("end", "11")
    assert spans.MARKER.search("void sde_sampler::fwd_cluster_kernel<3, 128>(Args)") is None


def test_span_table_is_the_programs():
    from viforsdes_tpu_torch.utils import profiling

    assert spans.SPANS == profiling.DEVICE_SPANS
    assert {s for family in spans.FAMILIES.values() for s in family} | {"step", "theta", "grads.tail"} \
        == set(spans.SPANS)


def test_new_entries_in_benchmark_json():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_METRICS:
        m = entries[name]
        assert m["moves"] == "step_ms" and m["source"] == "device_trace" and "workloads" not in m
        assert m["unit"] == ("launches/step" if "launches" in name else "ms/step")
        assert callable(spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py", name).read)
    assert [m["name"] for m in bench["per_layer"]][-len(NEW_METRICS):] == list(NEW_METRICS)
