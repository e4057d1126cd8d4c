"""``run.py``'s path rehearsed at a tiny size on the CPU, and its refusals."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.harness import spec
from portbench.tests.conftest import tiny


def test_rehearsal_of_a_run():
    cell = tiny("lorenz_r3.bf16")
    out = run.run_cell(cell, 12345, 0.0, False, "cpu")
    assert out.attempted == run.MIN_CHUNKS * cell.traffic["steps_per_call"] and out.failed == 0
    res = run.result(cell, out, False, "cpu rehearsal")
    assert list(res)[-1] == "checks"
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)


def test_rehearsal_of_a_traced_run():
    """The traced path on the CPU: the profiler sees no device, so every
    device reader finds nothing and leaves its metric out."""
    cell = tiny("highdim_r5.bf16")
    out = run.run_cell(cell, 7, 0.0, True, "cpu")
    assert out.trace is not None and out.trace.steps == cell.traffic["trace_chunks"] * cell.traffic["steps_per_call"]
    res = run.result(cell, out, True, "cpu rehearsal")
    assert "breakdown" in res and set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "sampler_ms" not in res["metrics"]


def test_same_seed_same_weights_and_numbers():
    a = run.run_cell(tiny("highdim_r5.bf16"), 99, None, False, "cpu")
    b = run.run_cell(tiny("highdim_r5.bf16"), 99, None, False, "cpu")
    assert a.numbers == b.numbers


def _run_py(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "lorenz_r3.bf16", "--seed",
                           "4294967311", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_refuses_without_a_card():
    res = _run_py(spec.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_refuses_with_only_the_benchmark(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_py(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "highdim_r5.bf16", "--seed", "5",
                          "--seconds", "2", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
