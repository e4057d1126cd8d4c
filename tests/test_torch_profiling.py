"""The port's profiling helpers (``viforsdes_tpu_torch/utils/profiling.py``)
against the contracts of the JAX package's (``viforsdes_tpu/utils/profiling.py``):
the same three functions and signatures; ``timed`` stores seconds or prints
milliseconds; ``benchmark`` returns average seconds per call after its
warm-up; ``trace`` writes a trace of the block into a directory (here a
Chrome trace from ``torch.profiler``). Without a CUDA device in use nothing
synchronizes one."""

import inspect
import json
import time

import pytest
import torch

from viforsdes_tpu.utils import profiling as jax_profiling
from viforsdes_tpu_torch.utils import profiling


@pytest.fixture
def no_device_sync(monkeypatch):
    def refuse():
        raise AssertionError("synchronized a CUDA device that is not in use")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


@pytest.mark.parametrize("name", ["trace", "timed", "benchmark"])
def test_same_signatures_as_the_jax_helpers(name):
    ours, theirs = inspect.signature(getattr(profiling, name)), inspect.signature(getattr(jax_profiling, name))
    assert [(p.name, p.kind, p.default) for p in ours.parameters.values()] == [
        (p.name, p.kind, p.default) for p in theirs.parameters.values()
    ]


def test_timed_stores_seconds(no_device_sync):
    results = {}
    with profiling.timed("sleep", results):
        time.sleep(0.02)
    assert set(results) == {"sleep"}
    assert 0.02 <= results["sleep"] < 5.0


def test_timed_prints_without_results(no_device_sync, capsys):
    with profiling.timed("block"):
        pass
    out = capsys.readouterr().out
    assert out.startswith("[timed] block: ") and out.rstrip().endswith(" ms")


def test_timed_records_when_the_block_raises(no_device_sync):
    results = {}
    with pytest.raises(KeyError), profiling.timed("failing", results):
        raise KeyError("x")
    assert "failing" in results


def test_benchmark_averages_over_iters_after_warmup(no_device_sync):
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.002)

    seconds = profiling.benchmark(fn, 7, warmup=2, iters=5)
    assert calls == [7] * 7
    assert 0.002 <= seconds < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    a = torch.randn(16, 16)
    with profiling.trace(str(log_dir)):
        torch.mm(a, a)
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with profiling.trace(str(log_dir)):
        torch.mm(a, a)
    assert len(list(log_dir.glob("trace_*.json"))) == 2
