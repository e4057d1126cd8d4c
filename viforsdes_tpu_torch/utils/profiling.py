"""Profiling helpers (twin of ``viforsdes_tpu/utils/profiling.py``).

``trace`` records the enclosed block with ``torch.profiler`` (host ops, and
the device's kernels when a CUDA device is present) and writes a Chrome trace
(viewable in Perfetto or ``chrome://tracing``); ``timed`` and ``benchmark``
are wall-clock timers that synchronize the CUDA device at both ends when one
is in use, and nothing otherwise.
"""

from __future__ import annotations

import itertools
import os
import time
from contextlib import contextmanager
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile

_TRACE_IDS = itertools.count()


def _synchronize() -> None:
    """Wait for outstanding device work, where a CUDA device is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into ``log_dir``, as a
    Chrome trace file ``trace_<pid>_<n>.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        _synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json"))


@contextmanager
def timed(label: str, results: dict | None = None) -> Iterator[None]:
    """Wall-clock a block, waiting for outstanding device work at both ends:
    seconds into ``results[label]``, or printed in ms."""
    _synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _synchronize()
        elapsed = time.perf_counter() - t0
        if results is not None:
            results[label] = elapsed
        else:
            print(f"[timed] {label}: {elapsed * 1000:.3f} ms")


def benchmark(fn, *args, warmup: int = 3, iters: int = 50) -> float:
    """Average seconds per call of ``fn(*args)`` over ``iters`` calls, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _synchronize()
    return (time.perf_counter() - t0) / iters
