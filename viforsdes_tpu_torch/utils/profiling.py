"""Profiling helpers (twin of ``viforsdes_tpu/utils/profiling.py``).

``trace`` records the enclosed block with ``torch.profiler`` (host ops, and
the device's kernels when a CUDA device is present) and writes a Chrome trace
(viewable in Perfetto or ``chrome://tracing``); ``timed`` and ``benchmark``
are wall-clock timers that synchronize the CUDA device at both ends when one
is in use, and nothing otherwise.

Device spans split a training step into its layers on the device's own
timeline, inside a captured CUDA graph, where a host span would run only
once, at the capture. Each layer marks its boundaries through one helper
(``device_span`` around a forward block; ``on_grad`` where the backward
pass crosses into the next layer; ``mark`` for a boundary at a point of the
host code). They do nothing unless a recorder is active:

- ``recording_spans()`` keeps the sequence of boundaries on the host (the
  tests read it; a chunk's eager warm steps count it);
- ``marking_spans(ring)``, active while ``inference/chunk.py`` captures a
  chunk, also launches a marker kernel (``csrc/spans.cu``) at each boundary.
  The marker writes the global timer into its slot of ``ring`` and is named
  ``spans::begin<id>`` or ``spans::end<id>`` by the span's index in
  ``DEVICE_SPANS``, so a profiler trace alone splits the device timeline.
  At each marker the nodes captured so far are counted.

``set_device_spans(False)`` turns the markers off for the next capture
(they are on by default): the graph then holds the step's nodes alone.
``device_span_ms(trainer)`` reads the ring after the last replayed chunk.
Markers change no number of the step: they write only their ring, and the
backward boundaries are tensor hooks that leave the gradients as they are.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import time
from contextlib import AbstractContextManager, contextmanager
from typing import TYPE_CHECKING, Iterable, Iterator, NamedTuple

import torch
from torch import Tensor
from torch.profiler import ProfilerActivity, profile, record_function

from viforsdes_tpu_torch.ops.kernel_build import SPANS, raise_on

if TYPE_CHECKING:
    from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer

_TRACE_IDS = itertools.count()

# The spans of a training step; a span's marker kernels carry its index here.
# Per microbatch: theta (rsample, repeat), encoder with one attention child
# per block, sampler, elbo, then the backward pass: elbo.bwd, sampler.bwd,
# encoder.bwd with one attention.bwd child per block, grads.tail; once per
# step the optimizer, all inside step.
DEVICE_SPANS = (
    "step", "theta", "encoder", "attention", "sampler", "elbo",
    "elbo.bwd", "sampler.bwd", "encoder.bwd", "attention.bwd", "grads.tail", "optimizer",
)
_SPAN_IDS = {name: i for i, name in enumerate(DEVICE_SPANS)}


def _synchronize() -> None:
    """Wait for outstanding device work, where a CUDA device is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into ``log_dir``, as a
    Chrome trace file ``trace_<pid>_<n>.json``. The block is host span
    ``vtt.trace``: it names the host's time in the block outside every
    finer span (before the block's first launch, for one)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        with record_function("vtt.trace"):
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


# ------------------------------------------------------------ device spans

_device_spans = True
_recorder: SpanRecorder | None = None


def set_device_spans(on: bool) -> None:
    """Whether the next captured chunk holds span markers (on by default)."""
    global _device_spans
    _device_spans = bool(on)


def device_spans_enabled() -> bool:
    return _device_spans


class Boundary(NamedTuple):
    span: str
    begins: bool
    nodes: int  # graph nodes captured before its marker; -1 where none is launched


class SpanRecorder:
    """The span boundaries marked while it is active, in order; with a
    ``ring``, each one also launches its marker into the next slot."""

    def __init__(self, ring: Tensor | None = None) -> None:
        self.ring = ring
        self.boundaries: list[Boundary] = []

    def mark(self, span: str, begins: bool) -> None:
        span_id = _SPAN_IDS[span]
        nodes = -1
        if self.ring is not None:
            slot = len(self.boundaries)
            if slot >= self.ring.numel():
                raise RuntimeError(f"span ring of {self.ring.numel()} slots is full at {span!r}")
            nodes = _launch_marker(span_id, begins, self.ring, slot)
        self.boundaries.append(Boundary(span, begins, nodes))


def _launch_marker(span_id: int, begins: bool, ring: Tensor, slot: int) -> int:
    """Launch one marker on the current stream; the graph nodes captured
    before it."""
    nodes = ctypes.c_longlong(-1)
    err = SPANS.get().span_mark(
        span_id, int(begins), ring.data_ptr() + slot * ring.element_size(), ctypes.addressof(nodes),
        torch.cuda.current_stream(ring.device).cuda_stream,
    )
    raise_on(err, "span_mark")
    return nodes.value


def captured_nodes(stream: torch.cuda.Stream) -> int:
    """The nodes of the graph being captured on ``stream``."""
    nodes = ctypes.c_longlong(-1)
    raise_on(SPANS.get().span_captured_nodes(ctypes.addressof(nodes), stream.cuda_stream), "span_captured_nodes")
    return nodes.value


@contextmanager
def _active(recorder: SpanRecorder) -> Iterator[SpanRecorder]:
    global _recorder
    if _recorder is not None:
        raise RuntimeError("span recorders do not nest")
    _recorder = recorder
    try:
        yield recorder
    finally:
        _recorder = None


def recording_spans() -> AbstractContextManager[SpanRecorder]:
    """Keep the span boundaries of the enclosed block on the host."""
    return _active(SpanRecorder())


def marking_spans(ring: Tensor) -> AbstractContextManager[SpanRecorder]:
    """Launch a marker kernel at each span boundary of the enclosed block,
    the i-th into ``ring[i]`` (int64, on the device)."""
    return _active(SpanRecorder(ring))


def mark(span: str, begins: bool) -> None:
    """A span boundary at this point of the host code."""
    if _recorder is not None:
        _recorder.mark(span, begins)


@contextmanager
def device_span(span: str) -> Iterator[None]:
    """The enclosed block as span ``span``."""
    rec = _recorder
    if rec is None:
        yield
        return
    rec.mark(span, True)
    yield
    rec.mark(span, False)


def on_grad(tensors: Iterable[Tensor], *, end: str | None = None, begin: str | None = None) -> None:
    """In the backward pass, when the first of ``tensors`` gets its gradient
    (just before its grad_fn runs), end span ``end``, then begin span
    ``begin``. The autograd engine runs the nodes of a device in the reverse
    order of their creation, so that moment parts the backward of what made
    the tensors from the backward of what used them."""
    rec = _recorder
    if rec is None:
        return
    live = [t for t in tensors if t is not None and t.requires_grad]
    if not live:
        return
    fired = [False]

    def hook(_grad: Tensor) -> None:
        if not fired[0]:
            fired[0] = True
            if end is not None:
                rec.mark(end, False)
            if begin is not None:
                rec.mark(begin, True)

    for t in live:
        t.register_hook(hook)


class DeviceSpanTimes(NamedTuple):
    ms: dict[str, float]  # device ms per step in each span, its children included
    nodes: dict[str, float]  # graph nodes per step in each span, its children included, markers not


def device_span_ms(trainer: VariationalInferenceTrainer) -> DeviceSpanTimes | None:
    """Per span, device ms and graph nodes per step of the trainer's last
    replayed chunk, from its ring's global-timer stamps (waits for the
    device); None when no chunk with span markers has been replayed."""
    chunk = trainer._last_replay
    if chunk is None or chunk.spans is None:
        return None
    rec = chunk.spans
    if rec.ring.is_cuda:
        torch.cuda.synchronize(rec.ring.device)
    stamps = rec.ring.tolist()
    ms: dict[str, float] = {}
    nodes: dict[str, float] = {}
    opened: list[int] = []
    for i, b in enumerate(rec.boundaries):
        if b.begins:
            opened.append(i)
            continue
        j = opened.pop()
        if rec.boundaries[j].span != b.span:
            raise RuntimeError(f"span {b.span!r} ends inside {rec.boundaries[j].span!r}")
        ms[b.span] = ms.get(b.span, 0.0) + (stamps[i] - stamps[j]) * 1e-6 / chunk.length
        # the nodes between the two markers, less the markers among them
        inner = b.nodes - rec.boundaries[j].nodes - (i - j)
        nodes[b.span] = nodes.get(b.span, 0.0) + inner / chunk.length
    return DeviceSpanTimes(ms, nodes)
