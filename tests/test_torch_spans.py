"""Device spans inside the port's training step (``utils/profiling.py``), on
the CPU: the boundaries one ``_step_math`` marks, forward and backward, at
one and two microbatches; a step with spans on equals one without, to the
bit; a captured chunk launches one marker per boundary, and none with the
switch off; ``device_span_ms`` from a ring's stamps and node counts; the
host spans of ``train()``; the marker source's span count.

The card-only parts (markers in a traced replay, the ring against the
trace, the graph's node count, the cost) are ``chip_smoke.py``'s
``[spans]``.
"""

from __future__ import annotations

import contextlib
import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import viforsdes_tpu_torch as tvt
from viforsdes_tpu_torch.inference.optimizer import GROUPS
from viforsdes_tpu_torch.ops.kernel_build import SPANS
from viforsdes_tpu_torch.utils import profiling

DEPTH = 2


class OU:
    state_dim = 1
    sde_param_dim = 3

    def drift(self, x, p):
        return p[..., 0:1] * (p[..., 1:2] - x)

    def diffusion(self, x, p):
        return p[..., 2:3][..., None]


@pytest.fixture(autouse=True)
def _one_thread_spans_on():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    profiling.set_device_spans(True)


def _trainer(**training):
    cfg = tvt.TrainingConfig(**{"time_step": 0.25, "batch_size": 8, "n_iterations": 6, "iw_samples": 2,
                                **training})
    return tvt.VariationalInferenceTrainer(
        OU(),
        tvt.Observations(times=[0.0, 0.5, 1.0, 1.5, 2.0], values=[[2.0], [1.5], [0.8], [1.2], [0.9]]),
        tvt.GaussianObservationLikelihood(variance=0.1),
        tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
        2.0,
        cfg,
        tvt.EncoderConfig(hidden_dim=16, cond_dim=16, num_heads=2, depth=DEPTH),
        tvt.HeadConfig(hidden_dim=8, num_layers=2),
        state_positive_dims=[],
        sde_param_positive_dims=[0, 2],
        console=tvt.Console(enabled=False),
        device="cpu",
    )


def _state(trainer) -> dict:
    s = trainer.opt_state
    out = {f"params/{g}": trainer.flat_params[g] for g in GROUPS}
    out.update({f"ema/{g}": trainer.flat_ema[g] for g in GROUPS})
    out.update({f"mu/{g}": s["mu"][g] for g in GROUPS})
    out.update({f"nu/{g}": s["nu"][g] for g in GROUPS})
    out.update({k: s[k] for k in ("count", "notfinite_count", "total_notfinite")})
    return out


def _step(trainer, step: int = 0):
    return trainer._step_math(trainer.flat_params, trainer.opt_state, trainer.flat_ema, trainer.draws(step))


def _signs(boundaries) -> list[str]:
    return [("+" if b.begins else "-") + b.span for b in boundaries]


def _microbatch() -> list[str]:
    """The boundaries of one microbatch at ``DEPTH`` blocks."""
    return [
        "+theta", "-theta",
        "+encoder", *["+attention", "-attention"] * DEPTH, "-encoder",
        "+sampler", "-sampler",
        "+elbo", "-elbo",
        "+elbo.bwd", "-elbo.bwd",
        "+sampler.bwd", "-sampler.bwd",
        "+encoder.bwd", *["+attention.bwd", "-attention.bwd"] * DEPTH, "-encoder.bwd",
        "+grads.tail", "-grads.tail",
    ]


@pytest.mark.parametrize("accum", [1, 2])
def test_boundaries_of_one_step(accum):
    """Forward spans in the order the step runs them, then the backward's
    in the reverse order of the layers, an attention child per block in
    both; once per microbatch, all inside ``step``, the optimizer last."""
    t = _trainer(grad_accum_steps=accum)
    with profiling.recording_spans() as rec:
        _step(t)
    assert _signs(rec.boundaries) == ["+step", *_microbatch() * accum, "+optimizer", "-optimizer", "-step"]
    stack = []
    for b in rec.boundaries:
        if b.begins:
            stack.append(b.span)
        else:
            assert stack.pop() == b.span
        assert b.nodes == -1  # the host recorder launches nothing
    assert not stack
    assert {b.span for b in rec.boundaries} == set(profiling.DEVICE_SPANS)


@pytest.mark.parametrize("accum", [1, 2])
def test_a_step_with_spans_equals_one_without(monkeypatch, accum):
    """Params, EMA, AdamW moments and counters, and every metric, bitwise
    the same with spans recorded on the host, with markers launched (the
    launch replaced by a counter on the CPU), and with neither."""
    launched = []
    monkeypatch.setattr(profiling, "_launch_marker",
                        lambda span_id, begins, ring, slot: launched.append(slot) or len(launched))
    plain, host, marked = (_trainer(grad_accum_steps=accum) for _ in range(3))
    outs = {"plain": [], "host": [], "marked": []}
    for step in range(2):
        outs["plain"].append(_step(plain, step)[3])
        with profiling.recording_spans():
            outs["host"].append(_step(host, step)[3])
        with profiling.marking_spans(torch.zeros(200, dtype=torch.int64)) as rec:
            outs["marked"].append(_step(marked, step)[3])
        assert len(launched) == len(rec.boundaries) * (step + 1)
    for other in (host, marked):
        sa, sb = _state(plain), _state(other)
        for name in sa:
            assert torch.equal(sa[name], sb[name]), name
    for name in ("host", "marked"):
        for a, b in zip(outs["plain"], outs[name]):
            for x, y in zip(a, b):
                assert torch.equal(x, y)


def test_no_recorder_no_hook():
    """Without a recorder the helpers mark nothing and hook nothing."""
    x = torch.ones(3, requires_grad=True) * 2.0
    profiling.on_grad((x,), end="elbo.bwd", begin="sampler.bwd")
    assert x._backward_hooks is None
    with profiling.device_span("encoder"):
        profiling.mark("step", True)
    with profiling.recording_spans() as rec:
        y = torch.ones(3, requires_grad=True) * 2.0
        profiling.on_grad((y,), end="elbo.bwd", begin="sampler.bwd")
        profiling.on_grad((y.detach(),), begin="theta")  # no gradient: no boundary
        y.sum().backward()
    assert _signs(rec.boundaries) == ["-elbo.bwd", "+sampler.bwd"]


def test_an_unknown_span_is_refused():
    with profiling.recording_spans(), pytest.raises(KeyError):
        profiling.mark("decoder", True)


def test_recorders_do_not_nest():
    with profiling.recording_spans(), pytest.raises(RuntimeError, match="nest"):
        with profiling.recording_spans():
            pass


class _FakeStream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_capture(monkeypatch):
    """The CUDA calls of ``TrainChunk._warm_and_capture`` replaced, so the
    capture path runs its steps eagerly on the CPU; marker launches and node
    counts by counters."""
    launched = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: SimpleNamespace(replay=lambda: None))
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(profiling, "_launch_marker",
                        lambda span_id, begins, ring, slot: launched.append(
                            (profiling.DEVICE_SPANS[span_id], begins, slot)) or 3 * slot)
    monkeypatch.setattr(profiling, "captured_nodes", lambda stream: 1000)
    return launched


@pytest.mark.parametrize("on", [True, False])
def test_a_capture_launches_one_marker_per_boundary(fake_capture, on):
    """Switch on: one marker per boundary of the chunk's K steps, slot by
    slot, the boundaries those the warm steps counted, and a ring of as
    many slots; switch off: no marker and no ring. The switch is read at
    the capture."""
    k = 2
    t = _trainer(steps_per_call=k)
    chunk = t._get_train_chunk(k)
    chunk(0)  # fills the buffers (on the CPU: eager steps)
    profiling.set_device_spans(on)
    chunk._warm_and_capture(k)
    profiling.set_device_spans(not on)  # after the capture: no effect on this chunk
    assert chunk.nodes == 1000
    per_step = ["+step", *_microbatch(), "+optimizer", "-optimizer", "-step"]
    if not on:
        assert fake_capture == [] and chunk.spans is None
        return
    assert [("+" if b else "-") + s for s, b, _ in fake_capture] == per_step * k
    assert [slot for *_, slot in fake_capture] == list(range(len(per_step) * k))
    assert chunk.spans.ring.numel() == len(per_step) * k
    assert [b.nodes for b in chunk.spans.boundaries] == [3 * i for i in range(len(per_step) * k)]


def test_device_span_ms_from_the_ring():
    """Per span, the stamps' differences summed over the chunk over its
    steps (ns to ms), and the nodes between each pair of markers less the
    markers among them; None before a replay with markers."""
    B = profiling.Boundary
    boundaries = [
        # step 1: step [0, 10 ms], encoder [1, 4 ms] with attention [2, 3 ms]
        B("step", True, 0), B("encoder", True, 5), B("attention", True, 9), B("attention", False, 20),
        B("encoder", False, 31), B("step", False, 40),
        # step 2: step [20, 32 ms], encoder [21, 28 ms], attention [22, 25 ms]
        B("step", True, 41), B("encoder", True, 46), B("attention", True, 50), B("attention", False, 61),
        B("encoder", False, 72), B("step", False, 81),
    ]
    ms = [0, 1, 2, 3, 4, 10, 20, 21, 22, 25, 28, 32]
    rec = profiling.SpanRecorder(torch.tensor([int(v * 1e6) for v in ms], dtype=torch.int64))
    rec.boundaries = boundaries
    trainer = SimpleNamespace(_last_replay=None)
    assert profiling.device_span_ms(trainer) is None
    trainer._last_replay = SimpleNamespace(spans=rec, length=2)
    got = profiling.device_span_ms(trainer)
    assert got.ms == pytest.approx({"step": (10 + 12) / 2, "encoder": (3 + 7) / 2, "attention": (1 + 3) / 2})
    # step: 40 - 0 - 5 markers, 81 - 41 - 5; encoder: 31 - 5 - 3 (two of them markers)
    assert got.nodes == pytest.approx({"step": (35 + 35) / 2, "encoder": (23 + 23) / 2, "attention": (10 + 10) / 2})


def test_host_spans_of_train():
    """``vtt.train`` holds the loop, ``vtt.chunk.draws`` each chunk's
    inputs, ``vtt.train.flush`` each read of the rows and
    ``vtt.train.callback`` each step's callback (a replay's span,
    ``vtt.chunk.replay``, needs a CUDA device)."""
    t = _trainer(steps_per_call=3)
    seen = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.train(lambda step, elbo: seen.append(step), update_interval=3)
    counts = {}
    for e in prof.events():
        if e.name.startswith("vtt."):
            counts[e.name] = counts.get(e.name, 0) + 1
    assert seen == list(range(6))
    assert counts["vtt.train"] == 1 and counts["vtt.chunk.draws"] == 2
    assert counts["vtt.train.callback"] == 6 and counts["vtt.train.flush"] >= 2


def test_trace_holds_its_block_in_a_host_span(tmp_path):
    """``trace`` wraps its block in host span ``vtt.trace``, so a gap of the
    device before the block's first launch has a program span's name."""
    with profiling.trace(str(tmp_path)):
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    events = json.loads(next(tmp_path.glob("trace_*.json")).read_text())["traceEvents"]
    outer = next(e for e in events if e.get("name") == "vtt.trace")
    mm = next(e for e in events if e.get("name") == "aten::mm")
    assert outer["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"]


def test_marker_source_holds_every_span():
    """``csrc/spans.cu`` instantiates a begin and an end marker for each
    span of ``DEVICE_SPANS`` and its entry points are the library's."""
    text = (Path(profiling.__file__).resolve().parents[1] / "csrc" / "spans.cu").read_text()
    assert int(re.search(r"constexpr int kSpans = (\d+);", text).group(1)) == len(profiling.DEVICE_SPANS)
    assert set(re.findall(r'extern "C" int (\w+)\(', text)) == set(SPANS.signatures)
