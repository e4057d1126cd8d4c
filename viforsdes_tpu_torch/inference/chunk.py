"""Several optimizer steps per dispatch (``TrainingConfig.steps_per_call``).

The counterpart of the JAX trainer's ``_get_train_chunk``, which scans K steps
in one jitted call. Here ``TrainChunk`` holds static buffers for the inputs
and outputs of K steps and runs K x ``_step_math`` on the trainer's flat
params, AdamW state and EMA, updated in place:

- before each call the host fills the inputs: each step's draws come from
  ``trainer.draws(step)`` and are copied into the buffers, and the steps'
  theta scales and claimed observation variances arrive in one copy from
  pinned memory. Nothing random runs inside the steps, so a chunk takes the
  numbers of the per-step path by construction;
- on a CUDA device the first call runs its K steps eagerly on a side stream.
  They are real training steps, and they do what capture cannot: load the
  kernel libraries, fill the cached plans and index tables, create the
  cuBLAS handles and set the kernels' shared-memory attributes. Then the K
  steps are captured as one CUDA graph on that stream, with Python's garbage
  collector run just before and off during the capture, and every later call
  replays it. A failed capture or replay raises; nothing retries eagerly;
- on the CPU every call runs its K steps eagerly from the same buffers;
- under a data mesh (``parallel/mesh.py``) each step's all-reduces are part
  of the K steps. On NCCL they are captured inside the graph: the eager
  warm chunk runs them first, which creates the communicator before the
  capture, and the capture is made in the thread-local mode, so NCCL's
  watchdog thread may query its events meanwhile. A capture that fails with
  them inside raises like any other. gloo copies CUDA tensors through the
  host, which no graph holds, so the trainer refuses ``steps_per_call > 1``
  on a gloo mesh on a CUDA device (auto picks 1 there).

A graph holds the addresses of the buffers it was captured on, so the trainer
updates its state in place (``restore_checkpoint``, ``set_theta_mean``), and
a replay after the buffers were replaced raises.

Device spans (``utils/profiling.py``): the eager warm steps count the span
boundaries of K steps on the host, and the capture, unless
``profiling.set_device_spans(False)`` turned them off, launches a marker
kernel at each, into its slot of the chunk's ring (``spans``), so the graph
holds them and every replay stamps the ring; the nodes captured in all are
``nodes``. The host's own spans: ``vtt.chunk.draws`` (the draws and copies
before a call) and ``vtt.chunk.replay``.
"""

from __future__ import annotations

import contextlib
import gc
from typing import TYPE_CHECKING

import torch
from torch import Tensor
from torch.profiler import record_function

from viforsdes_tpu_torch.utils import profiling

if TYPE_CHECKING:
    from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer


class TrainChunk:
    """K optimizer steps per call; ``chunk(first_step)`` runs steps
    ``first_step .. first_step + K - 1`` and returns their metrics rows
    ``[K, 8 + P]`` (``pack_metrics``) in a buffer the next call overwrites."""

    def __init__(self, trainer: VariationalInferenceTrainer, length: int) -> None:
        if length < 1:
            raise ValueError(f"a chunk takes at least one step, got {length}")
        self.trainer = trainer
        self.length = length
        dev = trainer.device
        # row 0: theta scale per step, row 1: claimed observation variance
        self.schedule = torch.empty((2, length), dtype=torch.float32, device=dev)
        self.draws: list[list[tuple[Tensor, Tensor]]] | None = None
        self.metrics: Tensor | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self._captured_on: tuple[int, ...] | None = None
        self.spans: profiling.SpanRecorder | None = None  # the captured markers and their ring
        self.nodes: int | None = None  # the graph's nodes, markers included

    def __call__(self, first_step: int) -> Tensor:
        t = self.trainer
        steps = range(first_step, first_step + self.length)
        with record_function("vtt.chunk.draws"):
            draws = [t.draws(step) for step in steps]
            if self.draws is None:
                self.draws = [[(torch.empty_like(e), torch.empty_like(n)) for e, n in d] for d in draws]
            for bufs, step_draws in zip(self.draws, draws):
                for (e_buf, n_buf), (e, n) in zip(bufs, step_draws):
                    e_buf.copy_(e)
                    n_buf.copy_(n)
            t._upload(t._step_schedule(first_step, self.length), out=self.schedule)
        if self.graph is not None:
            with record_function("vtt.chunk.replay"):
                self._replay(first_step)
        elif t.device.type == "cuda":
            self._warm_and_capture(first_step)
        else:
            self._run()
        t.step = steps[-1]
        t._completed_steps = steps[-1] + 1
        return self.metrics

    def _run(self) -> None:
        """K x ``_step_math`` from the buffers; each step's metrics row into
        ``self.metrics``."""
        t = self.trainer
        warmup = t.config.theta_warmup_steps > 0
        anneal = t.config.obs_variance_final is not None
        for i, draws in enumerate(self.draws):
            *_, metrics = t._step_math(
                t.flat_params, t.opt_state, t.flat_ema, draws,
                self.schedule[0, i] if warmup else None,
                obs_variance=self.schedule[1, i] if anneal else None,
            )
            row = pack_metrics(metrics)
            if self.metrics is None:
                self.metrics = torch.empty((self.length, row.numel()), dtype=row.dtype, device=row.device)
            self.metrics[i].copy_(row)

    def _warm_and_capture(self, first_step: int) -> None:
        dev = self.trainer.device
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        spans = profiling.device_spans_enabled()
        with torch.cuda.stream(side):
            # with spans on, the warm steps count the boundaries the capture marks
            with profiling.recording_spans() if spans else contextlib.nullcontext() as warm:
                self._run()
            ring = torch.zeros(len(warm.boundaries), dtype=torch.int64, device=dev) if spans else None
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        mode = "global" if self.trainer.mesh is None else "thread_local"
        # Python's collector must not run inside the capture: collecting an
        # earlier trainer's dead cycle (trainer <-> chunk) there destroys its
        # CUDA graph, which invalidates the capture. torch.cuda.graph does not
        # collect first by default, so the dead are collected here and the
        # collector is off until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode=mode):
                with profiling.marking_spans(ring) if spans else contextlib.nullcontext() as marked:
                    self._run()
                nodes = profiling.captured_nodes(side)
        except RuntimeError as err:
            raise RuntimeError(
                f"capturing the {self.length}-step training chunk that starts at step "
                f"{first_step} as a CUDA graph failed: {err}"
            ) from err
        finally:
            if collecting:
                gc.enable()
        if spans and [b[:2] for b in marked.boundaries] != [b[:2] for b in warm.boundaries]:
            raise RuntimeError(
                f"the {self.length}-step training chunk at step {first_step}: the capture marked other "
                "span boundaries than its warm steps"
            )
        self.graph = graph
        self.spans = marked
        self.nodes = nodes
        self._captured_on = self._state_pointers()

    def _replay(self, first_step: int) -> None:
        if self._state_pointers() != self._captured_on:
            raise RuntimeError(
                f"the {self.length}-step training chunk at step {first_step}: the trainer's "
                "params, AdamW state or EMA buffers were replaced after the chunk was "
                "captured; update them in place"
            )
        try:
            self.graph.replay()
            self.trainer._last_replay = self
        except RuntimeError as err:
            raise RuntimeError(
                f"replaying the {self.length}-step training chunk that starts at step "
                f"{first_step} failed: {err}"
            ) from err

    def _state_pointers(self) -> tuple[int, ...]:
        return tuple(x.data_ptr() for x in self.trainer.state_tensors())


def pack_metrics(metrics) -> Tensor:
    """One step's ``StepMetrics`` as a flat fp32 row: the ELBO, its five
    components and the gradient norm, the non-finite count, the theta
    means."""
    return torch.cat([
        torch.stack([v.float() for v in metrics[:7]]),
        metrics.notfinite_count.float()[None],
        metrics.param_means.float(),
    ])
