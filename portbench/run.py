"""The benchmark of ``viforsdes_tpu_torch``, the PyTorch and CUDA port.

    python portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``. One run:

1. set-up: the cell's trainer (the program's ``VariationalInferenceTrainer``)
   built, the benchmark's weights from ``--seed`` copied into it, and its
   ``train()`` run for one chunk of ``steps_per_call`` steps (eager, then
   captured as a CUDA graph), the state set back to the weights, and one
   replay of the captured chunk; the first steps of both passes, and the
   state after each pass's chunk, are kept for the check;
2. the window: ``train()`` over whole chunks for about ``--seconds``, ended
   by a synchronize. ``step_ms`` is its wall time over its steps;
   ``peak_mem_gib`` the allocator's peak reservation over the run;
   ``setup_s`` the time from the process's start to the window's;
3. with ``--trace 1``, after that window, ``trace_chunks`` more chunks under
   the profiler; the per-layer metrics are read from that trace
   (``metrics/<name>.py``) and reported instead of the end-to-end ones;
4. the check: the replay's state held to the eager chunk's; the program
   freed, the plain reference (``reference/``) takes the same first steps
   from the same weights and draws on the card; ``correct`` holds when
   every number is within the cell's limit.

The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error and the ``checks`` key, last in it.
The run refuses without a CUDA device, with fewer than the cell's cards,
and when ``jax``, ``jaxlib``, ``flax`` or ``viforsdes_tpu`` is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import check, problem, spec, work  # noqa: E402
from portbench.harness.program import Program  # noqa: E402
from portbench.harness.trace import WINDOW, Trace, read_chrome_trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "viforsdes_tpu")
MIN_CHUNKS = 2


class Refused(Exception):
    """The run cannot measure: no result is printed."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Outcome:
    """What one run measured and read."""

    numbers: dict[str, float]
    finite: bool
    attempted: int
    failed: int
    setup_s: float
    step_ms: float
    chunk_s: float
    peak_bytes: int
    pool_gib: float | None
    reference_s: float
    trace: Trace | None = None
    info: dict = field(default_factory=dict)


def run_cell(cell: spec.Cell, seed: int, seconds: float | None, traced: bool, device: str,
             t_start: float = T_START, plant=None, reference: bool = True) -> Outcome:
    """One run of ``cell`` on ``device``. ``plant(program)``, where given,
    breaks the program before its first step (the checks' faults); without
    ``reference`` the numbers compared are only ``replay_gap``
    (``Outcome.info["mine"]`` keeps the program's readings)."""
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    sde = problem.make_sde(cfg)
    times, values = problem.observations(cfg)
    shapes = problem.shapes(cfg, values.shape[-1], sde)
    k = int(traffic["steps_per_call"])
    n = int(traffic["check_steps"])

    prog = Program(cfg, traffic, sde, times, values, seed, device)
    w0 = problem.make_weights(cfg, shapes, seed, dev)
    prog.load(w0)
    if plant is not None:
        plant(prog)
    seen = prog.observe(tuple(sorted({1, n, k})))
    prog.train_to(k)  # the first chunk: eager on a side stream, then captured
    warm_losses = [-e for e in prog.trainer.evidence_lower_bound_history[:n]]
    prog.load(w0)
    sync(dev)
    t = time.perf_counter()
    prog.train_to(k)  # the same steps again, as a replay of the graph
    sync(dev)
    chunk_s = time.perf_counter() - t
    replay_rows = prog.chunk().metrics[:n].detach().cpu()
    mine = check.program_readings(prog, w0, warm_losses, replay_rows, seen, n)
    replay = check.replay_gap({g: prog.unpack(v) for g, v in seen[k].items()},
                              {g: prog.unpack(v) for g, v in prog.snapshot().items()}, w0)
    del seen

    # the window; None: none (the checks' readings need only the set-up)
    chunks = 0 if seconds is None else max(MIN_CHUNKS, round(seconds / max(chunk_s, 1e-9)))
    start = prog.completed
    sync(dev)
    t_w0 = time.perf_counter()
    prog.train_to(start + chunks * k)
    sync(dev)
    t_w1 = time.perf_counter()
    window = prog.trainer.evidence_lower_bound_history[start:]
    attempted = len(window)
    failed = sum(not math.isfinite(e) for e in window)

    trace = None
    if traced:
        trace = trace_chunks(prog, dev, int(traffic["trace_chunks"]) * k)
    peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    chunk = prog.chunk()
    pool = work.graph_pool_gib(torch, chunk.graph) if chunk is not None and chunk.graph is not None else None
    finite = failed == 0 and int(prog.trainer.opt_state["total_notfinite"]) == 0

    del prog, chunk
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = {}
    if reference:
        pb = problem.problem(cfg, traffic, dev)
        numbers = check.compare(mine, check.reference_readings(pb, w0, seed, n))
        sync(dev)
    numbers["replay_gap"] = replay
    reference_s = time.perf_counter() - t_ref
    return Outcome(
        numbers=numbers,
        finite=finite,
        attempted=attempted,
        failed=failed,
        setup_s=t_w0 - t_start,
        step_ms=(t_w1 - t_w0) * 1e3 / max(attempted, 1),
        chunk_s=chunk_s,
        peak_bytes=int(peak),
        pool_gib=pool,
        reference_s=reference_s,
        trace=trace,
        info={"chunks": chunks, "shapes": shapes, "mine": mine, "w0": w0},
    )


def trace_chunks(prog: Program, dev: torch.device, steps: int) -> Trace:
    """``steps`` more steps of ``train()`` under the profiler, in one span
    ``WINDOW`` that ends after a synchronize; the trace is written under
    ``TMPDIR``, read, and deleted."""
    from torch.profiler import record_function

    from viforsdes_tpu_torch.utils.profiling import trace

    target = prog.completed + steps
    out = Path(tempfile.mkdtemp(prefix="portbench_trace_"))
    try:
        sync(dev)
        with trace(str(out)):
            with record_function(WINDOW):
                prog.train_to(target)
                sync(dev)
        files = sorted(out.glob("*.json"))
        if len(files) != 1:
            raise RuntimeError(f"expected one trace file, found {len(files)}")
        return read_chrome_trace(files[0], steps)
    finally:
        shutil.rmtree(out, ignore_errors=True)


@dataclass
class LayerRun:
    """What a per-layer metric's ``read(run)`` sees."""

    trace: Trace
    step_ms: float
    config: dict
    traffic: dict
    shapes: object
    work = work


def result(cell: spec.Cell, out: Outcome, traced: bool, kind: str) -> dict:
    """The result line's object; ``kind`` is the card's name."""
    limits = {k: float(v) for k, v in cell.traffic["limits"].items()}
    correct = out.finite and out.attempted > 0 and check.verdict(out.numbers, limits)
    device = {
        "platform": "gpu",
        "kind": kind,
        "count": cell.chips,
        "memory_peak_bytes": out.peak_bytes,
    }
    res: dict = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed}
    if traced:
        run = LayerRun(out.trace, out.step_ms, cell.config, cell.traffic, out.info["shapes"])
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_module(m).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        res["metrics"] = metrics
        res["device"] = device
        res["breakdown"] = out.trace.breakdown()
    else:
        values = {"step_ms": out.step_ms, "peak_mem_gib": out.peak_bytes / 2**30, "setup_s": out.setup_s}
        res["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        res["device"] = device
    res["checks"] = {k: {"value": out.numbers[k], "limit": limits[k]} for k in limits}
    return res


def parse(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload)
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark measures on the card only")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"the cell needs {cell.chips} cards, {torch.cuda.device_count()} present")
        torch.cuda.set_device(0)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
        found = forbidden_modules()
        if found:
            raise Refused(f"modules of the JAX package or of JAX are loaded: {', '.join(found)}")
    except (Refused, FileNotFoundError, KeyError, ImportError) as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    res = result(cell, out, bool(args.trace), torch.cuda.get_device_name(0))
    info = (f"portbench: {cell.name} seed {args.seed}: {out.attempted} steps in {out.info['chunks']} chunks, "
            f"step {out.step_ms:.4f} ms, chunk at set-up {out.chunk_s:.4f} s, set-up {out.setup_s:.3f} s, "
            f"peak {out.peak_bytes / 2**30:.4f} GiB, graph pool {out.pool_gib} GiB, "
            f"reference {out.reference_s:.3f} s, card {res['device']['kind']}")
    print(info, file=sys.stderr)
    print(f"portbench: correct {res['correct']} (finite steps {out.finite})", file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
