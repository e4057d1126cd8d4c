"""The readings that a cell's limits are set from, in one process on the card.

    python portbench/calibrate.py --workload CELL --seeds 1,2,... \
        [--control-seeds 1,2,3] [--replay-seeds 1,2,...] [--out FILE]

On the card only, as ``run.py``. For each seed of ``--seeds``: the program's
set-up as ``run.py`` makes it (no window), and the numbers of
``harness/check.py`` against the float32 reference: the lower readings. For
each seed of ``--replay-seeds``: the set-up alone and its ``replay_gap``,
the one number that needs no reference. For each seed of
``--control-seeds``, also against that reference: the control (the reference in the
precision below the cell's, ``traffic["control"]``: ``fp8`` or ``tf32``) and
the fault of half the batch left out (the reference on half of the
importance groups, the mean taken over them): the upper readings. A state
left unchanged reads 1 on every leaf number by construction and needs no
run. One JSON line per reading on standard output, and in ``--out``, with
each side's readings leaf by leaf (``check.Readings``), so a number can be
worked out again.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import asdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.harness import check, problem, spec  # noqa: E402
from portbench.reference.precision import Precision  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--replay-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device: the limits come from the card only", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    replays = [int(s) for s in args.replay_seeds.split(",") if s]
    n = int(cell.traffic["check_steps"])
    out = open(args.out, "a") if args.out else None

    def emit(record: dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    dev = torch.device("cuda")
    for seed in replays:
        t0 = time.perf_counter()
        res = run.run_cell(cell, seed, None, False, "cuda", reference=False)
        emit({"cell": cell.name, "seed": seed, "side": "program", "numbers": res.numbers,
              "setup_s": time.perf_counter() - t0})
        del res
        torch.cuda.empty_cache()
    for seed in [*seeds, *sorted(controls - set(seeds))]:
        t0 = time.perf_counter()
        res = run.run_cell(cell, seed, None, False, "cuda", reference=False)
        w0 = res.info["w0"]
        pb = problem.problem(cell.config, cell.traffic, dev)
        t1 = time.perf_counter()
        ref = check.reference_readings(pb, w0, seed, n)
        t2 = time.perf_counter()
        emit({"cell": cell.name, "seed": seed, "side": "reference", "readings": asdict(ref)})
        if seed in seeds:
            emit({"cell": cell.name, "seed": seed, "side": "program",
                  "numbers": {**check.compare(res.info["mine"], ref), **res.numbers}, "setup_s": t1 - t0,
                  "reference_s": t2 - t1, "chunk_s": res.chunk_s, "readings": asdict(res.info["mine"])})
        if seed in controls:
            ctl = check.reference_readings(pb, w0, seed, n, Precision(cell.traffic["control"]))
            ctl.losses = ctl.losses * 2  # in the program's place: two passes
            emit({"cell": cell.name, "seed": seed, "side": f"control_{cell.traffic['control']}",
                  "numbers": check.compare(ctl, ref), "readings": asdict(ctl)})
            half = check.reference_readings(pb, w0, seed, n, batch_keep=0.5)
            half.losses = half.losses * 2
            emit({"cell": cell.name, "seed": seed, "side": "fault_half_batch",
                  "numbers": check.compare(half, ref), "readings": asdict(half)})
        del res, w0, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
