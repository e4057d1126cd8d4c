"""The Lotka-Volterra rung at its committed recipe with the training step in
fp32: ``examples_torch/quality_eval.py``'s ``run_lv`` with
``TrainingConfig(compute_dtype="float32")`` and nothing else changed. A
diagnostic of the rung's miss in bf16 (ROADMAP queue 3). Writes
``examples_torch/results/lv_fp32/results_lv.json``.

    python3 tools/lv_fp32.py [--iters N (default 30000)] [--out DIR]
        [--ckpt-every N] [--ckpt-dir DIR] [--resume PATH]

Runs on the port's default device, CUDA; about 17 minutes at 30,000 steps on
one H100 (``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import viforsdes_tpu_torch as vtt  # noqa: E402
from examples_torch import quality_eval as qe  # noqa: E402

OUT_DIR = qe.RESULTS_DIR / "lv_fp32"


def in_fp32(infer):
    """``infer`` with the config's training step in fp32."""

    def wrapped(**kw):
        c = kw["config"]
        training = c.training.model_copy(update={"compute_dtype": vtt.ComputeDtype.FLOAT32})
        return infer(**{**kw, "config": dataclasses.replace(c, training=training)})

    return wrapped


def run_lv_fp32(n_iterations: int, opts: qe.RunOptions) -> dict:
    real = vtt.infer
    vtt.infer = in_fp32(real)
    try:
        return qe.run_lv(n_iterations, opts)
    finally:
        vtt.infer = real


def main(argv: list[str]) -> None:
    opts = qe.options_from_argv(argv)
    if "--out" not in argv:
        opts.out_dir = OUT_DIR
    if "--ckpt-dir" not in argv:
        opts.checkpoint_dir = qe.CHECKPOINT_DIR / "lv_fp32"
    run_lv_fp32(qe._flag(argv, "--iters", int, 30000), opts)


if __name__ == "__main__":
    main(sys.argv)
