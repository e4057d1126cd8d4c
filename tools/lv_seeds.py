"""The Lotka-Volterra rung at its committed recipe under other seeds and arms:
``examples_torch/quality_eval.py``'s ``run_lv`` with ``InferenceConfig.seed``
set and, per arm, the training step's dtype (a wrapper of ``vtt.infer``; no
switch in the package). A diagnostic of the rung's miss in bf16 (ROADMAP
queue 3).

    python3 tools/lv_seeds.py ARM:SEED [ARM:SEED ...] [--iters N (30000)] [--out DIR]
    python3 tools/lv_seeds.py table [--out DIR]

ARM is one of ``ARMS`` (``bf16``: the recipe; ``fp32``: the recipe with
``compute_dtype`` fp32). Each run writes
``<out>/<arm>_seed<k>/results_lv.json`` (the rung's result; ``_<N>`` after the
directory's name for a run of other than 30,000 steps) and ``elbo.json``
(the ELBO history as means of blocks of 100 steps, and its value at every
100th step). Several runs start as concurrent processes on the one card,
each logging to ``log.txt`` in its directory; their wall times are then not
timings. ``table`` gives each run's verdict against
``benchmarks/results_lv.json`` (``tools/ladder_parity.py``'s rule) and, for
each seed with both a ``bf16`` and an ``fp32`` run, N*: the first step after
which bf16's mean-of-200 ELBO stays more than 100 nats under fp32's (runs of
30,000 steps). It writes ``<out>/table.json`` and ``<out>/table.md``. Runs on the port's
default device, CUDA; ``table`` reads the runs' JSON files only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT_DIR = REPO / "examples_torch" / "results" / "lv_seeds"
JAX_RESULT = REPO / "benchmarks" / "results_lv.json"
EVERY = 100  # steps a block of the ELBO curve
GAP = 100.0  # nats: bf16's mean-of-200 ELBO under fp32's by more than this
DEFAULT_ITERS = 30000


def in_fp32(infer):
    """``infer`` with the config's training step in fp32."""

    def wrapped(**kw):
        import viforsdes_tpu_torch as vtt

        c = kw["config"]
        training = c.training.model_copy(update={"compute_dtype": vtt.ComputeDtype.FLOAT32})
        return infer(**{**kw, "config": dataclasses.replace(c, training=training)})

    return wrapped


# arm -> a context manager around the run: ``bf16`` is the recipe itself,
# ``fp32`` the whole step in fp32
ARMS: dict = {
    "bf16": contextlib.nullcontext,
    "fp32": lambda: _patch_infer(in_fp32),
}


@contextlib.contextmanager
def _patch_infer(wrap):
    import viforsdes_tpu_torch as vtt

    real = vtt.infer
    vtt.infer = wrap(real)
    try:
        yield
    finally:
        vtt.infer = real


def _seeded(seed: int):
    def wrap(infer):
        def wrapped(**kw):
            return infer(**{**kw, "config": dataclasses.replace(kw["config"], seed=seed)})

        return wrapped

    return wrap


def run_dir(out: Path, arm: str, seed: int, iters: int = DEFAULT_ITERS) -> Path:
    """``<arm>_seed<k>``, with ``_<iters>`` after it for a run of other than
    the recipe's iterations."""
    return Path(out) / (f"{arm}_seed{seed}" + ("" if iters == DEFAULT_ITERS else f"_{iters}"))


RUN_NAME = re.compile(r"(?P<arm>.+)_seed(?P<seed>\d+)(_(?P<iters>\d+))?")


def curve(history: list[float], every: int = EVERY) -> dict:
    """The ELBO history decimated: the mean of each block of ``every`` steps
    and the value at each block's last step."""
    n = len(history) // every * every
    blocks = [history[i:i + every] for i in range(0, n, every)]
    return {
        "every": every,
        "n_steps": len(history),
        "block_mean": [sum(b) / every for b in blocks],
        "value_at": [b[-1] for b in blocks],
    }


def mean200(block_mean: list[float]) -> list[float]:
    """Mean of the last 200 steps at the end of each block of 100 from the
    second on (the harness's ``elbo_final_mean200`` at that step)."""
    return [(a + b) / 2 for a, b in zip(block_mean, block_mean[1:])]


def n_star(bf16: dict, fp32: dict, gap: float = GAP) -> int | None:
    """The first step after which bf16's mean-of-200 ELBO stays more than
    ``gap`` nats under fp32's, or None where it ends within ``gap``."""
    assert bf16["every"] == fp32["every"] == EVERY
    a, b = mean200(bf16["block_mean"]), mean200(fp32["block_mean"])
    first = None
    for i, (x, y) in enumerate(zip(a, b)):
        if y - x > gap:
            first = (i + 2) * bf16["every"] if first is None else first
        else:
            first = None
    return first


def run(arm: str, seed: int, iters: int, out: Path) -> dict:
    from examples_torch import quality_eval as qe

    captured = {}

    def keep(infer):
        def wrapped(**kw):
            captured["posterior"] = infer(**kw)
            return captured["posterior"]

        return wrapped

    d = run_dir(out, arm, seed, iters)
    d.mkdir(parents=True, exist_ok=True)
    opts = qe.RunOptions(out_dir=d)
    with _patch_infer(keep), ARMS[arm](), _patch_infer(_seeded(seed)):
        result = qe.run_lv(iters, opts)
    history = [float(x) for x in captured["posterior"].evidence_lower_bound_history]
    elbo = {"arm": arm, "seed": seed, "card": result["port"]["card"], **curve(history)}
    (d / "elbo.json").write_text(json.dumps(elbo))
    return result


def table(out: Path) -> dict:
    from tools.ladder_parity import compare

    jax = json.loads(JAX_RESULT.read_text())
    runs, curves = {}, {}
    for d in sorted(Path(out).glob("*_seed*")):
        res = d / "results_lv.json"
        if not res.exists():
            continue
        name = RUN_NAME.fullmatch(d.name)
        arm, seed = name["arm"], int(name["seed"])
        r = json.loads(res.read_text())
        v = compare(r, jax)
        runs[d.name] = {
            "arm": arm, "seed": seed, "agrees": v["agrees"],
            "n_iterations": r["n_iterations"], "card": v["card"],
            "elbo_final_mean200": r["elbo_final_mean200"],
            "params": {k: {"port": p["port"], "joint_sigma": abs(p["diff"]) / (p["bar"] / 2)}
                       for k, p in v["params"].items()},
        }
        if (d / "elbo.json").exists() and name["iters"] is None:
            curves[(arm, seed)] = json.loads((d / "elbo.json").read_text())
    stars = {str(s): n_star(curves[("bf16", s)], curves[("fp32", s)])
             for (arm, s) in curves if arm == "bf16" and ("fp32", s) in curves}
    t = {"jax": {k: [jax["posterior_mean"][k], jax["posterior_std"][k]] for k in jax["posterior_mean"]},
         "jax_elbo_final_mean200": jax["elbo_final_mean200"], "runs": runs, "n_star": stars}
    Path(out, "table.json").write_text(json.dumps(t, indent=2))
    Path(out, "table.md").write_text(table_md(t))
    return t


def table_md(t: dict) -> str:
    names = list(t["jax"])
    head = ("| run | steps | " + " | ".join(f"{k} (joint σ)" for k in names)
            + " | ELBO mean-200 | agrees |")
    rows = [head, "|" + "---|" * (len(names) + 4)]
    for name, r in t["runs"].items():
        cells = [f"{r['params'][k]['port'][0]:.6g} ± {r['params'][k]['port'][1]:.3g} "
                 f"({r['params'][k]['joint_sigma']:.2f})" for k in names]
        rows.append(f"| {name} | {r['n_iterations']} | " + " | ".join(cells)
                    + f" | {r['elbo_final_mean200']:.1f} | {'yes' if r['agrees'] else 'no'} |")
    jax = " | ".join(f"{m:.6g} ± {s:.3g}" for m, s in t["jax"].values())
    rows.append(f"| JAX (`benchmarks/results_lv.json`) | 30000 | {jax} | "
                f"{t['jax_elbo_final_mean200']:.1f} | |")
    cards = sorted({r["card"] for r in t["runs"].values() if r["card"]})
    rows += ["", f"Card: {', '.join(cards) or 'not recorded'}.",
             "N* (first step after which bf16's mean-of-200 ELBO stays more than "
             f"{GAP:g} nats under fp32's): "
             + (", ".join(f"seed {s}: {n}" for s, n in t["n_star"].items()) or "no pair")]
    return "\n".join(rows) + "\n"


def _spec(s: str) -> tuple[str, int]:
    arm, _, seed = s.partition(":")
    if arm not in ARMS:
        raise SystemExit(f"unknown arm {arm!r}; arms: {', '.join(ARMS)}")
    return arm, int(seed or 0)


def main(argv: list[str]) -> int:
    out = Path(argv[argv.index("--out") + 1]) if "--out" in argv else OUT_DIR
    iters = int(argv[argv.index("--iters") + 1]) if "--iters" in argv else DEFAULT_ITERS
    flags = {"--out", "--iters"}
    args = [a for i, a in enumerate(argv[1:], 1) if a not in flags and argv[i - 1] not in flags]
    if args == ["table"]:
        print(table_md(table(out)))
        return 0
    specs = [_spec(a) for a in args]
    if len(specs) == 1:
        run(*specs[0], iters, out)
        return 0
    procs = []
    for arm, seed in specs:
        d = run_dir(out, arm, seed, iters)
        d.mkdir(parents=True, exist_ok=True)
        log = open(d / "log.txt", "w")
        cmd = [sys.executable, __file__, f"{arm}:{seed}", "--iters", str(iters), "--out", str(out)]
        procs.append((f"{arm}:{seed}", subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))
    rc = 0
    for name, p, log in procs:
        code = p.wait()
        log.close()
        print(f"{name}: exit {code}", flush=True)
        rc = rc or code
    print(table_md(table(out)))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
