"""The port's quality ladder beside the JAX package's committed results.

    python3 tools/ladder_parity.py [--port DIR] [--json PATH]

For each rung of the ladder and each of its parameters, prints the port's
posterior mean ± std (``examples_torch/results/results_<rung>.json``, or
``--port DIR``) beside the JAX package's (``benchmarks/results_<rung>.json``)
and marks the parameter as agreeing when the two means lie within two joint
standard deviations, |m_port - m_jax| <= 2 sqrt(s_port^2 + s_jax^2). A rung
agrees when every parameter does and the port ran the committed iterations.
Where the rung has a ground truth, it also prints the JAX harness's own test
for each package: the mean within 2 sigma of the truth. ``--json`` writes
the verdicts. Reads JSON only: neither package is imported.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = REPO / "examples_torch" / "results"
JAX_DIR = REPO / "benchmarks"

# the rungs, cheapest first, by the name of their results file
RUNGS = ("ou_synthetic", "sir", "lv", "highdim_r5_noisy", "lorenz")


def agrees(m_port: float, s_port: float, m_jax: float, s_jax: float) -> bool:
    """The two posteriors' means within two joint standard deviations."""
    return abs(m_port - m_jax) <= 2.0 * math.sqrt(s_port**2 + s_jax**2)


def within_truth(mean: float, std: float, truth: float) -> bool:
    """The JAX harness's test (``quality_eval.py`` ``within_2sigma``)."""
    return abs(mean - truth) <= 2.0 * std


def compare(port: dict, jax: dict) -> dict:
    """Per-parameter comparison of one rung's two results."""
    truth = jax.get("true_params")
    params = {}
    for k, m_jax in jax["posterior_mean"].items():
        m_port, s_port = port["posterior_mean"][k], port["posterior_std"][k]
        s_jax = jax["posterior_std"][k]
        row = {
            "port": [m_port, s_port],
            "jax": [m_jax, s_jax],
            "diff": m_port - m_jax,
            "bar": 2.0 * math.sqrt(s_port**2 + s_jax**2),
            "agrees": agrees(m_port, s_port, m_jax, s_jax),
        }
        if truth is not None:
            row["truth"] = truth[k]
            row["port_within_2sigma_of_truth"] = within_truth(m_port, s_port, truth[k])
            row["jax_within_2sigma_of_truth"] = within_truth(m_jax, s_jax, truth[k])
        params[k] = row
    full = port["n_iterations"] >= jax["n_iterations"]
    return {
        "n_iterations": {"port": port["n_iterations"], "jax": jax["n_iterations"]},
        "full_length": full,
        "params": params,
        "agrees": full and all(r["agrees"] for r in params.values()),
        "card": port.get("port", {}).get("card"),
    }


def ladder(port_dir: Path = PORT_DIR, jax_dir: Path = JAX_DIR, rungs=RUNGS) -> dict:
    """Every rung's comparison; a rung the port has no result for is None."""
    out = {}
    for name in rungs:
        port_file = Path(port_dir) / f"results_{name}.json"
        jax = json.loads((Path(jax_dir) / f"results_{name}.json").read_text())
        out[name] = compare(json.loads(port_file.read_text()), jax) if port_file.exists() else None
    return out


def report(verdicts: dict) -> str:
    lines = []
    for name, v in verdicts.items():
        if v is None:
            lines.append(f"{name}: no port result")
            continue
        n = v["n_iterations"]
        length = "" if v["full_length"] else f" (port stopped at {n['port']} of {n['jax']} steps: not a pass)"
        lines.append(f"{name}: {'AGREES' if v['agrees'] else 'MISSES'}{length}; card {v['card']}")
        for k, r in v["params"].items():
            (mp, sp), (mj, sj) = r["port"], r["jax"]
            line = (f"  {k:>8}: port {mp:.6g} ± {sp:.3g}  jax {mj:.6g} ± {sj:.3g}  "
                    f"|diff| {abs(r['diff']):.3g} vs 2σ {r['bar']:.3g}: {'ok' if r['agrees'] else 'MISS'}")
            if "truth" in r:
                line += (f"; truth {r['truth']:.6g}: port {'within' if r['port_within_2sigma_of_truth'] else 'OUT'},"
                         f" jax {'within' if r['jax_within_2sigma_of_truth'] else 'OUT'}")
            lines.append(line)
    return "\n".join(lines)


def main(argv: list[str]) -> int:
    port_dir = Path(argv[argv.index("--port") + 1]) if "--port" in argv else PORT_DIR
    verdicts = ladder(port_dir)
    print(report(verdicts))
    if "--json" in argv:
        Path(argv[argv.index("--json") + 1]).write_text(json.dumps(verdicts, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
