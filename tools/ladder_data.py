"""Carry the JAX examples' simulated observations across to the PyTorch port.

    JAX_PLATFORMS=cpu python3 tools/ladder_data.py

The JAX examples and the quality ladder (``benchmarks/quality_eval.py``)
simulate some of their observations with ``jax.random``, whose bits the port
cannot draw. This script runs the JAX package's own code on the CPU and
writes each such dataset to ``examples_torch/data/<name>.json``: the times and
the values, each value the float64 ``repr`` of the float32 the JAX code
holds, so the port reads back exactly the same observations. The ladder's
rungs take theirs from the JAX harness's own functions, their ``infer`` call
intercepted before it trains.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
DATA_DIR = REPO / "examples_torch" / "data"

# name -> (what makes it, in the JAX package's own words)
SOURCES = {
    "ou_synthetic": "benchmarks/quality_eval.py run_ou_synthetic: euler_maruyama of OU theta=(1.5, 1.0, 0.4), "
                    "x0=2.5, jax.random.key(11), dt=0.05, observed every 0.5 (11 observations)",
    "lorenz63_example": "examples/lorenz63.py simulate_observations(jax.random.key(17)): every 0.5",
    "lorenz63_r3": "benchmarks/quality_eval.py run_lorenz(obs_every=0.05): simulate_observations("
                   "jax.random.key(17), obs_every=0.05), the round-3 recipe",
    "highdim_example": "examples/highdim_ou_dp.py simulate_observations(jax.random.key(3)): every 1.0",
    "highdim_r5": "benchmarks/quality_eval.py run_highdim(obs_every=0.25, obs_noise=0.1): "
                  "simulate_observations(jax.random.key(3), obs_every=0.25, noise_std=0.1)",
}


class Captured(Exception):
    """Raised by the intercepted ``infer``: it carries the call's arguments."""

    def __init__(self, kwargs: dict) -> None:
        super().__init__("infer intercepted")
        self.kwargs = kwargs


def jax_harness():
    """``benchmarks/quality_eval.py`` as a module (it puts the repository
    and ``examples/`` on ``sys.path`` and imports ``viforsdes_tpu``)."""
    spec = importlib.util.spec_from_file_location("jax_quality_eval", REPO / "benchmarks" / "quality_eval.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def capture_infer(vt_module, run, *args, **kwargs) -> dict:
    """The keyword arguments that ``run(*args, **kwargs)`` passes to
    ``vt_module.infer``; the call raises instead of training."""

    def intercept(*a, **kw):
        names = ("sde", "observations", "observation_likelihood", "prior", "time_horizon", "config")
        raise Captured({**dict(zip(names, a)), **kw})

    saved = vt_module.infer
    vt_module.infer = intercept
    try:
        run(*args, **kwargs)
    except Captured as c:
        return c.kwargs
    finally:
        vt_module.infer = saved
    raise RuntimeError(f"{run.__name__} did not call infer")


def record(name: str, observations) -> dict:
    times = np.asarray(observations.times, dtype=np.float64)
    values = np.asarray(observations.values)
    if values.dtype != np.float32:
        raise TypeError(f"{name}: values are {values.dtype}, not float32")
    return {
        "name": name,
        "source": SOURCES[name],
        "times": [float(t) for t in times],
        "values": [[float(v) for v in row] for row in values],
    }


def datasets() -> dict[str, dict]:
    """Every dataset, made by the JAX package's code on the current backend."""
    import jax

    import viforsdes_tpu as vt

    harness = jax_harness()  # puts examples/ on sys.path
    from highdim_ou_dp import simulate_observations as highdim_observations
    from lorenz63 import simulate_observations as lorenz_observations

    observations = {
        "ou_synthetic": capture_infer(vt, harness.run_ou_synthetic, 1)["observations"],
        "lorenz63_example": lorenz_observations(jax.random.key(17)),
        "lorenz63_r3": capture_infer(vt, harness.run_lorenz, 1, obs_every=0.05)["observations"],
        "highdim_example": highdim_observations(jax.random.key(3)),
        "highdim_r5": capture_infer(vt, harness.run_highdim, 1, obs_every=0.25, obs_noise=0.1)["observations"],
    }
    return {name: record(name, obs) for name, obs in observations.items()}


def dumps(rec: dict) -> str:
    return json.dumps(rec, indent=1) + "\n"


def main() -> int:
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    for name, rec in datasets().items():
        path = DATA_DIR / f"{name}.json"
        path.write_text(dumps(rec))
        print(f"{path.relative_to(REPO)}: {len(rec['times'])} observations of {len(rec['values'][0])} values")
    return 0


if __name__ == "__main__":
    sys.exit(main())
