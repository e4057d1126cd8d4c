"""The JAX package's five examples (``examples/``) and its quality ladder
(``benchmarks/quality_eval.py``) on the PyTorch port.

Each module imports ``torch`` and ``viforsdes_tpu_torch`` only. Where a JAX
example simulates its observations with ``jax.random``, the port cannot draw
the same bits, so ``data/`` holds those observations, written exactly (float64
``repr`` of each float32 value) by ``tools/ladder_data.py``; both packages then
fit the same data. Run an example from the repository root:

    python3 examples_torch/lotka_volterra.py
"""

from __future__ import annotations

import json
from pathlib import Path

DATA_DIR = Path(__file__).resolve().parent / "data"


def load_observations(name: str):
    """The observations of dataset ``name`` (``data/<name>.json``) as
    ``viforsdes_tpu_torch.Observations``."""
    import viforsdes_tpu_torch as vtt

    record = json.loads((DATA_DIR / f"{name}.json").read_text())
    return vtt.Observations(times=record["times"], values=record["values"])
