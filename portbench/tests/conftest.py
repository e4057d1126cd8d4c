"""The benchmark's own tests: on the CPU at tiny sizes, except those marked
``card``, which skip without a CUDA device (decided inside the fixture)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def tiny(name: str = "lorenz_r3.bf16", **traffic):
    """The cell ``name`` at a tiny width (SiT 32 wide, 2 heads, 2 blocks;
    head 16 wide; batch 8 as 2 theta x IW-4; Lorenz's grid cut to 101
    tokens): the same code paths, the CPU's plain kernels."""
    from portbench.harness import spec

    cell = spec.load_cell(name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["encoder"] = {"hidden_dim": 32, "cond_dim": 16, "num_heads": 2, "depth": 2, "mlp_ratio": 8 / 3}
    cfg["head"] = {**cfg["head"], "hidden_dim": 16}
    if cfg["sde"] == "lorenz63":
        cfg["time_horizon"] = 1.0
    tr.update({"batch_size": 8, "iw_samples": 4, **traffic})
    cell.config, cell.traffic = cfg, tr
    return cell
