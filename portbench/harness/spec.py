"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configuration and traffic, and the metrics. Each name leads to a file of
its own, so a new configuration, traffic mix or metric is a new file and
never an edit:

- configuration ``<c>``: ``portbench/configs/<c>.json``;
- traffic ``<t>``: ``portbench/workloads/<t>.json``;
- per-layer metric ``<m>``: ``portbench/metrics/<m>.py``, whose ``read(run)``
  returns the value or None where it finds nothing to read. Every cell runs
  every reader, and the reader alone decides where its metric is reported
  (a metric's ``workloads`` in ``BENCHMARK.json`` states where it is
  expected; the harness does not read it);
- an SDE ``<s>`` named by a configuration: ``portbench/sdes/<s>.py``
  (``SDE``), and its observations ``portbench/data/<d>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}: 1-64 of A-Z a-z 0-9 _ . -, not starting with . or -")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"bad unit {unit!r}: 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One entry of ``workloads`` with its files and its metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    def metric_module(self, metric: dict) -> ModuleType:
        return load_module(BENCH_DIR / "metrics" / f"{check_name(metric['name'])}.py", metric["name"])


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files, and the metrics it reports."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == check_name(name)]
    if len(entries) != 1:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = entries[0]
    config = load_json(BENCH_DIR / "configs" / f"{check_name(w['config'])}.json")
    traffic = load_json(BENCH_DIR / "workloads" / f"{check_name(w['traffic'])}.json")
    if traffic.get("config") != w["config"]:
        raise ValueError(f"traffic {w['traffic']!r} is for {traffic.get('config')!r}, not {w['config']!r}")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = list(bench["per_layer"])
    for m in (*e2e, *per_layer):
        check_name(m["name"])
        check_unit(m["unit"])
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)
