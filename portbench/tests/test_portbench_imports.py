"""What the benchmark runs loads no module of JAX or of the JAX package, and
the reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import spec

REFERENCE = spec.BENCH_DIR / "reference"


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & {"viforsdes_tpu_torch", "viforsdes_tpu", "jax", "jaxlib", "flax"}, tops
    assert {name for name in _imports(path) if name.startswith("portbench")} <= {
        "portbench.reference", "portbench.reference.model", "portbench.reference.precision",
        "portbench.reference.train"}


def test_top_level_names_compared_whole():
    from portbench import run

    saved = dict(sys.modules)
    try:
        sys.modules["viforsdes_tpu_torch.fake"] = sys
        sys.modules["jaxtyping"] = sys
        assert "viforsdes_tpu_torch.fake" not in run.forbidden_modules()
        assert "jaxtyping" not in run.forbidden_modules()
        sys.modules["viforsdes_tpu.core"] = sys
        sys.modules["jax"] = sys
        assert {"viforsdes_tpu.core", "jax"} <= set(run.forbidden_modules())
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import portbench.run as run
from portbench.tests.conftest import tiny
import portbench.reference.train
before = run.forbidden_modules()
out = run.run_cell(tiny("highdim_r5.bf16"), 5, 0.0, False, "cpu")
print(json.dumps({{"found": run.forbidden_modules(), "before": before, "numbers": out.numbers}}))
"""


def test_a_run_loads_no_jax_module():
    """A whole tiny run in a fresh process: the program, the harness and the
    reference together load no module named jax, jaxlib, flax or
    viforsdes_tpu (the port's own name starts with the last, and passes)."""
    code = CHILD.format(root=str(spec.ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    record = json.loads(res.stdout.strip().splitlines()[-1])
    assert record["found"] == [] and record["before"] == []


def test_reference_alone_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(spec.ROOT)!r}); "
            "import portbench.reference.train, portbench.reference.model, portbench.reference.precision; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('viforsdes_tpu_torch', 'viforsdes_tpu', 'jax', 'jaxlib', 'flax')])")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
