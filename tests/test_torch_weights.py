"""Weights carried from the JAX package into the port, and the port's
independence from JAX.

- A JAX checkpoint (``viforsdes_tpu/utils/pytree_io.py``) read back with numpy
  alone (``utils/convert.py``) gives the same tree, leaf for leaf.
- The port's params layout has exactly the JAX tree's leaf paths and shapes.
- No module of ``viforsdes_tpu_torch/`` and not ``chip_smoke.py`` imports JAX
  or the JAX package (an AST scan, so it holds for every code path).
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from viforsdes_tpu.utils.pytree_io import save_checkpoint
from viforsdes_tpu_torch.utils.convert import load_jax_npz, params_from_numpy
from viforsdes_tpu_torch.utils.tree import tree_items

from test_torch_elbo import make_pair

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def test_npz_round_trip(tmp_path):
    jt, tt = make_pair(learn_obs_variance=True)
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, trees={"params": jt.params, "ema": jt.ema_params},
                    metadata={"next_step": 7, "note": "x"})
    trees, meta = load_jax_npz(path)
    assert meta["next_step"] == 7 and meta["note"] == "x"
    assert set(trees) == {"params", "ema"}
    params = params_from_numpy(trees["params"])
    j_flat = {p: np.asarray(v) for p, v in tree_items(jax.tree.map(np.asarray, jt.params))}
    t_flat = {p: v.numpy() for p, v in tree_items(params)}
    assert set(t_flat) == set(j_flat)
    for p, ref in j_flat.items():
        np.testing.assert_array_equal(t_flat[p], ref, err_msg=p)
        assert t_flat[p].dtype == ref.dtype, p
    # lists come back as lists (GRU layers, SiT blocks), so indexing matches
    assert isinstance(params["head"]["gru"], list) and len(params["head"]["gru"]) == 2


def test_port_layout_matches_jax_tree():
    jt, tt = make_pair(learn_obs_variance=True, theta_full_covariance=True)
    j_shapes = {p: tuple(np.shape(v)) for p, v in tree_items(jax.tree.map(np.asarray, jt.params))}
    t_shapes = {p: tuple(v.shape) for p, v in tree_items(tt.params)}
    assert t_shapes == j_shapes
    # pack/unpack is the identity on the tree
    tree = tt.params
    again = tt.layout.unpack(tt.layout.pack(tree, "cpu"))
    for (p, a), (_, b) in zip(tree_items(tree), tree_items(again)):
        assert torch.equal(a, b), p


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_port_never_imports_jax():
    package = REPO / "viforsdes_tpu_torch"
    files = [p for p in sorted(package.rglob("*.py")) if "_build" not in p.relative_to(package).parts]
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for name in _imported_modules(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "optax", "viforsdes_tpu"), f"{path}: imports {name}"
