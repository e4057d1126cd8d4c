"""Weights carried across from the JAX package.

``load_jax_npz`` reads the ``.npz`` format of ``viforsdes_tpu/utils/pytree_io.py``
(every leaf stored under its tree path joined by "/", plus a JSON metadata
blob) through the port's own reader, ``utils/pytree_io.py``, which also writes
that format; ``params_from_numpy`` turns a params tree of numpy arrays into
the port's tree of tensors, leaf for leaf (the port keeps the JAX layout:
weights ``[in, out]``, GRU gates r,z,n, the same leaf paths).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from viforsdes_tpu_torch.utils.pytree_io import read_archive
from viforsdes_tpu_torch.utils.tree import tree_map

_SEP = "/"


def params_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree
    )


def _nest(flat: dict[str, np.ndarray]) -> Any:
    """Rebuild nested dicts from "/"-joined paths; a level whose keys are all
    integers is a list."""
    root: dict = {}
    for path, arr in flat.items():
        node = root
        *parents, last = path.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        items = {k: listify(v) for k, v in node.items()}
        if items and all(k.isdigit() for k in items):
            return [items[str(i)] for i in range(len(items))]
        return items

    return listify(root)


def load_jax_npz(path: str | Path) -> tuple[dict[str, Any], dict]:
    """``(trees, metadata)``: the archive's top-level names (``"params"``,
    ``"model_state"``, ...) mapped to their numpy trees, and the metadata."""
    flat, metadata = read_archive(path)
    return _nest(flat), metadata
