"""Weights carried across from the JAX package.

``load_jax_npz`` reads the ``.npz`` format of ``viforsdes_tpu/utils/pytree_io.py``
(every leaf stored under its tree path joined by "/", plus a JSON metadata
blob) with numpy alone; ``params_from_numpy`` turns a params tree of numpy
arrays into the port's tree of tensors, leaf for leaf (the port keeps the JAX
layout: weights ``[in, out]``, GRU gates r,z,n, the same leaf paths).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from viforsdes_tpu_torch.utils.tree import tree_map

_META_KEY = "__viforsdes_meta__"
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
    with np.load(Path(path)) as archive:
        flat = {k: archive[k] for k in archive.files}
    if _META_KEY not in flat:
        raise ValueError("not a viforsdes checkpoint: missing metadata blob")
    metadata = json.loads(bytes(flat.pop(_META_KEY)).decode("utf-8"))
    return _nest(flat), metadata
