"""Checkpoint archives: trees of tensors <-> one ``.npz`` file.

The format of ``viforsdes_tpu/utils/pytree_io.py``, written and read with
numpy and torch alone: every leaf under its tree path (dict keys in sorted
order, list indices, joined by "/", prefixed by the tree's name) plus a JSON
metadata blob under ``__viforsdes_meta__`` carrying ``format_version`` 2. A
file that either package writes, the other reads. Loading rebuilds each tree
from a template and refuses an archive whose leaves under that name differ
from the template's in path or shape.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from viforsdes_tpu_torch.utils.tree import tree_items, tree_map_with_path

_META_KEY = "__viforsdes_meta__"
_SEP = "/"

# The on-disk version of the JAX package's format (its history is kept there).
CHECKPOINT_FORMAT_VERSION = 2


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """``{prefix + path: leaf}`` with each leaf as a numpy array."""
    return {prefix + path: _to_numpy(leaf) for path, leaf in tree_items(tree)}


def unflatten_like(template: Any, flat: dict[str, np.ndarray], prefix: str = "") -> Any:
    """A tree of CPU tensors with ``template``'s structure from a flat mapping;
    a missing path or another shape raises."""

    def leaf(path: str, like: Any) -> torch.Tensor:
        key = prefix + path
        if key not in flat:
            raise KeyError(f"checkpoint missing array for {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"checkpoint shape mismatch at {key!r}: {arr.shape} vs expected {tuple(like.shape)}"
            )
        return torch.from_numpy(np.array(arr, copy=True))

    return tree_map_with_path(leaf, template)


def save_checkpoint(path: str | Path, trees: dict[str, Any], metadata: dict) -> None:
    """Save named trees and JSON metadata into one ``.npz``."""
    flat: dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        flat.update(flatten(tree, prefix=name + _SEP))
    flat[_META_KEY] = np.frombuffer(
        json.dumps({"format_version": CHECKPOINT_FORMAT_VERSION, **metadata}).encode("utf-8"),
        dtype=np.uint8,
    )
    np.savez(Path(path), **flat)


def read_archive(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """Every array of the archive by its path, and the metadata."""
    with np.load(Path(path)) as archive:
        flat = {k: archive[k] for k in archive.files}
    if _META_KEY not in flat:
        raise ValueError("not a viforsdes checkpoint: missing metadata blob")
    metadata = json.loads(bytes(flat.pop(_META_KEY)).decode("utf-8"))
    return flat, metadata


def load_checkpoint(
    path: str | Path,
    templates: dict[str, Any],
    *,
    required_metadata: tuple[str, ...] = (),
    kind: str = "viforsdes",
) -> tuple[dict[str, Any], dict]:
    """Load named trees (rebuilt on ``templates``) and the metadata.

    A metadata key of ``required_metadata`` that is missing raises "not a
    <kind> checkpoint"; leaves under a template's name that the template does
    not have, or template leaves the archive lacks, raise a structure
    mismatch that names them.
    """
    flat, metadata = read_archive(path)
    missing = [k for k in required_metadata if k not in metadata]
    if missing:
        raise ValueError(
            f"not a {kind} checkpoint (or an incompatible version): "
            f"metadata is missing keys {missing}; found {sorted(metadata)}"
        )
    version = metadata.get("format_version", 1)
    wanted = {name + _SEP + p for name, t in templates.items() for p, _ in tree_items(t)}
    ours = [k for k in flat if k.split(_SEP, 1)[0] in templates]
    absent = sorted(wanted - set(ours))
    extra = sorted(set(ours) - wanted)
    if absent or extra:
        raise ValueError(
            f"checkpoint structure mismatch while restoring a {kind} checkpoint "
            f"(saved format_version={version}, current={CHECKPOINT_FORMAT_VERSION}): "
            f"{len(absent)} leaves missing {absent[:4]}, {len(extra)} unexpected {extra[:4]}"
        )
    trees = {name: unflatten_like(t, flat, prefix=name + _SEP) for name, t in templates.items()}
    return trees, metadata
