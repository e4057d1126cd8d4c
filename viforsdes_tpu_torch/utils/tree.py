"""Parameter trees: nested dicts and lists of tensors, the layout of the JAX
package's pytrees. Dict keys are visited in sorted order, as ``jax.tree``
visits them, so a flat list of leaves lines up between the two packages.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs, paths joined by "/" (the ``.npz`` key format)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_items(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``tree_map`` whose ``fn`` also gets the leaf's "/"-joined path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, f"{prefix}{i}/") for i, t in enumerate(tree))
    return fn(prefix[:-1], tree)
