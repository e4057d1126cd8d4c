"""Exponential moving average of the params tree:
``shadow = shadow + (1-decay)*(param - shadow)`` per step, decay 0.999, from
the post-update params (twin of ``viforsdes_tpu/inference/ema.py``)."""

from __future__ import annotations

import torch

from viforsdes_tpu_torch.inference.constants import DEFAULT_EMA_DECAY
from viforsdes_tpu_torch.utils.tree import tree_leaves, tree_map


def ema_init(params: dict) -> dict:
    return tree_map(lambda p: p.detach().clone(), params)


@torch.no_grad()
def ema_update(ema: dict, params: dict, decay: float = DEFAULT_EMA_DECAY) -> dict:
    """Update ``ema`` in place (no second copy of the tree) and return it."""
    for s, p in zip(tree_leaves(ema), tree_leaves(params)):
        s.add_((1.0 - decay) * (p - s))
    return ema
