"""Optimizer: non-finite skip + global-norm clip + two-group AdamW.

The update of ``viforsdes_tpu/inference/optimizer.py`` (optax
``adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)`` per group: theta
posterior and observation variance at ``sde_param_lr``, the rest at
``learning_rate``), written out so it matches optax step for step:

- one global-norm reduction serves the clip at ``grad_clip_norm``, the
  non-finite guard and the step metric;
- a non-finite norm zeroes the update and leaves the moments and the step
  count untouched; ``notfinite_count`` counts consecutive rejections
  (saturating), and the trainer's host loop aborts on a long run of them.

Parameters live in one flat fp32 buffer per group (``ParamLayout``), so the
whole update is a few elementwise kernels per group instead of a dozen per
leaf; the model reads its tree as views of those buffers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from viforsdes_tpu_torch.config import TrainingConfig
from viforsdes_tpu_torch.utils.tree import tree_items, tree_map_with_path

GROUPS = ("rest", "theta")
_INT32_MAX = 2**31 - 1


def param_group(path: str) -> str:
    """The learnable observation variance trains with theta."""
    return "theta" if path.split("/", 1)[0] in ("theta", "obs") else "rest"


class ParamLayout:
    """Where each leaf of a params tree sits in its group's flat buffer: the
    group's leaves in ``tree_items`` order, back to back."""

    def __init__(self, tree: dict) -> None:
        self.skeleton = tree_map_with_path(lambda path, leaf: None, tree)
        self.paths: dict[str, list[str]] = {g: [] for g in GROUPS}
        self.shapes: dict[str, tuple[int, ...]] = {}
        for path, leaf in tree_items(tree):
            self.paths[param_group(path)].append(path)
            self.shapes[path] = tuple(leaf.shape)

    def pack(self, tree: dict, device: torch.device) -> dict[str, Tensor]:
        parts: dict[str, list[Tensor]] = {g: [] for g in GROUPS}
        for path, leaf in tree_items(tree):
            if not isinstance(leaf, Tensor):  # numpy leaves (a converted JAX tree)
                leaf = torch.from_numpy(np.array(leaf, dtype=np.float32))
            parts[param_group(path)].append(leaf.reshape(-1).float())
        return {
            g: (torch.cat(p) if p else torch.zeros(0)).to(device) for g, p in parts.items()
        }

    def unpack(self, flats: dict[str, Tensor]) -> dict:
        """The params tree as views of ``flats`` (no copy). One ``split`` per
        group: its backward concatenates the leaf gradients once, where a
        slice per leaf would materialize a zero-filled full-size gradient per
        leaf."""
        pieces: dict[str, Tensor] = {}
        for group, paths in self.paths.items():
            sizes = [math.prod(self.shapes[p]) for p in paths]
            for path, piece in zip(paths, torch.split(flats[group], sizes)):
                pieces[path] = piece.view(self.shapes[path])
        return tree_map_with_path(lambda path, _: pieces[path], self.skeleton)


def global_norm(flats: dict[str, Tensor]) -> Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in flats.values()))


class AdamW:
    """Guarded, clipped two-group AdamW over flat group buffers."""

    B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01

    def __init__(self, config: TrainingConfig) -> None:
        self.lrs = {"rest": float(config.learning_rate), "theta": float(config.sde_param_lr)}
        self.max_norm = float(config.grad_clip_norm)

    def init(self, params: dict[str, Tensor]) -> dict:
        device = params["rest"].device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {g: torch.zeros_like(p) for g, p in params.items()},
            "nu": {g: torch.zeros_like(p) for g, p in params.items()},
            "notfinite_count": torch.zeros((), dtype=torch.int32, device=device),
            "total_notfinite": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def update(
        self, grads: dict[str, Tensor], state: dict, params: dict[str, Tensor], g_norm: Tensor
    ) -> dict[str, Tensor]:
        """Return the updates and advance ``state`` in place. ``g_norm`` is
        ``global_norm(grads)``, computed once by the caller."""
        b1, b2 = self.B1, self.B2
        isfinite = torch.isfinite(g_norm)
        trigger = g_norm < self.max_norm
        count_inc = torch.clamp(state["count"].long() + 1, max=_INT32_MAX)
        bc1 = 1.0 - b1 ** count_inc.float()
        bc2 = 1.0 - b2 ** count_inc.float()
        updates = {}
        for g, grad in grads.items():
            clipped = torch.where(trigger, grad, (grad / g_norm) * self.max_norm)
            mu = (1.0 - b1) * clipped + b1 * state["mu"][g]
            nu = (1.0 - b2) * (clipped * clipped) + b2 * state["nu"][g]
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            step = -self.lrs[g] * (step + self.WEIGHT_DECAY * params[g])
            updates[g] = torch.where(isfinite, step, torch.zeros_like(step))
            state["mu"][g].copy_(torch.where(isfinite, mu, state["mu"][g]))
            state["nu"][g].copy_(torch.where(isfinite, nu, state["nu"][g]))
        state["count"].copy_(torch.where(isfinite, count_inc.int(), state["count"]))
        bumped = torch.clamp(state["notfinite_count"].long() + 1, max=_INT32_MAX).int()
        state["notfinite_count"].copy_(torch.where(isfinite, torch.zeros_like(bumped), bumped))
        total = torch.clamp(state["total_notfinite"].long() + 1, max=_INT32_MAX).int()
        state["total_notfinite"].copy_(torch.where(isfinite, state["total_notfinite"], total))
        return updates


def make_optimizer(config: TrainingConfig) -> AdamW:
    return AdamW(config)
