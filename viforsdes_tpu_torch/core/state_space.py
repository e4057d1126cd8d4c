"""Bijection between constrained state x and unconstrained latent z.

PyTorch twin of ``viforsdes_tpu/core/state_space.py``: for dims marked
positive, ``to_state`` is softplus, ``to_latent`` its inverse
``x + log(-expm1(-x))`` (input clamped at 1e-6), and ``log_jacobian(z)`` is
``logsigmoid(z)`` summed over the positive dims; identity elsewhere.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor


class StateSpace:
    def __init__(self, dim: int, positive_dims: list[int] | None = None) -> None:
        if dim < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        resolved = list(positive_dims or [])
        if any(d < 0 or d >= dim for d in resolved):
            raise ValueError(f"positive_dims must be in [0, {dim}), got {resolved}")
        if len(resolved) != len(set(resolved)):
            raise ValueError(f"positive_dims must be unique, got {resolved}")
        self.dim = dim
        self.positive_dims = resolved
        mask = torch.zeros(dim, dtype=torch.bool)
        mask[resolved] = True
        # one copy per device, made once: a host-to-device copy per call
        # would stall the host on the stream
        self._masks = {mask.device: mask}
        self._any = bool(resolved)

    def _mask(self, like: Tensor) -> Tensor:
        if like.device not in self._masks:
            self._masks[like.device] = self._masks[torch.device("cpu")].to(like.device)
        return self._masks[like.device]

    def to_state(self, z: Tensor) -> Tensor:
        if not self._any:
            return z
        return torch.where(self._mask(z), F.softplus(z), z)

    def to_latent(self, x: Tensor) -> Tensor:
        if not self._any:
            return x
        x_pos = torch.clamp(x, min=1e-6)
        inv = x_pos + torch.log(-torch.expm1(-x_pos))
        return torch.where(self._mask(x), inv, x)

    def log_jacobian(self, z: Tensor) -> Tensor:
        """log|d softplus(z)/dz| summed over positive dims: ``[...,D] -> [...]``."""
        if not self._any:
            return torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        return torch.sum(
            torch.where(self._mask(z), F.logsigmoid(z), torch.zeros_like(z)), dim=-1
        )

    def latent_jacobian_diag(self, z: Tensor) -> Tensor:
        """Per-dim ``dz/dx`` at ``x = to_state(z)``: ``1/sigmoid(z)`` on
        positive dims, 1 elsewhere (``[...,D] -> [...,D]``)."""
        if not self._any:
            return torch.ones_like(z)
        return torch.where(self._mask(z), 1.0 / torch.sigmoid(z), torch.ones_like(z))
