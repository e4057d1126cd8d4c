"""Time embeddings and rotary position embeddings (RoPE).

PyTorch twin of ``viforsdes_tpu/ops/embeddings.py``: sinusoidal sin||cos time
features, and RoPE in the [real || imag]-halves layout — for a rotated width
``2F`` the first F lanes are the real part and the next F the imaginary part
of a complex number multiplied by ``e^{i*pos*freq}``; lanes past ``2F`` pass
through. Real arithmetic on fp32 cos/sin tables.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import Tensor


def sinusoidal_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    """``[...] -> [..., dim]`` sinusoidal features."""
    if dim % 2 != 0:
        raise ValueError("dim must be even")
    half_dim = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half_dim, dtype=torch.float32, device=t.device)
        / half_dim
    ).to(t.dtype)
    args = t[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


@dataclass(frozen=True)
class RotaryTables:
    """cos/sin tables, each ``[T, n_freqs]`` fp32."""

    cos: Tensor
    sin: Tensor

    @property
    def length(self) -> int:
        return self.cos.shape[0]

    def slice_to(self, seq_len: int) -> "RotaryTables":
        return RotaryTables(cos=self.cos[:seq_len], sin=self.sin[:seq_len])

    def to(self, device: torch.device | str) -> "RotaryTables":
        return RotaryTables(cos=self.cos.to(device), sin=self.sin.to(device))


def precompute_rope(dim: int, end: int = 1000, theta: float = 10000.0) -> RotaryTables:
    """Angle tables ``[end, dim/2]``, computed in fp32 as the JAX package does."""
    if dim % 2 != 0:
        raise ValueError("RoPE dimension must be even")
    idx = torch.arange(0, dim, 2, dtype=torch.float32)
    inv_freq = theta ** (-idx / dim)
    positions = torch.arange(end, dtype=torch.float32)
    angles = torch.outer(positions, inv_freq)
    return RotaryTables(cos=torch.cos(angles), sin=torch.sin(angles))


def apply_rope_1d(x: Tensor, tables: RotaryTables) -> Tensor:
    """Rotate ``x[..., S, D]`` by position along axis -2."""
    seq_len = x.shape[-2]
    if seq_len > tables.length:
        raise ValueError("requested sequence length exceeds precomputed frequencies")
    n_freqs = tables.cos.shape[-1]
    rot_dim = 2 * n_freqs
    rot, remainder = x[..., :rot_dim], x[..., rot_dim:]
    cos = tables.cos[:seq_len]
    sin = tables.sin[:seq_len]
    real = rot[..., :n_freqs].float()
    imag = rot[..., n_freqs:].float()
    out_real = real * cos - imag * sin
    out_imag = real * sin + imag * cos
    rotated = torch.cat([out_real, out_imag], dim=-1).to(x.dtype)
    if remainder.shape[-1] == 0:
        return rotated
    return torch.cat([rotated, remainder], dim=-1)
