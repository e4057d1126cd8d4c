"""Observation context encoder: SiT over the dense time grid.

PyTorch twin of ``viforsdes_tpu/models/encoder.py``: a grid of ``n_steps+1``
learned ``bridge_token`` slots, observed slots overwritten by
``obs_proj(values)`` at static indices, a sinusoidal time embedding added,
theta mapped to a cond vector by a 3-layer SiLU MLP, and the SiT stack run in
``compute_dtype`` with the cond kept ``[B, C]``. The grid is never padded (the
JAX package's hoisted padding is not ported): on grids past 512 tokens the
flash and QK-prep kernels mask the ragged tail themselves.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from viforsdes_tpu_torch.config import EncoderConfig
from viforsdes_tpu_torch.ops.embeddings import RotaryTables, precompute_rope, sinusoidal_embedding
from viforsdes_tpu_torch.ops.initializers import fan_in_uniform_linear_init, linear
from viforsdes_tpu_torch.ops.sit import SiTConfig, sit, sit_init
from viforsdes_tpu_torch.utils import profiling

_ROPE_MIN_LEN = 2048


class ObservationContextEncoder:
    """Static-config encoder; params live in an explicit tree of tensors."""

    def __init__(
        self,
        observation_dim: int,
        sde_param_dim: int,
        config: EncoderConfig,
        *,
        n_grid: int,
        obs_slot_indices: np.ndarray,
        grid_times: np.ndarray,
        device: torch.device,
    ) -> None:
        self.observation_dim = observation_dim
        self.sde_param_dim = sde_param_dim
        self.config = config
        self.hidden_dim = config.hidden_dim
        self.n_grid = n_grid
        self.obs_slot_indices = torch.as_tensor(
            np.asarray(obs_slot_indices, dtype=np.int64), device=device
        )
        self.grid_times = torch.as_tensor(
            np.asarray(grid_times, dtype=np.float32), device=device
        )
        self.sit_config = SiTConfig(
            in_dim=config.hidden_dim,
            hidden_dim=config.hidden_dim,
            out_dim=config.hidden_dim,
            cond_dim=config.cond_dim,
            num_heads=config.num_heads,
            depth=config.depth,
            mlp_hidden_dim=int(config.hidden_dim * config.mlp_ratio),
        )
        self.rotary: RotaryTables = (
            precompute_rope(
                config.hidden_dim // config.num_heads, end=max(_ROPE_MIN_LEN, n_grid)
            )
            .slice_to(n_grid)
            .to(device)
        )

    @classmethod
    def build(
        cls,
        observation_dim: int,
        sde_param_dim: int,
        config: EncoderConfig,
        *,
        obs_times: np.ndarray,
        time_horizon: float,
        time_step: float,
        device: torch.device,
    ) -> "ObservationContextEncoder":
        """Resolve the static time grid and observation slots."""
        n_grid = int(round(time_horizon / time_step)) + 1
        grid_times = np.linspace(0.0, time_horizon, n_grid)
        obs_slots = np.clip(
            np.round(np.asarray(obs_times) / time_step).astype(np.int64), 0, n_grid - 1
        )
        return cls(
            observation_dim,
            sde_param_dim,
            config,
            n_grid=n_grid,
            obs_slot_indices=obs_slots,
            grid_times=grid_times,
            device=device,
        )

    def init(self, gen: torch.Generator) -> dict:
        cfg = self.config
        return {
            "obs_proj": fan_in_uniform_linear_init(gen, self.observation_dim, cfg.hidden_dim),
            "bridge_token": torch.randn((cfg.hidden_dim,), generator=gen, dtype=torch.float32),
            "sde_param_proj": [
                fan_in_uniform_linear_init(gen, self.sde_param_dim, cfg.cond_dim),
                fan_in_uniform_linear_init(gen, cfg.cond_dim, cfg.cond_dim),
                fan_in_uniform_linear_init(gen, cfg.cond_dim, cfg.cond_dim),
            ],
            "sit": sit_init(gen, self.sit_config),
        }

    def _cond(self, params: dict, sde_parameters: Tensor) -> Tensor:
        """3-layer SiLU MLP theta -> cond."""
        l1, l2, l3 = params["sde_param_proj"]
        h = F.silu(linear(l1, sde_parameters))
        h = F.silu(linear(l2, h))
        return linear(l3, h)

    def __call__(
        self,
        params: dict,
        obs_values: Tensor,
        sde_parameters: Tensor,
        *,
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> Tensor:
        """``(obs [T_obs, O], theta [B, P]) -> context [B, n_grid, H]`` fp32,
        as device span ``encoder``."""
        with profiling.device_span("encoder"):
            batch = sde_parameters.shape[0]
            h = params["bridge_token"].expand(self.n_grid, self.hidden_dim)
            obs_tokens = linear(params["obs_proj"], obs_values)
            h = h.index_put((self.obs_slot_indices,), obs_tokens)
            h = h + sinusoidal_embedding(self.grid_times, self.hidden_dim)
            h = h[None].expand(batch, self.n_grid, self.hidden_dim)

            # cond stays [B, C]: constant over the grid, so the SiT blocks run the
            # adaLN projection once per sample and broadcast over tokens
            cond = self._cond(params, sde_parameters)
            context = sit(
                params["sit"],
                self.sit_config,
                h.to(compute_dtype),
                cond=cond.to(compute_dtype),
                rotary=self.rotary,
            )
            return context.float()
