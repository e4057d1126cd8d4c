"""Diffusion transition head: stacked GRU + zero-init output projection that
emits per-step Gaussian transition parameters (mu, Cholesky L), and the path
sampler that rolls ``z_{t+1} = z_t + mu_t*dt + (L_t @ eps_t)*sqrt(dt)``.

PyTorch twin of ``viforsdes_tpu/models/head.py`` (modes ``full`` and ``diag``).
The context/theta input projections are hoisted out of the recurrence as one
``[B*T, C] @ [C, 3H]`` product (``_gates_const``); the recurrence itself runs
in fp32 through ``ops/sde_sampler.py``: the CUDA kernels on a CUDA device
(``sampler="auto"`` or ``"pallas"``), the plain loop differentiated by
autograd for ``"scan"`` and for ``"auto"`` on the CPU.
"""

from __future__ import annotations

import torch
from torch import Tensor

from viforsdes_tpu_torch.config import HeadConfig
from viforsdes_tpu_torch.inference.constants import DIAG_MIN
from viforsdes_tpu_torch.ops.initializers import fan_in_uniform_init
from viforsdes_tpu_torch.ops.sde_sampler import (
    SamplerSpec,
    index_tables,
    prep_weights,
    sample_paths,
    sample_paths_scan,
)


class DiffusionTransitionHead:
    """Static-config head; params live in an explicit tree of tensors."""

    def __init__(
        self,
        state_dim: int,
        context_dim: int,
        sde_param_dim: int,
        config: HeadConfig,
    ) -> None:
        if config.num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {config.num_layers}")
        if config.cholesky == "matched":
            raise NotImplementedError(
                "cholesky='matched' runs the SDE's diffusion inside the recurrence;"
                " the port does not have it yet (ROADMAP.md, queue 1: the matched"
                " head mode)"
            )
        self.state_dim = state_dim
        self.context_dim = context_dim
        self.sde_param_dim = sde_param_dim
        self.hidden_dim = config.hidden_dim
        self.num_layers = config.num_layers
        self.cholesky = config.cholesky
        self.n_tril = state_dim if self.cholesky == "diag" else state_dim * (state_dim + 1) // 2
        self.input_dim = state_dim + context_dim + sde_param_dim
        self.sampler = config.sampler

    def init(self, gen: torch.Generator) -> dict:
        """GRU weights U(+-1/sqrt(H)) (torch GRU default); out_proj zero-init
        with Cholesky-diag bias 1.0."""
        h = self.hidden_dim
        bound = 1.0 / (h**0.5)

        def uniform(*shape: int) -> Tensor:
            return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound

        gru = []
        for layer in range(self.num_layers):
            in_dim = self.input_dim if layer == 0 else h
            gru.append(
                {
                    # stored [in, 3H]; fan-in of H regardless of in_dim, as torch GRU
                    "w_ih": uniform(in_dim, 3 * h),
                    "w_hh": fan_in_uniform_init(gen, (h, 3 * h)),
                    "b_ih": uniform(3 * h),
                    "b_hh": uniform(3 * h),
                }
            )
        out_b = torch.zeros(self.state_dim + self.n_tril, dtype=torch.float32)
        if self.cholesky == "diag":
            out_b[self.state_dim :] = 1.0
        else:
            for kk in range(self.state_dim):
                out_b[self.state_dim + kk * (kk + 3) // 2] = 1.0
        return {
            "gru": gru,
            "out_proj": {
                "w": torch.zeros((h, self.state_dim + self.n_tril), dtype=torch.float32),
                "b": out_b,
            },
        }

    def spec(self, time_step: float) -> SamplerSpec:
        return SamplerSpec(
            state_dim=self.state_dim,
            hidden_dim=self.hidden_dim,
            num_layers=self.num_layers,
            time_step=float(time_step),
            diag_min=DIAG_MIN,
            cholesky=self.cholesky,
        )

    def chol_matrix(self, chol_vals: Tensor) -> Tensor:
        """``[..., n_tril] -> [..., D, D]`` lower-triangular (full mode)."""
        rows, cols = index_tables(self.state_dim, "full", chol_vals.device, torch.long)
        out = chol_vals.new_zeros(chol_vals.shape[:-1] + (self.state_dim, self.state_dim))
        out[..., rows, cols] = chol_vals
        return out

    def _gates_const(self, params: dict, context: Tensor, theta: Tensor) -> Tensor:
        """Hoisted context/theta input projections: ``gates_const`` TIME-MAJOR
        ``[T, B, 3H]``, so the recurrence reads it without transposes."""
        d = self.state_dim
        p0 = params["gru"][0]
        w_ih0 = p0["w_ih"].float()
        w_c = w_ih0[d : d + self.context_dim]
        w_t = w_ih0[d + self.context_dim :]
        return (
            torch.einsum("btc,ch->tbh", context.float(), w_c)
            + (theta.float() @ w_t)[None, :, :]
            + p0["b_ih"].float()
        )

    def sample_diffusion_paths(
        self,
        params: dict,
        x0: Tensor,
        context: Tensor,
        sde_parameters: Tensor,
        standard_noise: Tensor,
        time_step: float,
    ) -> tuple[Tensor, Tensor, Tensor]:
        """Roll the full path: ``(z0 [B,D], context [B,T,C], theta [B,P],
        eps TIME-MAJOR [T,B,D]) -> (paths [B,T+1,D], means [B,T,D], chol)``
        with chol ``[B,T,D,D]`` in full mode and ``[B,T,D]`` in diag mode."""
        spec = self.spec(time_step)
        x0 = x0.float()
        noise = standard_noise.float()
        gates_const = self._gates_const(params, context, sde_parameters)
        weights = prep_weights(spec, params)

        sampler = self.sampler
        if sampler == "auto":
            sampler = "pallas" if x0.is_cuda else "scan"
        if sampler == "pallas":
            paths, means, chol_vals = sample_paths(spec, weights, x0, gates_const, noise)
        else:
            paths, means, chol_vals = sample_paths_scan(spec, weights, x0, gates_const, noise)
        if self.cholesky == "diag":
            return paths, means, chol_vals
        return paths, means, self.chol_matrix(chol_vals)

