"""Diffusion transition head: stacked GRU + zero-init output projection that
emits per-step Gaussian transition parameters (mu, Cholesky L), and the path
sampler that rolls ``z_{t+1} = z_t + mu_t*dt + (L_t @ eps_t)*sqrt(dt)``.

PyTorch twin of ``viforsdes_tpu/models/head.py``. The context/theta input
projections are hoisted out of the recurrence as one ``[B*T, C] @ [C, 3H]``
product (``_gates_const``); the recurrence itself runs in fp32. Modes ``full``
and ``diag`` run it through ``ops/sde_sampler.py``: the CUDA kernels on a
CUDA device (``sampler="auto"`` or ``"pallas"``), the plain loop
differentiated by autograd for ``"scan"`` and for ``"auto"`` on the CPU.
Mode ``matched`` (the diffusion-matched bridge) evaluates the user's
diffusion inside the recurrence, so it runs a plain loop over time steps on
every device, as the JAX package runs its scan; ``sampler="pallas"`` is
refused for it.
"""

from __future__ import annotations

import torch
from torch import Tensor

from viforsdes_tpu_torch.config import HeadConfig
from viforsdes_tpu_torch.inference.constants import DIAG_MIN
from viforsdes_tpu_torch.ops.bounds import lower_bound
from viforsdes_tpu_torch.ops.initializers import fan_in_uniform_init
from viforsdes_tpu_torch.ops.sde_sampler import (
    K1_MAX_HIDDEN,
    SamplerSpec,
    _gru_cell,
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
        device: torch.device | None = None,
    ) -> None:
        """``device`` is where the paths will be sampled. On a CUDA device
        ``"auto"`` runs the kernels up to the widest head they take
        (``K1_MAX_HIDDEN``) and the plain loop above it, as the JAX package's
        ``"auto"`` takes its scan off the TPU; ``"pallas"`` with a wider head
        is refused here rather than at the first step."""
        if config.num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {config.num_layers}")
        self.state_dim = state_dim
        self.context_dim = context_dim
        self.sde_param_dim = sde_param_dim
        self.hidden_dim = config.hidden_dim
        self.num_layers = config.num_layers
        # "matched": the head emits d per-dim log-corrections c, and the
        # transition scale is diag(dz/dx) @ g(x_t, theta) * exp(softcap(c)),
        # built inside the recurrence from the user's diffusion
        self.cholesky = config.cholesky
        if self.cholesky in ("diag", "matched"):
            self.n_tril = state_dim
        else:
            self.n_tril = state_dim * (state_dim + 1) // 2
        if self.cholesky == "matched" and config.sampler == "pallas":
            raise ValueError(
                "cholesky='matched' evaluates the user's diffusion inside the"
                " recurrence and requires the scan sampler; set sampler to"
                " 'auto' or 'scan'"
            )
        self.input_dim = state_dim + context_dim + sde_param_dim
        self.sampler = config.sampler
        if (device is not None and self.sampler == "pallas" and self.cholesky != "matched"
                and torch.device(device).type == "cuda" and self.hidden_dim > K1_MAX_HIDDEN):
            raise ValueError(
                f"HeadConfig(hidden_dim={self.hidden_dim}): the path-sampler kernels take "
                f"hidden_dim <= {K1_MAX_HIDDEN}; pass sampler=\"auto\" or \"scan\" for the plain loop"
            )

    def uses_kernels(self, device: torch.device) -> bool:
        """Whether paths sampled on ``device`` run the CUDA kernels (K1/K2):
        only on a CUDA device, never for ``"scan"`` or the matched mode, and
        under ``"auto"`` only up to ``K1_MAX_HIDDEN``."""
        if torch.device(device).type != "cuda" or self.sampler == "scan" or self.cholesky == "matched":
            return False
        return self.sampler == "pallas" or self.hidden_dim <= K1_MAX_HIDDEN

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
        elif self.cholesky == "matched":
            pass  # log-corrections 0: the bridge's diffusion is the SDE's at init
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

    def chol_from_params(self, raw: Tensor) -> Tensor:
        """Raw Cholesky outputs -> the transition scale: full mode ``[...,
        n_tril] -> [..., D, D]`` with the diagonal clamped by ``lower_bound``;
        diag mode the clamped ``[..., D]``. (Matched mode: ``matched_chol``.)"""
        if self.cholesky == "diag":
            return lower_bound(raw, DIAG_MIN)
        rows, cols = index_tables(self.state_dim, "full", raw.device, torch.long)
        return self.chol_matrix(torch.where(rows == cols, lower_bound(raw, DIAG_MIN), raw))

    # Soft cap on the matched-mode log-correction: |c| <= CORR_CAP bounds the
    # learned multiplier to [e^-4, e^4], so a transient gradient spike cannot
    # overflow the bridge's scale.
    CORR_CAP = 4.0

    def matched_chol(self, z: Tensor, sde_parameters: Tensor, raw_corr: Tensor, sde, state_space) -> Tensor:
        """The diffusion-matched transition scale ``diag(dz/dx) @
        g(to_state(z), theta) * exp(softcap(c))`` ``[..., D, D]``, its
        diagonal clamped by the ``lower_bound`` STE."""
        x = state_space.to_state(z)
        l_x = sde.diffusion(x, sde_parameters)
        jac = state_space.latent_jacobian_diag(z)
        corr = self.CORR_CAP * torch.tanh(raw_corr / self.CORR_CAP)
        scale = jac * torch.exp(corr)  # per row, i.e. per output dim
        out = scale[..., None] * l_x
        diag = lower_bound(torch.diagonal(out, dim1=-2, dim2=-1), DIAG_MIN)
        eye = torch.eye(self.state_dim, dtype=torch.bool, device=out.device)
        return torch.where(eye, torch.diag_embed(diag), out)

    def forward(
        self,
        params: dict,
        x_t: Tensor,
        context_t: Tensor,
        sde_parameters: Tensor,
        hidden: Tensor | None = None,
        *,
        sde=None,
        state_space=None,
    ) -> tuple[Tensor, Tensor, Tensor]:
        """One step (the tests' oracle): ``hidden [L, B, H]`` or None ->
        zeros; returns ``(mu, L, hidden')``. Matched mode also needs ``sde``
        and ``state_space`` (``x_t`` is latent, as everywhere in the head)."""
        batch = x_t.shape[0]
        if hidden is None:
            hidden = x_t.new_zeros((self.num_layers, batch, self.hidden_dim), dtype=torch.float32)
        h_in = torch.cat([x_t, context_t, sde_parameters], dim=-1)
        new_hidden = []
        for layer, p in enumerate(params["gru"]):
            h_in = _gru_cell(h_in @ p["w_ih"] + p["b_ih"], hidden[layer], p["w_hh"], p["b_hh"])
            new_hidden.append(h_in)
        out = h_in @ params["out_proj"]["w"] + params["out_proj"]["b"]
        mu, raw = out[..., : self.state_dim], out[..., self.state_dim :]
        if self.cholesky == "matched":
            if sde is None or state_space is None:
                raise ValueError("cholesky='matched' needs sde and state_space")
            chol = self.matched_chol(x_t, sde_parameters, raw, sde, state_space)
        else:
            chol = self.chol_from_params(raw)
        return mu, chol, torch.stack(new_hidden)

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
        *,
        sde=None,
        state_space=None,
    ) -> tuple[Tensor, Tensor, Tensor]:
        """Roll the full path: ``(z0 [B,D], context [B,T,C], theta [B,P],
        eps TIME-MAJOR [T,B,D]) -> (paths [B,T+1,D], means [B,T,D], chol)``
        with chol ``[B,T,D,D]`` in full and matched mode and ``[B,T,D]`` in
        diag mode. Matched mode requires ``sde`` and ``state_space``."""
        spec = self.spec(time_step)
        x0 = x0.float()
        noise = standard_noise.float()
        gates_const = self._gates_const(params, context, sde_parameters)
        weights = prep_weights(spec, params)

        if self.cholesky == "matched":
            if sde is None or state_space is None:
                raise ValueError("cholesky='matched' needs sde and state_space")
            return self._sample_matched(spec, weights, x0, gates_const, noise, sde_parameters.float(),
                                        sde, state_space)
        sampler = self.sampler
        if sampler == "auto":
            sampler = "pallas" if self.uses_kernels(x0.device) else "scan"
        if sampler == "pallas":
            paths, means, chol_vals = sample_paths(spec, weights, x0, gates_const, noise)
        else:
            paths, means, chol_vals = sample_paths_scan(spec, weights, x0, gates_const, noise)
        if self.cholesky == "diag":
            return paths, means, chol_vals
        return paths, means, self.chol_matrix(chol_vals)

    def _sample_matched(self, spec: SamplerSpec, w, x0: Tensor, gc: Tensor, eps: Tensor, theta: Tensor,
                        sde, state_space) -> tuple[Tensor, Tensor, Tensor]:
        """The matched mode's recurrence: the GRU of the plain sampler loop,
        then the transition scale from the SDE's diffusion at each step's
        state (``matched_chol``), differentiated by autograd."""
        d, dt, sqrt_dt = spec.state_dim, spec.time_step, spec.time_step**0.5
        x = x0
        hs = [x0.new_zeros((x0.shape[0], spec.hidden_dim)) for _ in range(spec.num_layers)]
        paths, means, chols = [x0], [], []
        for t in range(gc.shape[0]):
            h_in = _gru_cell(gc[t] + x @ w.w_x, hs[0], w.w_hh0, w.b_hh0)
            new_hs = [h_in]
            for li in range(spec.num_layers - 1):
                h_in = _gru_cell(h_in @ w.w_ih_st[li] + w.b_ih_st[li], hs[li + 1], w.w_hh_st[li], w.b_hh_st[li])
                new_hs.append(h_in)
            hs = new_hs
            out = h_in @ w.w_out + w.b_out
            mu = out[:, :d]
            chol = self.matched_chol(x, theta, out[:, d:], sde, state_space)
            x = x + mu * dt + torch.einsum("bij,bj->bi", chol, eps[t]) * sqrt_dt
            paths.append(x)
            means.append(mu)
            chols.append(chol)
        return torch.stack(paths, dim=1), torch.stack(means, dim=1), torch.stack(chols, dim=1)
