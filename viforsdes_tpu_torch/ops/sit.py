"""SiT: stack of pre-norm transformer blocks with adaLN-Zero conditioning and
value-residual plumbing (twin of ``viforsdes_tpu/ops/sit.py``).

Per block, two cond branches (attn, mlp), each ``(scale, shift, gate)``;
residual update ``x + gate * f((1+scale)*norm(x) + shift)`` with non-affine
LayerNorm; block 0 exports its value state ``v0`` and later blocks mix it in.
No rematerialization: grids of at most 512 tokens take the dense attention
path, whose probabilities fit in device memory, and longer grids take the
flash kernels, which save one log-sum-exp per row instead of the
probabilities (the JAX package also skips remat when flash serves the grid).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from viforsdes_tpu_torch.ops.attention import AttentionConfig, attention, attention_init
from viforsdes_tpu_torch.ops.cond import cond_modulator, cond_modulator_init
from viforsdes_tpu_torch.ops.embeddings import RotaryTables
from viforsdes_tpu_torch.ops.initializers import (
    DEFAULT_INIT_POLICY,
    InitPolicy,
    linear,
    linear_init,
)
from viforsdes_tpu_torch.ops.mlp import swiglu, swiglu_init
from viforsdes_tpu_torch.ops.norms import layer_norm


class SiTConfig(NamedTuple):
    in_dim: int
    hidden_dim: int
    out_dim: int
    cond_dim: int
    num_heads: int
    depth: int
    mlp_hidden_dim: int
    bias: bool = True
    attn_gate: bool = True
    attn_residual_v: bool = True
    use_qk_norm: bool = True
    qk_norm_eps: float = 1e-6
    norm_eps: float = 1e-5

    def block_attention_config(self, idx: int) -> AttentionConfig:
        return AttentionConfig(
            embed_dim=self.hidden_dim,
            num_heads=self.num_heads,
            qk_norm=self.use_qk_norm,
            qk_norm_eps=self.qk_norm_eps,
            bias=self.bias,
            gate=self.attn_gate,
            # block 0 exports v0 but does not mix
            residual_v=self.attn_residual_v and idx > 0,
        )


def sit_block_init(
    gen: torch.Generator, cfg: SiTConfig, idx: int, *, policy: InitPolicy = DEFAULT_INIT_POLICY
) -> dict:
    return {
        "cond": cond_modulator_init(gen, cfg.cond_dim, cfg.hidden_dim, branches=2),
        "attn": attention_init(gen, cfg.block_attention_config(idx), policy=policy),
        "mlp": swiglu_init(
            gen,
            cfg.hidden_dim,
            cfg.mlp_hidden_dim,
            bias=cfg.bias,
            w_init_in=policy.mlp_in,
            w_init_out=policy.mlp_out,
        ),
    }


def sit_block(
    params: dict,
    cfg: SiTConfig,
    idx: int,
    hidden_states: Tensor,
    *,
    cond: Tensor,
    rotary: RotaryTables | None = None,
    v0: Tensor | None = None,
    real_len: int | None = None,
) -> tuple[Tensor, Tensor]:
    """One block: ``([B,S,H], cond [B,S,C] or [B,C]) -> ([B,S,H], value_state)``.
    A ``[B, C]`` cond runs the modulator once per sample and broadcasts over
    tokens."""
    attn_branch, mlp_branch = cond_modulator(params["cond"], cond, branches=2)
    if cond.ndim == 2:
        attn_branch = type(attn_branch)(*(f.unsqueeze(1) for f in attn_branch))
        mlp_branch = type(mlp_branch)(*(f.unsqueeze(1) for f in mlp_branch))

    modulated = attn_branch.affine(layer_norm(hidden_states, eps=cfg.norm_eps))
    attn_out, value_state = attention(
        params["attn"],
        cfg.block_attention_config(idx),
        modulated,
        rotary=rotary,
        v0=v0,
        real_len=real_len,
    )
    hidden_states = hidden_states + attn_branch.gate(attn_out)

    modulated = mlp_branch.affine(layer_norm(hidden_states, eps=cfg.norm_eps))
    hidden_states = hidden_states + mlp_branch.gate(swiglu(params["mlp"], modulated))
    return hidden_states, value_state


def sit_init(
    gen: torch.Generator, cfg: SiTConfig, *, policy: InitPolicy = DEFAULT_INIT_POLICY
) -> dict:
    return {
        "input_proj": linear_init(gen, cfg.in_dim, cfg.hidden_dim, bias=cfg.bias, w_init=policy.linear),
        "output_proj": linear_init(gen, cfg.hidden_dim, cfg.out_dim, bias=cfg.bias, w_init=policy.linear),
        "blocks": [sit_block_init(gen, cfg, i, policy=policy) for i in range(cfg.depth)],
    }


def sit(
    params: dict,
    cfg: SiTConfig,
    x: Tensor,
    *,
    cond: Tensor,
    rotary: RotaryTables | None = None,
    real_len: int | None = None,
) -> Tensor:
    """``[B, S, in_dim] -> [B, S, out_dim]``."""
    tokens = linear(params["input_proj"], x)
    cached_v: Tensor | None = None
    for idx, block_params in enumerate(params["blocks"]):
        tokens, block_value = sit_block(
            block_params, cfg, idx, tokens, cond=cond, rotary=rotary, v0=cached_v,
            real_len=real_len,
        )
        if cached_v is None:
            cached_v = block_value
    return linear(params["output_proj"], tokens)
