"""SiT: stack of pre-norm transformer blocks with adaLN-Zero conditioning and
value-residual plumbing (twin of ``viforsdes_tpu/ops/sit.py``).

Per block, two cond branches (attn, mlp), each ``(scale, shift, gate)``;
residual update ``x + gate * f((1+scale)*norm(x) + shift)`` with non-affine
LayerNorm, each residual add run with the LayerNorm and modulation that
follow it (``ops/adaln_norm.py``); block 0 exports its value state ``v0`` and
later blocks mix it in.
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
from viforsdes_tpu_torch.ops.adaln_norm import gated_norm_modulate
from viforsdes_tpu_torch.ops.cond import CondBranch, cond_modulator, cond_modulator_init
from viforsdes_tpu_torch.ops.embeddings import RotaryTables
from viforsdes_tpu_torch.ops.initializers import (
    DEFAULT_INIT_POLICY,
    InitPolicy,
    linear,
    linear_init,
)
from viforsdes_tpu_torch.ops.mlp import swiglu, swiglu_init


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


def _branches(params: dict, cond: Tensor) -> tuple[CondBranch, CondBranch]:
    """A block's attention and MLP modulations. A ``[B, C]`` cond runs the
    modulator once per sample and broadcasts over tokens as ``[B, 1, H]``."""
    attn_branch, mlp_branch = cond_modulator(params["cond"], cond, branches=2)
    if cond.ndim == 2:
        attn_branch = CondBranch(*(f.unsqueeze(1) for f in attn_branch))
        mlp_branch = CondBranch(*(f.unsqueeze(1) for f in mlp_branch))
    return attn_branch, mlp_branch


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
    """``[B, S, in_dim] -> [B, S, out_dim]``, cond ``[B, S, C]`` or ``[B, C]``.

    Each block's residual update ``x + gate * f(modulated)`` ends at the next
    norm site, which ``gated_norm_modulate`` runs with the LayerNorm and the
    modulation in one pass: block i's attention site takes block i-1's MLP
    output and gate (block 0 has none), its MLP site the attention output.
    The last block's MLP residual is added before the output projection."""
    tokens = linear(params["input_proj"], x)
    pending: tuple[Tensor | None, Tensor | None] = (None, None)
    cached_v: Tensor | None = None
    for idx, block_params in enumerate(params["blocks"]):
        attn_branch, mlp_branch = _branches(block_params, cond)
        tokens, modulated = gated_norm_modulate(
            tokens, *pending, attn_branch.scale, attn_branch.shift, eps=cfg.norm_eps
        )
        attn_out, block_value = attention(
            block_params["attn"],
            cfg.block_attention_config(idx),
            modulated,
            rotary=rotary,
            v0=cached_v,
            real_len=real_len,
        )
        tokens, modulated = gated_norm_modulate(
            tokens, attn_out, attn_branch.gate_value, mlp_branch.scale, mlp_branch.shift,
            eps=cfg.norm_eps,
        )
        pending = (swiglu(block_params["mlp"], modulated), mlp_branch.gate_value)
        if cached_v is None:
            cached_v = block_value
    y, gate = pending
    if y is not None:
        tokens = tokens + y * gate
    return linear(params["output_proj"], tokens)
