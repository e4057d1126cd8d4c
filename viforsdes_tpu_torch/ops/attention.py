"""Multi-head self-attention with QK-RMSNorm, RoPE, sigmoid output gate, and
residual-value mixing.

PyTorch twin of ``viforsdes_tpu/ops/attention.py``:
- fused QKV linear, heads split as ``b s (h d) -> b s h d``;
- per-head non-affine RMSNorm on Q/K, then 1-D RoPE on Q/K;
- non-causal scaled-dot-product attention with fp32 logits and softmax;
- sigmoid output gate of width head_dim broadcast over heads (zero-init, so
  0.5 at init);
- residual-value mixing ``v = lam*v + (1-lam)*v0``.

Grids of at most 512 tokens take the dense path: the probabilities cast to
the value dtype for P·V (``_dense_sdpa_remat_impl``). Longer grids take the
flash kernels (``ops/flash_attention.py``; a head narrower than a kernel
width runs zero-padded to it), with RMSNorm and RoPE fused into the QK-prep
kernel (``ops/qk_prep.py``) when the rotation covers the whole head and the
head is a kernel width (32, 64, 128). A head wider than 128 has no flash
kernel and takes the dense path at any length, as the JAX package does off
the TPU. Both paths keep q, k, v and the value state in ``[B, S, H, D]``:
the kernels read them through their strides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from viforsdes_tpu_torch.ops.embeddings import RotaryTables, apply_rope_1d
from viforsdes_tpu_torch.ops.flash_attention import FLASH_MAX_HEAD_DIM, flash_sdpa, use_flash_attention
from viforsdes_tpu_torch.ops.initializers import (
    DEFAULT_INIT_POLICY,
    InitPolicy,
    linear,
    linear_init,
    zeros_init,
)
from viforsdes_tpu_torch.ops.norms import rms_norm
from viforsdes_tpu_torch.ops.qk_prep import SUPPORTED_HEAD_DIMS, qk_prep
from viforsdes_tpu_torch.utils import profiling


class AttentionConfig(NamedTuple):
    embed_dim: int
    num_heads: int
    qk_norm: bool = True
    qk_norm_eps: float = 1e-6
    bias: bool = True
    gate: bool = True
    residual_v: bool = False

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def attention_init(
    gen: torch.Generator, cfg: AttentionConfig, *, policy: InitPolicy = DEFAULT_INIT_POLICY
) -> dict:
    if cfg.embed_dim % cfg.num_heads != 0:
        raise ValueError("embed_dim must be divisible by num_heads")
    params = {
        "qkv_proj": linear_init(gen, cfg.embed_dim, 3 * cfg.embed_dim, bias=cfg.bias, w_init=policy.attn_in),
        "out_proj": linear_init(gen, cfg.embed_dim, cfg.embed_dim, bias=cfg.bias, w_init=policy.attn_out),
    }
    if cfg.gate:
        params["gate_proj"] = linear_init(gen, cfg.embed_dim, cfg.head_dim, bias=True, w_init=zeros_init)
    if cfg.residual_v:
        params["v_residual_lambda"] = torch.tensor(0.5, dtype=torch.float32)
    return params


def dense_sdpa(q: Tensor, k: Tensor, v: Tensor, real_len: int | None = None) -> Tensor:
    """Non-causal SDPA over ``[B, S, H, D]``: fp32 logits and softmax, probs
    cast to ``v``'s dtype for P·V. Tokens past ``real_len`` form their own
    segment, as the flash path's segment ids make them."""
    d = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (1.0 / d**0.5)
    s = q.shape[1]
    if real_len is not None and real_len < s:
        seg = torch.arange(s, device=q.device) >= real_len
        same = seg[:, None] == seg[None, :]
        logits = torch.where(same[None, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def attention(
    params: dict,
    cfg: AttentionConfig,
    hidden_states: Tensor,
    *,
    rotary: RotaryTables | None = None,
    v0: Tensor | None = None,
    real_len: int | None = None,
) -> tuple[Tensor, Tensor]:
    """``[B, S, E] -> ([B, S, E], v_state [B, S, H, D])``, as device span
    ``attention``; its backward, from the output's gradient to the input's,
    as ``attention.bwd``."""
    with profiling.device_span("attention"):
        out, v = _attention(params, cfg, hidden_states, rotary, v0, real_len)
    profiling.on_grad((out,), begin="attention.bwd")
    profiling.on_grad((hidden_states,), end="attention.bwd")
    return out, v


def _attention(
    params: dict,
    cfg: AttentionConfig,
    hidden_states: Tensor,
    rotary: RotaryTables | None,
    v0: Tensor | None,
    real_len: int | None,
) -> tuple[Tensor, Tensor]:
    b, s, _ = hidden_states.shape
    h, d = cfg.num_heads, cfg.head_dim

    q, k, v = torch.chunk(linear(params["qkv_proj"], hidden_states), 3, dim=-1)
    q = q.reshape(b, s, h, d)
    k = k.reshape(b, s, h, d)
    v = v.reshape(b, s, h, d)

    # The one dispatch by head width: a head wider than the flash kernels
    # take runs dense attention at any length; the fused QK prep (no padding:
    # RMSNorm divides by the width) runs only at the kernel widths.
    flash = use_flash_attention(s) and d <= FLASH_MAX_HEAD_DIM
    fused_prep = cfg.qk_norm and rotary is not None and rotary.cos.shape[-1] * 2 == d
    if flash and fused_prep and d in SUPPORTED_HEAD_DIMS:
        # one fused pass per tensor over the [B, H, S, D] view
        cos, sin = rotary.cos[:s], rotary.sin[:s]
        q = qk_prep(q.transpose(1, 2), cos, sin, cfg.qk_norm_eps).transpose(1, 2)
        k = qk_prep(k.transpose(1, 2), cos, sin, cfg.qk_norm_eps).transpose(1, 2)
    else:
        if cfg.qk_norm:
            q = rms_norm(q, eps=cfg.qk_norm_eps)
            k = rms_norm(k, eps=cfg.qk_norm_eps)
        if rotary is not None:
            # RoPE rotates along the sequence axis of [B, H, S, D]
            q = apply_rope_1d(q.transpose(1, 2), rotary).transpose(1, 2)
            k = apply_rope_1d(k.transpose(1, 2), rotary).transpose(1, 2)

    if cfg.residual_v and v0 is not None:
        if v0.shape != v.shape:
            raise ValueError(f"v0 shape {tuple(v0.shape)} must match value heads {tuple(v.shape)}")
        lam = params["v_residual_lambda"].to(v.dtype)
        v = lam * v + (1.0 - lam) * v0

    if flash:
        attn_output = flash_sdpa(q, k, v, real_len=real_len)
    else:
        attn_output = dense_sdpa(q, k, v, real_len)
    if cfg.gate:
        gate_scores = torch.sigmoid(linear(params["gate_proj"], hidden_states))
        attn_output = attn_output * gate_scores[:, :, None, :]
    out = linear(params["out_proj"], attn_output.reshape(b, s, h * d))
    return out, v
