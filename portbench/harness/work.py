"""The yardstick's arithmetic: peak rates, roofline bounds, and the work of
the step and of its kernels, counted from the configuration's shapes.

Frozen copies of ``chip_smoke.py``'s ``PEAK_FLOPS``, ``HBM_BYTES_PER_S``,
``bound``, ``sampler_flop``, ``KERNEL_NAMES`` and ``graph_pool_gib``, and of
its flash-attention count (one ``[S, S] x D`` product is ``2 B heads S^2
D``), with the step's FLOP count of ``bench.py``'s method written out for
the port's shapes.

The roofline rule: count a function's work once from its shapes, whatever
kernels implement it (no recomputation), each input byte read once and each
output byte written once; hold the work against the fastest tensor-core rate
that takes the function's inputs (bf16 989 TFLOP/s, TF32 495 for fp32
inputs) and the bytes against 3.35 TB/s; the larger time is the bound.
"""

from __future__ import annotations

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet, dense): bf16 and
# TF32 on the tensor cores, fp32 outside them, and device memory.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# each kernel's main device function, by the name the profiler gives it
KERNEL_NAMES = {
    "K1": r"sde_sampler::fwd_(cluster_)?kernel",
    "K2": r"sde_sampler::bptt_(cluster_)?kernel",
    "K3": r"qk_prep::qk_prep_kernel<.*, false>",
    "K4": r"qk_prep::qk_prep_kernel<.*, true>",
    "K5": r"flash::fwd_(wgmma|tf32)_kernel",
    "K6": r"flash::dkv_(wgmma|tf32)_kernel",
    "K7": r"flash::dq_(wgmma|tf32)_kernel",
}

# the peak that an input dtype's fastest tensor-core product runs at
TENSOR_PEAK = {"bfloat16": "bf16", "float32": "tf32"}


def bound(flop: float, n_bytes: float, kind: str) -> dict:
    """The least time the card could take for a function: the larger of its
    ``flop`` at the peak rate of ``kind`` and its ``n_bytes`` (each input
    read once, each output written once) at the memory rate."""
    ops_ms = flop / PEAK_FLOPS[kind] * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flop": flop, "bytes": n_bytes, "peak": kind}


def sampler_flop(d: int, h: int, n_layers: int, n_out: int, batch: int, steps: int) -> tuple[int, int]:
    """FLOP of one K1 and one K2 call, two per multiply-add of their matrix
    products (the elementwise gate math is left out). Per row and step K1 runs
    the L layers' input and hidden gate products and the output projection;
    K2 recomputes the gate products, runs their transposes back (BPTT), sends
    the output cotangent back through the projection, and forms every weight
    gradient (one more of each product)."""
    gates = 2 * 3 * h * (d + h + (n_layers - 1) * 2 * h)
    out = 2 * h * n_out
    rows = batch * steps
    return rows * (gates + out), rows * (3 * gates + 2 * out)


def sampler_work(d: int, h: int, n_layers: int, n_out: int, batch: int, steps: int) -> tuple[float, float]:
    """The path sampler's forward and backward as functions, per call: FLOP
    (``sampler_flop``'s, less K2's recomputed gate products) and bytes (fp32:
    the forward reads ``x0``, the hoisted gates ``[T, B, 3H]``, the noise and
    the weights, and writes the paths, the raw outputs and the hidden states
    it keeps; the backward reads those with the two cotangents and writes
    the gradients of the gates, the noise and the weights)."""
    fwd, bwd = sampler_flop(d, h, n_layers, n_out, batch, steps)
    gates = 2 * 3 * h * (d + h + (n_layers - 1) * 2 * h)
    bwd -= batch * steps * gates
    weights = d * 3 * h + h * 3 * h + 3 * h + (n_layers - 1) * (2 * h * 3 * h + 6 * h) + h * n_out + n_out
    tb = batch * steps
    fwd_bytes = 4 * (batch * d + tb * 3 * h + tb * d + weights + tb * d + tb * n_out + tb * n_layers * h)
    bwd_bytes = 4 * (tb * d + tb * n_out + tb * d + tb * n_layers * h + weights
                     + tb * 3 * h + tb * d + batch * d + weights)
    return float(fwd + bwd), float(fwd_bytes + bwd_bytes)


def flash_product(batch: int, heads: int, seq: int, head_dim: int) -> int:
    """FLOP of one ``[S, S] x D`` product over all heads."""
    return 2 * batch * heads * seq * seq * head_dim


def flash_work(batch: int, heads: int, seq: int, head_dim: int, elem_bytes: int) -> tuple[float, float]:
    """One attention's forward and backward as functions: two products
    forward (``q k^T``, ``P v``), four backward (``dv``, ``dP``, ``dq``,
    ``dk``; no recomputation). Bytes: q, k, v read and o written forward,
    with one fp32 log-sum-exp a row; q, k, v, o, do and the log-sum-exp read
    and dq, dk, dv written backward."""
    flop = 6 * flash_product(batch, heads, seq, head_dim)
    t = batch * heads * seq * head_dim * elem_bytes
    lse = batch * heads * seq * 4
    return float(flop), float(4 * t + lse + 8 * t + lse)


def step_flop(*, batch: int, n_grid: int, hidden: int, cond: int, heads: int, depth: int, mlp_hidden: int,
              param_dim: int, obs_dim: int, n_obs: int, state_dim: int, head_hidden: int, head_layers: int,
              n_out: int) -> float:
    """Model FLOP of one training step: the forward's matrix products, two
    FLOP a multiply-add, times 3 (forward and backward). Counted: the
    observation projection, theta's conditioning MLP, the SiT's input and
    output projections, per block the adaLN modulation, QKV, attention's two
    products, the gate and output projections and the SwiGLU; the head's
    hoisted context and theta projection, each path step's GRU gate
    products and output projection. The ELBO's small solves are left out."""
    s, h = n_grid, hidden
    enc = 2 * n_obs * obs_dim * h
    enc += 2 * batch * (param_dim * cond + 2 * cond * cond)
    enc += 2 * 2 * batch * s * h * h
    per_block = (2 * batch * cond * 6 * h
                 + 2 * batch * s * h * 3 * h
                 + 2 * flash_product(batch, heads, s, h // heads)
                 + 2 * batch * s * h * (h // heads)
                 + 2 * batch * s * h * h
                 + 2 * batch * s * h * 2 * mlp_hidden
                 + 2 * batch * s * mlp_hidden * h)
    enc += depth * per_block
    steps = n_grid - 1
    hh = head_hidden
    head = 2 * batch * steps * h * 3 * hh + 2 * batch * param_dim * 3 * hh
    head += batch * steps * (2 * 3 * hh * (state_dim + hh + (head_layers - 1) * 2 * hh) + 2 * hh * n_out)
    return 3.0 * (enc + head)


def graph_pool_gib(torch, graph) -> float | None:
    """GiB reserved by ``graph``'s private memory pool (the allocator's
    segments of that pool); None where the snapshot does not name pools."""
    segments = torch.cuda.memory._snapshot()["segments"]
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == pool) / 2**30
