#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py spans    # the card, the build and [spans] alone
    python3 chip_smoke.py adaln    # the card, the build and [adaln] alone

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit); TF32 off for matmuls and cuDNN;
2. build the CUDA libraries from ``viforsdes_tpu_torch/csrc/`` (one ``nvcc``
   per source, all at once; cached in ``viforsdes_tpu_torch/_build/``) and
   print the compiler's register and spill report;
3. K1, the path-sampler forward kernel, against its plain PyTorch version,
   at the OU and Lorenz-63 shapes, three ragged ones, the widest head it
   takes (H=256), the 32-dimensional state of ``examples/highdim_ou_dp.py``
   (one row ragged, and the [dp] microbatch) and H=128 (three layers at D=3,
   two at D=1: clusters of 8 and 16, most of whose CTAs own no state
   entry), on each of its plans (the one-block kernel with its weights
   staged in shared memory or streamed, or the cluster kernel, its weights
   split over a thread-block cluster of 2 to 16 CTAs), the card's plan
   equal to its Python mirror (``plan_forward``) at every shape; bitwise
   equal at 1, 2, 4 and the plan's rows a block or cluster, at clusters of
   1, 2, 4 and 8 (Lorenz), 2, 4 and 8 (D=32) and 8 and 16 (H=128), and over
   two runs at the Lorenz shape and the d=32 microbatch;
4. K2, the path-sampler backward kernels, against autograd through the plain
   version, including Cholesky diagonals at and below the clamp and a
   non-zero noise cotangent, on each of its plans (the card's equal to
   ``plan_backward``'s); its gate pass gives K1's gates to the bit (the GRU
   update from its gates equals K1's stashed h); bitwise equal at 1, 2, 4
   and the plan's rows, the cluster BPTT within the bars of the plain
   backward at the cluster sizes K1 runs at, and over two runs at the
   Lorenz shape and the d=32 microbatch;
5. K3/K4, the QK-prep kernels, against their plain versions, at the Lorenz
   shape (q as a strided view of a QKV projection) and two ragged ones;
6. K5, the flash forward, against its plain forward, and K6+K7, the flash
   backward, against the plain backward and against autograd through the
   plain forward, in bf16 and in fp32 (K5-K7 in 3xTF32), at the Lorenz
   shape, ragged shapes, the edges of the tiles (S = 1, 64, 65, 127, 128,
   129, 257: 128-row blocks, 64 at fp32 head_dim 128; S = 17, 33: one row
   past the fp32 K5's kv tiles), ``real_len`` masks (inside a 128-row
   block, inside a streamed tile, inside K7's 64-row kv tile at head_dim
   32), head_dim 32 and 128 and strided q/k/v; K5's, K6's and K7's bf16 and
   fp32 launch plans as the kernels report them against ``flash_plan``; K5
   and K6+K7 twice on the Lorenz inputs, bitwise equal, in bf16 and fp32;
7. every kernel's time beside its plain version's (CUDA events) at the
   shapes of the main paths, its bound (the larger of its operations over the
   card's peak rate for their type and its bytes over the memory rate) and,
   for K5-K7, the time of PyTorch's own flash attention
   (``scaled_dot_product_attention`` pinned to its flash backend) on the same
   inputs as the yardstick, K5-K7 and the library timed in turns (each turn
   runs them in order, then in reverse) before any other attention timing;
   K5-K7 also with fp32 inputs in as many turns (yardstick: the
   memory-efficient backend), each beside both its 3xTF32 bound (495
   TFLOP/s of TF32) and the bound of the same products in fp32 FMA;
   K1/K2 also in microseconds per serial step,
   both at 1, 2 and 4 rows per block, K1 on its streaming plan and both on
   the cluster path at a cluster of one (OU, Lorenz), and both beside their
   bound at the [dp] microbatch (B=1024, T=100, D=32), the
   ``highdim_ou_dp.py`` shape (B=4096, T=500, D=32), the Lorenz shape
   with the widest head (H=256) and the ladder's 128-wide heads (Lorenz r3:
   B=32, T=2000, 128 x 3; highdim r5: B=512, T=100, D=32, 128 x 2); K3/K4
   as the median
   of five windows that each start with a cold L2, then over several such
   sets, each with the SM clock that ``nvidia-smi`` reads after it (their
   spread from set to set within one call); K7 beside its ``mma.sync`` time
   and K6+K7 beside the library backward;
8. the OU path: ``infer()`` at the ``bench.py`` configuration (OU 1-D, batch
   128, 100 path steps, SiT 256 x 4 heads x 8 deep, GRU 64 x 2), then
   ``posterior.summary(n_samples=256)``, with every kernel launch counted (it
   runs no attention kernel: 101 tokens take the dense path); one step's ELBO
   and gradient through the kernels against the plain loop; the step time
   with the kernels and with the plain loop in turns, and a profile;
9. the Lorenz-63 path: observations simulated with ``euler_maruyama``, then
   ``infer()`` at the long-grid configuration (3-D, T=20, dt=0.01: 2001
   tokens, batch 32, SiT 256 x 4 heads x 8 deep, GRU 64 x 2) and
   ``posterior.summary(n_samples=64)`` with the exact launch counts of K1-K7;
   one step's ELBO and gradients through the kernels against the plain path
   (dense attention, unfused QK prep, ``sampler="scan"``) in fp32 and bf16;
   the step time of both in turns with their peak device memory, and a
   profile of the kernel path. ``infer()`` pretrains theta first with
   ``PretrainConfig()`` as ``examples/lorenz63.py`` does (the global sweep
   and CEM, no kernel), and the phase prints that wall time and theta;
10. the examples' path at ``examples/ornstein_uhlenbeck.py``'s configuration
   (batch 128, SiT 256 x 4 x 8, GRU 64 x 2, ``PretrainConfig()``): ``infer()``
   with the console on, 20 steps with a checkpoint every 10, then
   ``summary(500)``, ``diagnostics()``, the summary table, ``plot(30)`` saved
   to a file, ``save`` -> ``load`` (EMA leaves bitwise equal), and
   ``infer(resume_from=)`` the step-10 checkpoint to 20 steps against the
   unbroken ELBO history; the console and the plot need ``rich`` and
   ``matplotlib``, and the phase says so on one line where one is absent;
11. ``[graph]``: several training steps per dispatch as one CUDA graph
   (``steps_per_call``) against one step per dispatch, from the same seed, at
   the OU bench configuration (10 steps a graph, 40 steps) and at the Lorenz
   configuration (5 steps a graph, 15 steps): ELBO histories, params, EMA and
   AdamW moments against the per-step arm (bit equality reported), both
   arms' ms/step in turns and peak memory, and a profile of one replay with
   K1-K7 counted by kernel name (the launch counters count Python calls, so
   under a replay they see only the capture);
12. ``[matched]``: ``infer()`` with ``HeadConfig(cholesky="matched")`` at the
   OU bench configuration, 5 steps and ``summary(64)``: finite ELBOs, no
   path-sampler kernel launched (the mode runs the head's loop, as in the JAX
   package), and ``sampler="pallas"`` refused;
13. ``[fp32]``: the Lorenz-63 configuration with
   ``TrainingConfig(compute_dtype="float32")`` as ``[graph]`` runs it (5
   steps a graph over 15, against one step a call from the same seed):
   finite ELBOs, both arms' ms/step and peak memory, the graph's pool, K5-K7
   ms a step in one profiled replay, and the launches of both ``train()``
   runs (K5-K7 in 3xTF32; it fails if K5, K6 or K7 ran no time);
14. ``[repairs]``: ``attention()`` at S=2001 in bf16 at head widths 16 and
   48 (K5-K7 zero-padded to 32 and 64) and 256 (the dense path), forward
   and backward against the plain path within the bf16 bars, K3-K7
   counted; one Lorenz ``infer()`` step with ``EncoderConfig(hidden_dim=64,
   num_heads=4)``; then ``[head320]``: ``HeadConfig(hidden_dim=320)`` under
   ``sampler="auto"`` trains 2 OU steps on the card through the plain loop,
   and ``sampler="pallas"`` at that width is refused;
15. ``[ladder]``: the quality ladder's sampler shapes (Lorenz-63 round 3:
   B=32, T=2000, D=3, head 128 x 3; highdim round 5: B=512, T=100, D=32,
   head 128 x 2; SIR: B=64, T=400, D=2; LV: B=24, T=400, D=2), K1 and K2
   against the plain version on the plan the card picks (equal to its
   mirror); then every rung of ``examples_torch/quality_eval.py`` (OU
   synthetic, SIR, LV, highdim round 5, Lorenz-63 round 3) at its committed
   recipe and full width through the harness's own function: its real
   pretraining, then 20 steps in CUDA graphs of 10, finite ELBOs, K1/K2
   launched on every rung and K3-K7 on Lorenz-63 only, the result's keys
   those of the JAX package's committed result, its ms/step over replays of
   the graph, pretraining seconds and peak memory; then the ``main()`` of
   the OU, LV, SIR and Lorenz-63 examples (``examples_torch/``) at their own
   configuration, cut to 3 steps (``highdim_ou_dp``'s batch of 4096 in one
   pass does not fit one card: ``[dp]`` trains it in microbatches);
16. ``[lv bf16]``: one step of the LV rung's problem at its full width
   (SiT 256 x 4 x 8, GRU 64 x 2, 401 tokens, batch 24; ``tools/lv_step.py``)
   on one set of weights and draws, in bf16 and fp32 on the card (K1/K2
   launched, no attention kernel) and on the CPU (the plain path): each
   side's bf16 ELBO and gradient against its own fp32 step, in total and per
   leaf, and ``allow_bf16_reduced_precision_reduction``; it fails if the
   card's error exceeds the CPU's by more than ``LV_BF16_BAR`` times in
   total, over the encoder or on any leaf above its floor
   (``lv_bf16_failures``), or if the card's fp32 step leaves the CPU's;
17. ``[dp]``: data-parallel training (``parallel/``) at
   ``examples/highdim_ou_dp.py``'s configuration (d=32, batch 4096, SiT
   256 x 4 x 8, GRU 64 x 2), cut to 10 steps in graphs of 5 and to 4
   microbatches a step: ``infer(mesh=make_data_mesh())`` on a world of one
   process over NCCL (the all-reduces captured inside the graphs), then
   ``infer(mesh=None)`` from the same seed, bitwise equal in history, params,
   EMA and moments; each arm's ms/step (replayed windows), peak memory and
   graph pool; K1/K2 and NCCL kernels counted in a profile of one replay;
   ``summary(500)``, ``diagnostics()`` and ``save`` -> ``load`` on the mesh
   arm. Then two ranks sharing the card over gloo (spawned, ``FileStore``) at
   the OU bench configuration, with the batch split in two and with 3
   importance groups a microbatch (2 on one rank, 1 on the other), each
   against the run without a mesh: ELBO within ``ELBO_RTOL``, params within
   the backward bars, the ranks bitwise equal, and ``steps_per_call=5``
   refused on that mesh (semantics, not speed);
18. ``[spans]``: the device spans (``utils/profiling.py``) at each
   benchmark cell's shapes (``portbench/``: Lorenz-63 r3 bf16 and fp32,
   highdim r5 bf16; the benchmark's weights from one seed), a trainer with
   spans on and one with them off: after the first chunk (eager, then
   captured) and one replay the state of both bitwise equal; the graph's
   nodes with spans on less those with them off equal to its markers; one
   replay traced, each span begun and ended once a step and microbatch
   (attention once a block), and ``device_span_ms`` from the ring within
   ``SPAN_RING_BAR`` of the trace's marker times per family; the step's
   split by span (kernel ms and launches, ``portbench/harness/spans.py``);
   ms a step with spans on and off in turns (on, off, off, on);
19. ``[adaln]``: the SiT's fused norm site (``ops/adaln_norm.py``) at both
   cells' shapes ([32, 2001, 256] and [512, 101, 256]), bf16 and fp32, with
   and without a residual: x_new bitwise the eager composition's, m bitwise
   the composition's given the kernel's row statistics, which lie within
   1e-5 of the eager ones, and within 2 ulps of the eager m in bf16 (one
   in all but the rows where a rounded statistic flips; 16 in fp32, whose
   statistics are not rounded); the backward against the
   plain VJP and fp32 autograd; two runs bitwise equal; the forward's and
   the backward's time against their byte bound beside the eager
   composition's; in each cell's trainer (the benchmark's harness) 16
   forward and 16 backward launches a SiT call through the first chunk, and
   the kernels of one profiled replay by name, with their device ms.

The card's ``nvidia-smi`` line (name, power limit) is printed again just
before the results. The line before the last is ``{"kernels": [...]}`` with
each kernel's launches in the Lorenz path (K5-K7 with fp32 inputs: in
``[fp32]``), its largest error against the
plain version, and its time beside the plain version's, its bound and the
library call's at the Lorenz shapes (``library_ms`` null where no single
PyTorch call computes the function); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's configuration (the OU path)
BATCH, DT, HORIZON = 128, 0.05, 5.0
ENC = dict(hidden_dim=256, cond_dim=256, num_heads=4, depth=8)
HEAD = dict(hidden_dim=64, num_layers=2)
OU_STEPS = 25   # infer() training steps (K1: 25 + 1 sampling launch, K2: 25)
OU_TIMED = 10   # steps per arm of the timing phase, in two turns

# examples/lorenz63.py's configuration (the long-grid path)
LZ_BATCH, LZ_DT, LZ_HORIZON, LZ_OBS_EVERY = 32, 0.01, 20.0, 0.5
LZ_TRUE = (10.0, 28.0, 8.0 / 3.0)
LZ_STEPS = 3          # infer() training steps
LZ_SAMPLES = 64       # posterior.summary draws (one chunk)
LZ_TIMED = 2          # steps per turn of the timing phase

# Tolerances on the card, elementwise |kernel - plain| <= rtol*|plain| +
# atol*max|plain|. Both sides are fp32 but sum in other orders (cuBLAS vs the
# kernels' FMA chains) over 100 dependent steps, and the weight gradients sum
# 12800 rows, so the bars sit above the CPU tests' 1e-5 / 1e-4.
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4
ELBO_RTOL = 1e-4  # the ELBO bar of tests/test_reference_parity.py
# bf16 attention: max |err| <= bar * max|ref| (tests/test_flash_attention.py's
# bars on the TPU), and the bf16 ELBO bar of tests/test_torch_elbo.py.
BF16_FWD, BF16_BWD = 2e-2, 3e-2
BF16_ELBO = 2e-2

# K5-K7 at the Lorenz shape before they ran wgmma (ms; PERF.md, the
# mma.sync kernels on an NVIDIA H100 80GB HBM3 at 700 W), printed beside
# this run's times.
MMA_SYNC_MS = {"K5": 0.883, "K6": 1.547, "K7": 1.074}

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet, dense): bf16 and
# TF32 on the tensor cores, fp32 outside them, and device memory. The fp32
# K5-K7 run each product as three TF32 products (3xTF32): their bound counts
# 3x the products at the TF32 rate.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card(torch) -> tuple[str, str]:
    """The card's name and power limit as ``nvidia-smi`` gives them, and
    ``torch.cuda.get_device_name(0)``."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    torch.cuda.synchronize()
    return smi, torch.cuda.get_device_name(0)


def phase_build(torch) -> None:
    from viforsdes_tpu_torch.ops.kernel_build import LIBRARIES

    def build(lib):
        t0 = time.perf_counter()
        lib.get()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        seconds = list(pool.map(build, LIBRARIES))
    for lib, s in zip(LIBRARIES, seconds):
        log(f"[build] {lib.name} library ready in {s:.1f} s")
        for line in lib.report().read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "wgmma")):
                log(f"[ptxas] {line.strip()}")
    torch.cuda.synchronize()


def max_err(a, ref, rtol: float, atol: float, what: str, atol_floor: float = 1.0) -> float:
    """Largest |a - ref|, checked elementwise against rtol*|ref| +
    atol*max(atol_floor, max|ref|)."""
    import torch

    a, ref = a.detach().double(), ref.detach().double()
    if a.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(a.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (a - ref).abs()
    bound = rtol * ref.abs() + atol * max(atol_floor, float(ref.abs().max()))
    if bool((err > bound).any()):
        raise AssertionError(
            f"{what}: max |err| {float(err.max()):.3e} exceeds the tolerance "
            f"(rtol {rtol}, atol {atol}); max |ref| {float(ref.abs().max()):.3e}"
        )
    return float(err.max())


def check_close(a, ref, dtype, fp32_bars, bf16_bar: float, what: str, floor: float = 0.0) -> float:
    """fp32: rtol/atol of ``fp32_bars`` (atol times max|ref|); bf16: max |err|
    at most ``bf16_bar`` * max|ref|. ``floor`` is the least max|ref| the atol
    scales with."""
    import torch

    if dtype == torch.bfloat16:
        return max_err(a, ref, 0.0, bf16_bar, what, atol_floor=floor)
    return max_err(a, ref, *fp32_bars, what, atol_floor=floor)


def sampler_case(torch, B, T, D, H, L, cholesky, seed, clamp_cases=False, dt=DT, on_card=False):
    """Weights and streams for one sampler shape, on the card; ``on_card``
    draws the streams there (large shapes), else on the host."""
    from viforsdes_tpu_torch.config import HeadConfig
    from viforsdes_tpu_torch.inference.constants import DIAG_MIN
    from viforsdes_tpu_torch.models.head import DiffusionTransitionHead
    from viforsdes_tpu_torch.ops.sde_sampler import prep_weights, tril_indices

    gen = torch.Generator().manual_seed(seed)
    head = DiffusionTransitionHead(D, 8, 3, HeadConfig(hidden_dim=H, num_layers=L, cholesky=cholesky))
    params = head.init(gen)
    params["out_proj"]["w"] = 0.1 * torch.randn(params["out_proj"]["w"].shape, generator=gen)
    if clamp_cases:
        rows, cols = tril_indices(D, cholesky)
        diag_out = [D + k for k in range(len(rows)) if rows[k] == cols[k]]
        # raw exactly at the clamp on the first diagonal, below it on the second
        params["out_proj"]["w"][:, diag_out[0]] = 0.0
        params["out_proj"]["b"][diag_out[0]] = DIAG_MIN
        params["out_proj"]["b"][diag_out[1]] = -0.5
    spec = head.spec(dt)
    w = prep_weights(spec, params)
    w = type(w)(*(t.cuda().contiguous() for t in w))
    sgen = torch.Generator(device="cuda").manual_seed(seed) if on_card else gen

    def randn(*shape):
        return torch.randn(shape, generator=sgen, device=sgen.device).cuda()

    x0, gc, eps = randn(B, D), randn(T, B, 3 * H), randn(T, B, D)
    cot = (randn(B, T + 1, D), randn(B, T, D), randn(B, T, spec.n_tril))
    return spec, w, x0, gc, eps, cot


def nbytes(*items) -> int:
    """Bytes of the tensors in ``items``, walking tuples, lists and
    NamedTuples and skipping anything else."""
    import torch

    total = 0
    for x in items:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
    return total


def bound(flop: float, n_bytes: int, kind: str) -> dict:
    """The least time the card could take for a function: the larger of its
    ``flop`` at the peak rate of ``kind`` and its ``n_bytes`` (each input
    read once, each output written once) at the memory rate."""
    ops_ms = flop / PEAK_FLOPS[kind] * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flop": flop, "bytes": n_bytes, "peak": kind}


def sampler_flop(spec, batch: int, steps: int) -> tuple[int, int]:
    """FLOP of one K1 and one K2 call, two per multiply-add of their matrix
    products (the elementwise gate math is left out). Per row and step K1 runs
    the L layers' input and hidden gate products and the output projection;
    K2 recomputes the gate products, runs their transposes back (BPTT), sends
    the output cotangent back through the projection, and forms every weight
    gradient (one more of each product)."""
    d, h, n_layers, n_out = spec.state_dim, spec.hidden_dim, spec.num_layers, spec.n_out
    gates = 2 * 3 * h * (d + h + (n_layers - 1) * 2 * h)
    out = 2 * h * n_out
    rows = batch * steps
    return rows * (gates + out), rows * (3 * gates + 2 * out)


def us_per_step(ms: float, steps: int) -> float:
    """Microseconds per serial time step of a sampler call of ``ms``."""
    return ms * 1e3 / steps


def cuda_ms(torch, fn, n: int, warm_s: float = 0.1) -> float:
    """ms per call of ``fn`` over ``n`` calls (CUDA events), after calling it
    for at least ``warm_s`` seconds so that the card's clocks have risen."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


COLD_WINDOWS = 5
COLD_FLUSH_BYTES = 128 << 20  # more than the H100's 50 MB L2


def cold_windows_ms(torch, fn, n: int) -> list[float]:
    """ms per launch of ``fn`` over ``COLD_WINDOWS`` windows of ``n``
    launches (CUDA events), each window after a write of
    ``COLD_FLUSH_BYTES``, so that it starts with a cold L2."""
    fn()
    flush = torch.empty(COLD_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for i in range(COLD_WINDOWS):
        flush.fill_(float(i))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / n)
    return out


SHAPES = [  # (B, T, D, H, L, cholesky, clamp_cases, dt)
    (BATCH, 100, 1, 64, 2, "full", False, DT),          # the OU path's shape
    (LZ_BATCH, 2000, 3, 64, 2, "full", False, LZ_DT),   # the Lorenz path's shape
    (37, 7, 3, 32, 3, "full", True, DT),                # ragged tile, tril, three layers
    (16, 9, 2, 16, 1, "diag", True, DT),                # diag mode, one layer
    # H=64 with three layers: K1's and K2's packed weights exceed a block's
    # shared memory, so both split them over a cluster of 2
    (24, 40, 3, 64, 3, "full", True, DT),
    # H=96: K1's build for more than 8 warps of units (64 registers a thread)
    (9, 11, 2, 96, 2, "full", True, DT),
    # H=256: 32 warps of units fill 1024 threads, the last one also runs the
    # output phase; K2's gate pass takes 16 rows a block
    (6, 5, 3, 256, 2, "full", True, DT),
    # D=32 (examples/highdim_ou_dp.py: 528 tril values, 560 outputs a row)
    (48, 20, 32, 64, 2, "full", False, DT),
    (13, 7, 32, 64, 2, "full", True, DT),
    # the [dp] path's microbatch: batch 4096 in 4 microbatches on one card
    (1024, 100, 32, 64, 2, "full", False, DT),
    # H=128 (the ladder's Lorenz r3 head, 128 x 3): clusters of 8, five of
    # whose CTAs own no state entry; then D=1 at 128 x 2, where a cluster of
    # 16 leaves fifteen without one
    (10, 30, 3, 128, 3, "full", True, LZ_DT),
    (7, 12, 1, 128, 2, "full", False, DT),
]
# rows of SHAPES run twice (the same bits): the Lorenz shape and the d=32 microbatch
TWICE = (1, 9)
# rows of SHAPES whose K1 runs at other cluster sizes too (bitwise equal, and
# within the bars), and whose K2 does (within the bars: its owners add C parts)
CLUSTER_CHECKS = {1: (1, 2, 4, 8), 7: (2, 4, 8), 10: (8, 16), 11: (8, 16)}

# more sampler shapes for [times]/[steps], timed beside their bound:
# label -> (B, T, D, H, L, dt)
WIDE_SHAPES = {
    "d32": (1024, 100, 32, 64, 2, DT),            # the [dp] path's microbatch (4 a step)
    "highdim": (4096, 500, 32, 64, 2, DT),        # examples/highdim_ou_dp.py on one card
    "h256": (LZ_BATCH, 2000, 3, 256, 2, LZ_DT),   # the Lorenz shape with K1's widest head
    "lorenz_r3": (LZ_BATCH, 2000, 3, 128, 3, LZ_DT),  # the ladder's Lorenz r3 head (clusters of 8)
    "highdim_r5": (512, 100, 32, 128, 2, DT),     # the ladder's highdim r5 head (clusters of 8 and 16)
}


def same_bits(outs, what: str) -> None:
    """Every output of ``outs`` (name -> tuple of tensors or None) equals the
    first's, bit for bit."""
    import torch

    names = list(outs)
    for other in names[1:]:
        for a, b in zip(outs[names[0]], outs[other]):
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                raise AssertionError(f"{what}: {names[0]} and {other} differ")


def plan_text(plan) -> str:
    from viforsdes_tpu_torch.ops.sde_sampler import PATH_NAMES

    return (f"{PATH_NAMES[plan.path]}, cluster {plan.cluster}, {plan.rows} rows, {plan.threads} threads, "
            f"{plan.smem_bytes} B shared")


def row_choices(plan) -> list[int]:
    """Rows a block (a cluster) to run a plan's path at for the bitwise
    check: 1, 2, 4 and, on the cluster path, the plan's own."""
    return sorted({1, 2, 4, plan.rows})


def device_limits(torch) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(0)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def check_plan(plan, mirror, what: str) -> None:
    """The card's plan (``make_fwd_plan`` / ``make_bwd_plan``) against its
    Python mirror."""
    if plan != mirror:
        raise AssertionError(f"{what}: the card's plan {plan} differs from the mirror's {mirror}")


def phase_forward(torch) -> float:
    """K1 against the plain loop at every ``SHAPES`` row, on the plan by
    shape (the card's plan equal to ``plan_forward``'s); K1 on that path at
    1, 2, 4 and the plan's rows a block or cluster gives the same bits
    (paths, raw, h_all: each row's arithmetic does not depend on its block);
    the cluster kernel at the clusters of ``CLUSTER_CHECKS`` gives the same
    bits (1 to 8 at the Lorenz shape, 2 to 8 at D=32, 8 and 16 at H=128,
    where D < C leaves CTAs without a state entry); two runs give the same
    bits at the Lorenz shape and at the d=32 microbatch; the rows cover the
    staged, the streaming and the cluster plan."""
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    n_sms, optin = device_limits(torch)
    worst = 0.0
    paths_seen = set()
    for i, (B, T, D, H, L, chol, clamp, dt) in enumerate(SHAPES):
        spec, w, x0, gc, eps, _ = sampler_case(torch, B, T, D, H, L, chol, 10 + i, clamp, dt)
        dev = torch.cuda.current_device()
        plan = ss.forward_plan(spec, B, dev)
        check_plan(plan, ss.plan_forward(spec, B, n_sms, optin, ss.cluster_slots(spec, dev)["fwd"]),
                   f"K1 {SHAPES[i]}")
        paths_seen.add(plan.path)
        for save_h in (False, True):
            out = ss.sampler_forward(spec, w, x0, gc, eps, save_h=save_h)
            ref = ss._forward_plain(spec, w, x0, gc, eps, save_h=save_h)
            torch.cuda.synchronize()
            for name in ("paths", "raw", "chol_vals", "h_all"):
                a, r = getattr(out, name), getattr(ref, name)
                if a is None and r is None:
                    continue
                e = max_err(a, r, FWD_RTOL, FWD_ATOL, f"K1 {name} {SHAPES[i]}")
                worst = max(worst, e)
        rows = row_choices(plan)
        by_rows = {r: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True, path=plan.path, cluster=plan.cluster,
                                       rows=r) for r in rows}
        torch.cuda.synchronize()
        same_bits({f"rows={r}": (o.paths, o.raw, o.h_all) for r, o in by_rows.items()}, f"K1 {SHAPES[i]}")
        log(f"[K1] B={B} T={T} D={D} H={H} L={L} {chol}: max |err| so far {worst:.3e}; plan {plan_text(plan)} "
            f"(the mirror's); rows {rows} bitwise equal")
        clusters = CLUSTER_CHECKS.get(i, ())
        if clusters:  # the cluster kernel at other cluster sizes: the same bits
            by_c = {c: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True, path=ss.PATH_CLUSTER, cluster=c)
                    for c in clusters}
            torch.cuda.synchronize()
            same_bits({f"cluster={c}": (o.paths, o.raw, o.h_all) for c, o in by_c.items()}, f"K1 {SHAPES[i]}")
            for name in ("paths", "raw", "h_all"):
                worst = max(worst, max_err(getattr(by_c[clusters[0]], name), getattr(ref, name), FWD_RTOL,
                                           FWD_ATOL, f"K1 cluster {name} {SHAPES[i]}"))
            log(f"[K1] B={B} T={T} D={D}: the cluster kernel at clusters of {clusters} bitwise equal, within the bars")
        if i in TWICE:  # a second run, the same bits
            again = ss._forward_cuda(spec, w, x0, gc, eps, save_h=True)
            first = by_rows[plan.rows]
            torch.cuda.synchronize()
            same_bits({"run 1": (first.paths, first.raw, first.h_all),
                       "run 2": (again.paths, again.raw, again.h_all)}, f"K1 {SHAPES[i]}")
            log(f"[K1] B={B} T={T} D={D}: two runs bitwise equal in paths, raw, h_all")
    want = {ss.PATH_STAGED, ss.PATH_STREAMING, ss.PATH_CLUSTER}
    if paths_seen != want:
        raise AssertionError(f"K1: SHAPES took only the paths {sorted(paths_seen)}")
    return worst


def fma_gru_update(torch, z, h_prev, n):
    """``fmaf(z, h_prev, (1 - z) * n)`` in fp32 with one rounding, as the
    kernels' GRU update: z * h_prev is exact in fp64, the sum's error comes
    from TwoSum, and a sum that falls exactly between two floats rounds
    toward its error."""
    p = ((1.0 - z) * n).double()
    a = z.double() * h_prev.double()
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)
    r = s.float()
    inf = torch.full_like(r, math.inf)
    lo = torch.where(r.double() <= s, r, torch.nextafter(r, -inf))
    hi = torch.nextafter(lo, inf)
    tie = s == (lo.double() + hi.double()) / 2
    return torch.where(tie & (err > 0), hi, torch.where(tie & (err < 0), lo, r))


def check_gates_match(torch, spec, h_all, acts, what: str) -> None:
    """K2's gate pass (``acts``: r, z, n of every step and layer) gives K1's
    gates to the bit: the GRU update from its z and n and the stashed
    h_{t-1} equals K1's h_t (``h_all``) in every bit."""
    h, n_layers = spec.hidden_dim, spec.num_layers
    for l in range(n_layers):
        z, n = acts[l, ..., h : 2 * h], acts[l, ..., 2 * h : 3 * h]
        h_t = h_all[..., l * h : (l + 1) * h]
        h_prev = torch.cat([torch.zeros_like(h_t[:1]), h_t[:-1]])
        bad = int((fma_gru_update(torch, z, h_prev, n) != h_t).sum())
        if bad:
            raise AssertionError(f"{what}: K2's gates differ from K1's at layer {l} ({bad} values of h)")


def sampler_grads(torch, sample_fn, spec, w, x0, gc, eps, cot) -> list:
    """Gradients of x0, the gate constants, the noise and every weight
    through ``sample_fn`` (the kernels or the plain loop) for the cotangents
    ``cot``; zeros where an input is unused."""
    from viforsdes_tpu_torch.ops.sde_sampler import SamplerWeights

    ins = [t.clone().requires_grad_() for t in (x0, gc, eps, *w)]
    outs = sample_fn(spec, SamplerWeights(*ins[3:]), *ins[:3])
    got = torch.autograd.grad(outs, ins, grad_outputs=cot, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(ins, got)]


def phase_backward(torch) -> float:
    """K2 against autograd through the plain loop at every ``SHAPES`` row,
    on the plan by shape (the card's plan equal to ``plan_backward``'s);
    K2's gate pass gives K1's gates to the bit; K2's BPTT at 1, 2, 4 and the
    plan's rows a block or cluster gives the same bits (each row's arithmetic
    does not depend on its block); the cluster BPTT at the clusters of
    ``CLUSTER_CHECKS`` within the bars of the plain backward; two runs give
    the same bits at the Lorenz shape and at the d=32 microbatch; the rows
    cover the staged, the streaming and the cluster path."""
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    n_sms, optin = device_limits(torch)
    worst = 0.0
    paths_seen = set()
    fields = ("d_gc", "d_eps", "d_x0", *ss.SamplerWeights._fields)
    for i, (B, T, D, H, L, chol, clamp, dt) in enumerate(SHAPES):
        spec, w, x0, gc, eps, cot = sampler_case(torch, B, T, D, H, L, chol, 20 + i, clamp, dt)
        dev = torch.cuda.current_device()
        plan = ss.backward_plan(spec, B, dev)
        check_plan(plan, ss.plan_backward(spec, B, n_sms, optin, ss.cluster_slots(spec, dev)["bwd"]),
                   f"K2 {SHAPES[i]}")
        paths_seen.add(plan.path)

        def grads(sample_fn):
            return sampler_grads(torch, sample_fn, spec, w, x0, gc, eps, cot)

        got = grads(ss.sample_paths)
        ref = grads(ss.sample_paths_scan)
        torch.cuda.synchronize()
        names = ["x0", "gates_const", "eps", *ss.SamplerWeights._fields]
        for name, a, r in zip(names, got, ref):
            if a.numel() == 0:
                continue
            worst = max(worst, max_err(a, r, BWD_RTOL, BWD_ATOL, f"K2 d_{name} {SHAPES[i]}"))
        if float(got[2].abs().max()) == 0.0:
            raise AssertionError("K2: the noise cotangent is zero")

        # K1's gates in K2's gate pass; the same call at each rows choice: bitwise equal
        fwd = ss.sampler_forward(spec, w, x0, gc, eps, save_h=True)
        tmaj = [c.transpose(0, 1).contiguous() for c in (cot[0][:, 1:], cot[1], cot[2])]
        acts = torch.empty((L, T, B, 4 * H), device="cuda")
        ss._backward_cuda(spec, w, x0, gc, eps, fwd, *tmaj, acts=acts)
        torch.cuda.synchronize()
        check_gates_match(torch, spec, fwd.h_all, acts, f"K2 {SHAPES[i]}")
        rows = row_choices(plan)
        by_rows = {r: ss._backward_cuda(spec, w, x0, gc, eps, fwd, *tmaj, path=plan.path, cluster=plan.cluster,
                                        rows=r) for r in rows}
        torch.cuda.synchronize()
        same_bits({f"rows={r}": (*g[:3], *g.weights) for r, g in by_rows.items()}, f"K2 {SHAPES[i]}")
        log(f"[K2] B={B} T={T} D={D} H={H} L={L} {chol}: max |err| so far {worst:.3e}; plan {plan_text(plan)} "
            f"(the mirror's); K1's gates to the bit; rows {rows} bitwise equal")
        if i in CLUSTER_CHECKS:  # the cluster BPTT at other cluster sizes: within the bars of the plain backward
            plain = ss._backward_plain(spec, w, x0, gc, eps, fwd, *tmaj)
            for c in CLUSTER_CHECKS[i]:
                g = ss._backward_cuda(spec, w, x0, gc, eps, fwd, *tmaj, path=ss.PATH_CLUSTER, cluster=c)
                torch.cuda.synchronize()
                for name, a, r in zip(fields, (*g[:3], *g.weights), (*plain[:3], *plain.weights)):
                    worst = max(worst, max_err(a, r, BWD_RTOL, BWD_ATOL, f"K2 cluster={c} {name} {SHAPES[i]}"))
            log(f"[K2] B={B} T={T} D={D} H={H}: the cluster BPTT at clusters of {CLUSTER_CHECKS[i]} within the "
                f"bars")
        if i in TWICE:  # a second run gives the same bits
            again = grads(ss.sample_paths)
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"K2 d_{name} {SHAPES[i]}: two runs differ")
            log(f"[K2] B={B} T={T} D={D}: two runs bitwise equal in every gradient")
    want = {ss.PATH_STAGED, ss.PATH_STREAMING, ss.PATH_CLUSTER}
    if paths_seen != want:
        raise AssertionError(f"K2: SHAPES took only the paths {sorted(paths_seen)}")
    return worst


def lorenz_heads(torch, shape, dtype, seed: int):
    """q, k, v as the Lorenz path's attention sees them: strided [B, H, S, D]
    views of one [B, S, 3E] projection output."""
    b, h, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    return [t.reshape(b, s, h, d).transpose(1, 2) for t in torch.chunk(qkv, 3, dim=-1)]


def dense_heads(torch, shape, dtype, seed: int, n: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(n)]


def rope_tables(torch, s: int, d: int):
    from viforsdes_tpu_torch.ops.embeddings import precompute_rope

    tables = precompute_rope(d, end=max(2048, s)).slice_to(s).to("cuda")
    return tables.cos, tables.sin


QK_CASES = [  # (shape, dtype name, strided like the main path)
    ((LZ_BATCH, 4, 2001, 64), "bfloat16", True),
    ((2, 3, 77, 64), "float32", False),
    ((1, 2, 1000, 32), "float32", False),
]


def phase_qk_prep(torch) -> tuple[float, float]:
    from viforsdes_tpu_torch.ops import qk_prep as qp

    worst_f = worst_b = 0.0
    for i, (shape, dname, strided) in enumerate(QK_CASES):
        dtype = getattr(torch, dname)
        if strided:
            x = lorenz_heads(torch, shape, dtype, 40 + i)[0]
        else:
            x = dense_heads(torch, shape, dtype, 40 + i, 1)[0]
        dy = dense_heads(torch, shape, dtype, 50 + i, 1)[0]
        cos, sin = rope_tables(torch, shape[2], shape[3])
        out = qp.qk_prep_forward(x, cos, sin, 1e-6)
        ref = qp._forward_plain(x, cos, sin, 1e-6)
        dx = qp.qk_prep_backward(x, cos, sin, dy, 1e-6)
        dx_ref = qp._backward_plain(x, cos, sin, dy, 1e-6)
        torch.cuda.synchronize()
        worst_f = max(worst_f, check_close(out, ref, dtype, (FWD_RTOL, FWD_ATOL), BF16_FWD, f"K3 {shape} {dname}"))
        worst_b = max(worst_b, check_close(dx, dx_ref, dtype, (FWD_RTOL, FWD_ATOL), BF16_BWD, f"K4 {shape} {dname}"))
        log(f"[K3/K4] {shape} {dname}{' strided' if strided else ''}: "
            f"max |err| so far {worst_f:.3e} / {worst_b:.3e}")
    return worst_f, worst_b


FLASH_CASES = [  # (shape, dtype name, real_len, strided like the main path)
    ((LZ_BATCH, 4, 2001, 64), "bfloat16", None, True),
    ((2, 3, 77, 64), "float32", None, False),
    ((1, 2, 1000, 64), "float32", 700, False),
    ((2, 4, 333, 32), "float32", 250, False),
    ((2, 4, 333, 128), "float32", None, False),
    ((2, 4, 333, 128), "bfloat16", 300, False),
    # edges of the bf16 tiles: K5-K7 own 128 rows a block (two 64-row
    # warpgroups) and stream 128/64/32-row tiles (K7: 64, 32 at head_dim
    # 128): one row, one 64-row tile, one row past it; one row short of a
    # 128-row block, one block, one row past it, two blocks and a row
    ((2, 4, 1, 64), "bfloat16", None, False),
    ((2, 4, 64, 64), "bfloat16", None, False),
    ((2, 4, 65, 64), "bfloat16", None, False),
    ((2, 4, 127, 64), "bfloat16", None, False),
    ((2, 4, 128, 64), "bfloat16", None, False),
    ((2, 4, 129, 64), "bfloat16", None, False),
    ((2, 4, 257, 64), "bfloat16", None, True),
    ((2, 4, 129, 128), "bfloat16", None, False),
    ((2, 4, 2001, 64), "bfloat16", 1500, False),
    ((2, 4, 333, 32), "bfloat16", None, False),
    ((2, 4, 257, 32), "bfloat16", 200, True),
    ((2, 4, 200, 128), "bfloat16", None, True),
    ((2, 4, 333, 64), "bfloat16", 250, True),
    # real_len splitting a 128-row block (300 = 2 * 128 + 44) at head_dim 64
    ((2, 4, 700, 64), "bfloat16", 300, True),
    # real_len inside a 64-row tile (1000 = 15 * 64 + 40) at head_dim 128
    ((2, 4, 2001, 128), "bfloat16", 1000, False),
    # real_len inside K7's second 64-row kv tile (100 = 64 + 36) at head_dim
    # 32, S one row past four such tiles
    ((2, 4, 257, 32), "bfloat16", 100, False),
    # the 3xTF32 kernels (fp32 K6/K7): the Lorenz shape; 128-row blocks
    # streaming 16-row tiles at head_dim 64 (32 at 32; 64-row blocks and
    # 8-row tiles at 128): one row, one and two 64-row warpgroups and a row
    # past each, a row short of a block, two blocks and a row
    ((LZ_BATCH, 4, 2001, 64), "float32", None, True),
    ((2, 4, 1, 64), "float32", None, False),
    ((2, 4, 64, 64), "float32", None, False),
    ((2, 4, 65, 64), "float32", None, False),
    ((2, 4, 127, 64), "float32", None, False),
    ((2, 4, 128, 64), "float32", None, False),
    ((2, 4, 129, 64), "float32", None, True),
    ((2, 4, 257, 64), "float32", None, True),
    # real_len splitting a 128-row block (300 = 2 * 128 + 44), and inside a
    # 16-row q/kv tile (250 = 15 * 16 + 10), at head_dim 64
    ((2, 4, 700, 64), "float32", 300, True),
    ((2, 4, 333, 64), "float32", 250, True),
    # head_dim 32 (32-row tiles; 100 inside the fourth) and 128 (64-row
    # blocks; 100 = 12 * 8 + 4 inside an 8-row tile and a block)
    ((2, 4, 257, 32), "float32", 100, True),
    ((2, 4, 65, 128), "float32", None, False),
    ((2, 4, 129, 128), "float32", None, True),
    ((2, 4, 200, 128), "float32", 100, True),
    # the 3xTF32 K5 streams 32-row kv tiles at head_dim 32 and 64 and 16-row
    # ones at 128 (real_len inside such a tile: 250, 100 and 100 above): S
    # one row past a kv tile at each width, and one row past a 128-row block
    # at head_dim 32 (129 at 64 and 65 at 128 are above)
    ((2, 4, 33, 64), "float32", None, False),
    ((2, 4, 33, 32), "float32", None, True),
    ((2, 4, 129, 32), "float32", None, False),
    ((2, 4, 17, 128), "float32", None, False),
]
LORENZ_SHAPE = (LZ_BATCH, 4, 2001, 64)


def phase_flash_plan(torch) -> None:
    """K5's, K6's and K7's bf16 and fp32 launch plans as the kernels report
    them equal ``flash_plan``, the Python mirror the CPU tests check."""
    import ctypes

    from viforsdes_tpu_torch.ops import flash_attention as fa
    from viforsdes_tpu_torch.ops.kernel_build import ATTENTION, raise_on

    lib = ATTENTION.get()
    plans = []
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = int(dtype == torch.bfloat16)
        plans.append(("fwd", dtype, lambda d, out, bf16=bf16: lib.flash_attn_fwd_plan(d, bf16, out)))
        plans.append(("dkv", dtype, lambda d, out, bf16=bf16: lib.flash_attn_bwd_plan(d, 0, bf16, out)))
        plans.append(("dq", dtype, lambda d, out, bf16=bf16: lib.flash_attn_bwd_plan(d, 1, bf16, out)))
    for kernel, dtype, fn in plans:
        for d in (32, 64, 128):
            out = (ctypes.c_longlong * 5)()
            raise_on(fn(d, out), f"flash plan {kernel} D={d} {dtype}")
            got, want = fa.FlashPlan(*out), fa.flash_plan(kernel, d, dtype)
            if got != want:
                raise AssertionError(f"flash plan {kernel} D={d} {dtype}: kernel {got}, flash_plan {want}")
            log(f"[K5-K7] plan {kernel} D={d} {dtype}: {got}")


def phase_flash(torch) -> dict:
    """``FLASH_CASES``: the largest error of K5, K6 and K7 by input dtype
    ("K6" for bf16, "K6 fp32" for the 3xTF32 kernels)."""
    from viforsdes_tpu_torch.ops import flash_attention as fa

    worst = {f"K{n}{sfx}": 0.0 for n in (5, 6, 7) for sfx in ("", " fp32")}
    for i, (shape, dname, real_len, strided) in enumerate(FLASH_CASES):
        dtype = getattr(torch, dname)
        sfx = " fp32" if dtype == torch.float32 else ""
        b, h, s, d = shape
        valid = s if real_len is None else real_len
        scale = 1.0 / math.sqrt(d)
        if strided:
            q, k, v = lorenz_heads(torch, shape, dtype, 60 + i)
        else:
            q, k, v = dense_heads(torch, shape, dtype, 60 + i, 3)
        do = dense_heads(torch, shape, dtype, 70 + i, 1)[0]
        o, lse = fa.flash_forward(q, k, v, valid, scale)
        o_ref, lse_ref = fa._forward_plain(q, k, v, valid, scale)
        grads = fa.flash_backward(q, k, v, o, lse, do, valid, scale)
        grads_ref = fa._backward_plain(q, k, v, o_ref, lse_ref, do, valid, scale)
        ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
        o_auto = fa._forward_plain(*ins, valid, scale)[0]
        grads_auto = torch.autograd.grad(o_auto, ins, grad_outputs=do.float())
        torch.cuda.synchronize()
        tag = f"{shape} {dname} real_len={real_len}{' strided' if strided else ''}"
        e5 = check_close(o, o_ref, dtype, (FWD_RTOL, FWD_ATOL), BF16_FWD, f"K5 o {tag}")
        worst["K5" + sfx] = max(worst["K5" + sfx], e5)
        max_err(lse, lse_ref, FWD_RTOL, FWD_ATOL, f"K5 lse {tag}", atol_floor=0.0)
        # at S = 1 the softmax over one key gives q and k no gradient: both
        # sides are zero up to rounding, held to the bar times 1e-3 (bf16) or
        # to the fp32 atol itself (dp - di cancels two sums of D products of
        # order one, whose rounding the fp32 rtol of a zero cannot absorb)
        floor = (1e-3 if dtype == torch.bfloat16 else 1.0) if s == 1 else 0.0
        for name, a, r, r_auto in zip(("dq", "dk", "dv"), grads, grads_ref, grads_auto):
            e = check_close(a, r, dtype, (BWD_RTOL, BWD_ATOL), BF16_BWD, f"K6/K7 {name} {tag}", floor)
            e_auto = check_close(a, r_auto, dtype, (BWD_RTOL, BWD_ATOL), BF16_BWD,
                                 f"K6/K7 {name} vs autograd {tag}", floor)
            key = ("K7" if name == "dq" else "K6") + sfx
            worst[key] = max(worst[key], e, e_auto)
        log(f"[K5-K7] {tag}: max |err| so far " + " ".join(f"{k} {v:.3e}" for k, v in worst.items()))
        if shape == LORENZ_SHAPE:  # a second K5 and a second K6+K7 give the same bits
            again = (*fa.flash_forward(q, k, v, valid, scale), *fa.flash_backward(q, k, v, o, lse, do, valid, scale))
            torch.cuda.synchronize()
            for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads), again):
                if not torch.equal(a, r):
                    raise AssertionError(f"K5/K6/K7 {name} {tag}: two runs differ")
            log(f"[K5-K7] {tag}: two runs bitwise equal in o, lse (K5) and dq, dk, dv (K6/K7)")
    return worst


def phase_kernel_times(torch) -> dict:
    """K1/K2 and their plain versions at the OU path's shape (B=128) and at
    the Lorenz path's (B=32, T=2000, D=3); K1 and K2 at 1, 2 and 4 rows per
    block at both, K1 also on its streaming plan (at 1 and 4 rows), and
    both on the cluster path at a cluster of one (the kernels the plan gives
    the d=32 shapes); the kernels again at B=528 (4 rows per block, all SMs
    busy); K1 at the Lorenz shape with one layer and with H=8; then
    ``WIDE_SHAPES``. Each time also per serial step."""
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    times, bounds = {}, {}
    for B, row, sfx, n_plain in ((BATCH, 0, "", 3), (528, 0, "_b528", 0), (LZ_BATCH, 1, "_lorenz", 2)):
        _, T, D, H, L, chol, _, dt = SHAPES[row]
        spec, w, x0, gc, eps, cot = sampler_case(torch, B, T, D, H, L, chol, 30, dt=dt)
        fwd = ss.sampler_forward(spec, w, x0, gc, eps, save_h=True)
        d_paths = cot[0][:, 1:].transpose(0, 1).contiguous()
        d_means = cot[1].transpose(0, 1).contiguous()
        d_cholv = cot[2].transpose(0, 1).contiguous()
        bwd_args = (spec, w, x0, gc, eps, fwd, d_paths, d_means, d_cholv)
        times["fwd_ms" + sfx] = cuda_ms(torch, lambda: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True), 20)
        times["bwd_ms" + sfx] = cuda_ms(torch, lambda: ss._backward_cuda(*bwd_args), 20)
        if sfx != "_b528":
            fp, bp = (plan(spec, B, torch.cuda.current_device()) for plan in (ss.forward_plan, ss.backward_plan))
            for r in ss.ROWS_PER_BLOCK:
                times[f"fwd_ms{sfx}_rows{r}"] = cuda_ms(
                    torch, lambda: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True, path=fp.path, rows=r), 20)
                times[f"bwd_ms{sfx}_rows{r}"] = cuda_ms(
                    torch, lambda: ss._backward_cuda(*bwd_args, path=bp.path, rows=r), 20)
            times["fwd_ms" + sfx + "_streaming"] = cuda_ms(
                torch, lambda: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True, path=ss.PATH_STREAMING), 20)
            times["fwd_ms" + sfx + "_rows4_streaming"] = cuda_ms(
                torch, lambda: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True, path=ss.PATH_STREAMING,
                                                rows=4), 20)
            times["fwd_ms" + sfx + "_cluster1"] = cuda_ms(
                torch, lambda: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True, path=ss.PATH_CLUSTER,
                                                cluster=1), 20)
            times["bwd_ms" + sfx + "_cluster1"] = cuda_ms(
                torch, lambda: ss._backward_cuda(*bwd_args, path=ss.PATH_CLUSTER, cluster=1), 20)
            times["fwd_us_per_step" + sfx] = us_per_step(times["fwd_ms" + sfx], T)
            times["bwd_us_per_step" + sfx] = us_per_step(times["bwd_ms" + sfx], T)
        if n_plain:
            times["fwd_plain_ms" + sfx] = cuda_ms(
                torch, lambda: ss._forward_plain(spec, w, x0, gc, eps, save_h=True), n_plain)
            times["bwd_plain_ms" + sfx] = cuda_ms(torch, lambda: ss._backward_plain(*bwd_args), n_plain)
        if sfx == "_lorenz":
            flop_f, flop_b = sampler_flop(spec, B, T)
            grads = ss._backward_cuda(*bwd_args)
            bounds["K1"] = bound(flop_f, nbytes(x0, gc, eps, w, fwd.paths, fwd.raw, fwd.h_all), "fp32")
            bounds["K2"] = bound(flop_b, nbytes(x0, gc, eps, w, fwd.paths, fwd.raw, fwd.h_all,
                                                d_paths, d_means, d_cholv, grads), "fp32")
    # K1's step at the Lorenz shape with one layer, and with 8 hidden units:
    # what a layer costs, and what is left when the matvecs are tiny
    for H, L in ((64, 1), (8, 2)):
        spec, w, x0, gc, eps, _ = sampler_case(torch, LZ_BATCH, 2000, 3, H, L, "full", 31, dt=LZ_DT)
        times[f"fwd_ms_lorenz_H{H}_L{L}"] = cuda_ms(
            torch, lambda: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True), 20)
    wide = {label: wide_sampler_times(torch, label, *shape) for label, shape in WIDE_SHAPES.items()}
    for w in wide.values():
        times.update(w["times"])
    log("[times] sampler (OU: B=128 T=100 D=1; _lorenz: B=32 T=2000 D=3; _d32: B=1024 T=100 D=32; "
        "_highdim: B=4096 T=500 D=32; _h256: B=32 T=2000 D=3 H=256; _lorenz_r3: B=32 T=2000 D=3 H=128 L=3; "
        "_highdim_r5: B=512 T=100 D=32 H=128; H=64 L=2 unless named; _cluster1: "
        "the cluster kernels on one CTA): " + json.dumps(times))
    for k, key in (("K1", "fwd"), ("K2", "bwd")):
        log(f"[steps] {k} at B=32 T=2000: {times[key + '_us_per_step_lorenz']:.3f} us/step "
            f"against a roofline bound of {us_per_step(bounds[k]['bound_ms'], 2000):.4f} us/step; "
            f"OU B=128 T=100: {times[key + '_us_per_step']:.3f} us/step")
        for label, (B, T, D, H, L, _) in WIDE_SHAPES.items():
            bd, ms = wide[label]["bounds"][k], times[f"{key}_ms_{label}"]
            log(f"[steps] {k} at B={B} T={T} D={D} H={H} L={L}: {ms:.3f} ms, "
                f"{times[f'{key}_us_per_step_{label}']:.3f} us/step, against a bound of {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}: {bd['flop'] / 1e9:.2f} GFLOP fp32, {bd['bytes'] / 1e6:.1f} MB), "
                f"{bd['bound_ms'] / ms:.4f} of the bound")
    return times, bounds


def wide_sampler_times(torch, label: str, B: int, T: int, D: int, H: int, L: int, dt: float) -> dict:
    """K1 and K2 at one of ``WIDE_SHAPES`` (full Cholesky) and their bound
    there; the streams (~40 GB with K2's scratch at the highdim shape) are
    freed after."""
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    spec, w, x0, gc, eps, cot = sampler_case(torch, B, T, D, H, L, "full", 33, dt=dt, on_card=True)
    fwd = ss.sampler_forward(spec, w, x0, gc, eps, save_h=True)
    tmaj = [c.transpose(0, 1).contiguous() for c in (cot[0][:, 1:], cot[1], cot[2])]
    del cot
    bwd_args = (spec, w, x0, gc, eps, fwd, *tmaj)
    grads = ss._backward_cuda(*bwd_args)
    flop_f, flop_b = sampler_flop(spec, B, T)
    bounds = {
        "K1": bound(flop_f, nbytes(x0, gc, eps, w, fwd.paths, fwd.raw, fwd.h_all), "fp32"),
        "K2": bound(flop_b, nbytes(x0, gc, eps, w, fwd.paths, fwd.raw, fwd.h_all, *tmaj, grads), "fp32"),
    }
    del grads
    times = {
        f"fwd_ms_{label}": cuda_ms(torch, lambda: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True), 5),
        f"bwd_ms_{label}": cuda_ms(torch, lambda: ss._backward_cuda(*bwd_args), 5),
    }
    times[f"fwd_us_per_step_{label}"] = us_per_step(times[f"fwd_ms_{label}"], T)
    times[f"bwd_us_per_step_{label}"] = us_per_step(times[f"bwd_ms_{label}"], T)
    dev = torch.cuda.current_device()
    times[f"plan_K1_{label}"] = plan_text(ss.forward_plan(spec, B, dev))
    times[f"plan_K2_{label}"] = plan_text(ss.backward_plan(spec, B, dev))
    del fwd, bwd_args, tmaj, gc, eps
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"times": times, "bounds": bounds}


def library_arms(torch, q, k, v, do, tag: str = "", backend: str = "FLASH_ATTENTION") -> dict:
    """The yardstick for K5-K7 (the port never calls it): PyTorch's
    ``scaled_dot_product_attention`` pinned to one backend (flash for bf16;
    the memory-efficient one for fp32, which flash does not take) on the same
    inputs, as two arms for ``turns_ms``: the forward alone, and the backward
    on one retained graph. Logs the device kernels of one forward and
    backward."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    pin = getattr(SDPBackend, backend)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    with sdpa_kernel(pin):
        out = F.scaled_dot_product_attention(*ins)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(F.scaled_dot_product_attention(*ins), ins, do)
            torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if e.device_type.name == "CUDA"})
    log(f"[library] scaled_dot_product_attention {q.dtype}, backend {backend} "
        f"(the only one enabled); device kernels of one forward + backward: "
        + "; ".join(n[:80] for n in names))

    def forward():
        with sdpa_kernel(pin):
            F.scaled_dot_product_attention(q, k, v)

    return {f"library_fwd{tag}_ms": forward,
            f"library_bwd{tag}_ms": lambda: torch.autograd.grad(out, ins, do, retain_graph=True)}


FLASH_TURNS = 5  # turns of the attention arms in turns_ms


def turns_ms(torch, arms: dict, n: int, turns: int) -> dict:
    """ms per launch of each arm (name -> fn) over ``turns`` turns, each
    running one window of ``n`` launches (CUDA events) of every arm in order,
    then in reverse, after warming each as ``cuda_ms`` does: name -> the
    windows' times."""
    for fn in arms.values():
        cuda_ms(torch, fn, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = {name: [] for name in arms}
    for _ in range(turns):
        for name in [*arms, *reversed(arms)]:
            start.record()
            for _ in range(n):
                arms[name]()
            end.record()
            torch.cuda.synchronize()
            out[name].append(start.elapsed_time(end) / n)
    return out


def turn_stats(windows: list[float]) -> str:
    return f"median {statistics.median(windows):.4f} (min {min(windows):.4f}, max {max(windows):.4f})"


QK_SETS = 6  # sets of COLD_WINDOWS cold windows of K3 and K4, for their spread


def sm_clock_mhz() -> str:
    """The SM clock ``nvidia-smi`` reads now."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def qk_prep_spread(torch, q, cos, sin, do) -> dict:
    """K3 and K4 over ``QK_SETS`` sets of ``cold_windows_ms`` windows in this
    one call: each set's median, with the SM clock read right after it."""
    from viforsdes_tpu_torch.ops import qk_prep as qp

    out = {"fwd_ms": [], "bwd_ms": [], "sm_clock": []}
    for _ in range(QK_SETS):
        out["fwd_ms"].append(statistics.median(
            cold_windows_ms(torch, lambda: qp._forward_cuda(q, cos, sin, 1e-6), 50)))
        out["bwd_ms"].append(statistics.median(
            cold_windows_ms(torch, lambda: qp._backward_cuda(q, cos, sin, do, 1e-6), 50)))
        out["sm_clock"].append(sm_clock_mhz())
    return out


def phase_attention_times(torch) -> tuple[dict, dict]:
    """K3-K7 and their plain versions at the Lorenz shape [32, 4, 2001, 64]
    bf16, q/k/v strided views of one projection as on the main path, beside
    their bounds and PyTorch's flash attention; K5-K7 again with fp32 inputs
    (3xTF32) beside their plain versions and PyTorch's memory-efficient
    attention.
    The plain and the library backward serve K6 and K7 together, so both
    carry their time."""
    from viforsdes_tpu_torch.ops import flash_attention as fa
    from viforsdes_tpu_torch.ops import qk_prep as qp

    shape = (LZ_BATCH, 4, 2001, 64)
    b, h, s, d = shape
    q, k, v = lorenz_heads(torch, shape, torch.bfloat16, 80)
    do = dense_heads(torch, shape, torch.bfloat16, 81, 1)[0]
    cos, sin = rope_tables(torch, s, d)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._forward_cuda(q, k, v, s, scale)
    operands, dq, dk, dv = fa._backward_operands(q, k, v, o, lse, do, s, scale)
    lse_di = operands[1][4:]
    # K5-K7, the whole backward and the library's forward and backward, in
    # turns inside this call, before the cold-L2 and nvidia-smi work of K3/K4
    windows = turns_ms(torch, {
        "flash_fwd_ms": lambda: fa._forward_cuda(q, k, v, s, scale),
        "flash_bwd_dkv_ms": lambda: fa._backward_launch(operands, 0),
        "flash_bwd_dq_ms": lambda: fa._backward_launch(operands, 1),
        "flash_bwd_ms": lambda: fa._backward_cuda(q, k, v, o, lse, do, s, scale),
        **library_arms(torch, q, k, v, do),
    }, 20, FLASH_TURNS)
    log(f"[turns] attention at [32, 4, 2001, 64] bf16, {2 * FLASH_TURNS} windows of 20 launches each in "
        f"{FLASH_TURNS} turns (in order, then reversed), ms: "
        + "; ".join(f"{name} {turn_stats(w)}" for name, w in windows.items()))

    # the same attention with fp32 inputs: the 3xTF32 K5, K6 and K7, and the
    # library's memory-efficient attention, in as many turns
    q32, k32, v32 = lorenz_heads(torch, shape, torch.float32, 80)
    do32 = do.float()
    o32, lse32 = fa._forward_cuda(q32, k32, v32, s, scale)
    operands32, dq32, dk32, dv32 = fa._backward_operands(q32, k32, v32, o32, lse32, do32, s, scale)
    windows32 = turns_ms(torch, {
        "flash_fwd_fp32_ms": lambda: fa._forward_cuda(q32, k32, v32, s, scale),
        "flash_bwd_dkv_fp32_ms": lambda: fa._backward_launch(operands32, 0),
        "flash_bwd_dq_fp32_ms": lambda: fa._backward_launch(operands32, 1),
        **library_arms(torch, q32, k32, v32, do32, "_fp32", "EFFICIENT_ATTENTION"),
    }, 5, FLASH_TURNS)
    log(f"[turns] attention at [32, 4, 2001, 64] fp32, {2 * FLASH_TURNS} windows of 5 launches each in "
        f"{FLASH_TURNS} turns, ms: " + "; ".join(f"{name} {turn_stats(w)}" for name, w in windows32.items()))
    t = {name: statistics.median(w) for name, w in {**windows, **windows32}.items()}
    t["flash_fwd_plain_ms"] = cuda_ms(torch, lambda: fa._forward_plain(q, k, v, s, scale), 5)
    t["flash_bwd_plain_ms"] = cuda_ms(torch, lambda: fa._backward_plain(q, k, v, o, lse, do, s, scale), 5)
    t["flash_fwd_plain_fp32_ms"] = cuda_ms(torch, lambda: fa._forward_plain(q32, k32, v32, s, scale), 3)
    t["flash_bwd_plain_fp32_ms"] = cuda_ms(
        torch, lambda: fa._backward_plain(q32, k32, v32, o32, lse32, do32, s, scale), 3)

    qk_fwd = cold_windows_ms(torch, lambda: qp._forward_cuda(q, cos, sin, 1e-6), 50)
    qk_bwd = cold_windows_ms(torch, lambda: qp._backward_cuda(q, cos, sin, do, 1e-6), 50)
    log(f"[K3/K4] {COLD_WINDOWS} windows of 50 launches, each after a {COLD_FLUSH_BYTES >> 20} MB "
        f"write: K3 median {statistics.median(qk_fwd):.4f} ms (min {min(qk_fwd):.4f}, max {max(qk_fwd):.4f}); "
        f"K4 median {statistics.median(qk_bwd):.4f} ms (min {min(qk_bwd):.4f}, max {max(qk_bwd):.4f})")
    spread = qk_prep_spread(torch, q, cos, sin, do)
    t.update({
        "qk_prep_spread": spread,
        "qk_prep_fwd_ms": statistics.median(qk_fwd),
        "qk_prep_fwd_windows_ms": qk_fwd,
        "qk_prep_fwd_plain_ms": cuda_ms(torch, lambda: qp._forward_plain(q, cos, sin, 1e-6), 20),
        "qk_prep_bwd_ms": statistics.median(qk_bwd),
        "qk_prep_bwd_windows_ms": qk_bwd,
        "qk_prep_bwd_plain_ms": cuda_ms(torch, lambda: qp._backward_plain(q, cos, sin, do, 1e-6), 20),
    })

    product = 2 * b * h * s * s * d  # one [S, S] x D product
    qk_out = qp._forward_cuda(q, cos, sin, 1e-6)
    qk_dx = qp._backward_cuda(q, cos, sin, do, 1e-6)
    # K3/K4: about 6 and 12 fp32 operations per element (RMS statistics,
    # scale, rotation); their bytes bound them
    bounds = {
        "K3": bound(6 * q.numel(), nbytes(q, cos, sin, qk_out), "fp32"),
        "K4": bound(12 * q.numel(), nbytes(q, cos, sin, do, qk_dx), "fp32"),
        "K5": bound(2 * product, nbytes(q, k, v, o, lse), "bf16"),
        "K6": bound(4 * product, nbytes(q, k, v, do, lse_di, dk, dv), "bf16"),
        "K7": bound(3 * product, nbytes(q, k, v, do, lse_di, dq), "bf16"),
        "K5 fp32": bound(3 * 2 * product, nbytes(q32, k32, v32, o32, lse32), "tf32"),
        "K6 fp32": bound(3 * 4 * product, nbytes(q32, k32, v32, do32, operands32[1][4:], dk32, dv32), "tf32"),
        "K7 fp32": bound(3 * 3 * product, nbytes(q32, k32, v32, do32, operands32[1][4:], dq32), "tf32"),
    }
    # the same products once in fp32 FMA, outside the tensor cores
    fma = {"K5 fp32": bound(2 * product, bounds["K5 fp32"]["bytes"], "fp32"),
           "K6 fp32": bound(4 * product, bounds["K6 fp32"]["bytes"], "fp32"),
           "K7 fp32": bound(3 * product, bounds["K7 fp32"]["bytes"], "fp32")}
    t["flash_fwd_tflops"] = 2 * product / t["flash_fwd_ms"] / 1e9
    t["flash_bwd_tflops"] = 7 * product / t["flash_bwd_ms"] / 1e9
    log("[times] attention at [32, 4, 2001, 64] bf16 (fp32: K5-K7 3xTF32): " + json.dumps(t))
    for k, key in (("K5 fp32", "flash_fwd_fp32_ms"), ("K6 fp32", "flash_bwd_dkv_fp32_ms"),
                   ("K7 fp32", "flash_bwd_dq_fp32_ms")):
        log(f"[fp32 bounds] {k}: {t[key]:.4f} ms; 3xTF32 bound {bounds[k]['bound_ms']:.4f} ms "
            f"({bounds[k]['bound_ms'] / t[key]:.4f} of it), FMA bound {fma[k]['bound_ms']:.4f} ms "
            f"({fma[k]['bound_ms'] / t[key]:.4f})")
    k6k7_32 = t["flash_bwd_dkv_fp32_ms"] + t["flash_bwd_dq_fp32_ms"]
    log(f"[library] fp32: K6 {t['flash_bwd_dkv_fp32_ms']:.4f} + K7 {t['flash_bwd_dq_fp32_ms']:.4f} = "
        f"{k6k7_32:.4f} ms against the library's memory-efficient backward {t['library_bwd_fp32_ms']:.4f}: "
        f"{k6k7_32 / t['library_bwd_fp32_ms']:.3f}x; K5 {t['flash_fwd_fp32_ms']:.4f} against its forward "
        f"{t['library_fwd_fp32_ms']:.4f}: {t['flash_fwd_fp32_ms'] / t['library_fwd_fp32_ms']:.3f}x")
    k6k7, k6k7_before = t["flash_bwd_dkv_ms"] + t["flash_bwd_dq_ms"], MMA_SYNC_MS["K6"] + MMA_SYNC_MS["K7"]
    for k in ("K3", "K4"):
        key = "fwd" if k == "K3" else "bwd"
        shares = [bounds[k]["bound_ms"] / m for m in spread[key + "_ms"]]
        log(f"[K3/K4] {k} over {QK_SETS} sets of cold windows: medians {[round(m, 4) for m in spread[key + '_ms']]} "
            f"ms, shares of the {bounds[k]['bound_ms']:.4f} ms bound {[round(x, 3) for x in shares]}; "
            f"{sum(x < 0.5 for x in shares)} of {QK_SETS} sets under half the bound; SM clocks after each set "
            f"{spread['sm_clock']}")
    k7 = t["flash_bwd_dq_ms"]
    log(f"[K7] median {k7:.4f} ms of the turns (mma.sync {MMA_SYNC_MS['K7']}: {MMA_SYNC_MS['K7'] / k7:.3f}x) "
        f"against its bound {bounds['K7']['bound_ms']:.4f} ms: {bounds['K7']['bound_ms'] / k7:.4f} of the bound; K6 + K7 "
        f"{t['flash_bwd_dkv_ms'] + k7:.4f} ms against the library backward {t['library_bwd_ms']:.4f}: "
        f"{(t['flash_bwd_dkv_ms'] + k7) / t['library_bwd_ms']:.3f}x")
    log(f"[library] K5 {t['flash_fwd_ms']:.4f} ms (mma.sync {MMA_SYNC_MS['K5']}) against the library forward "
        f"{t['library_fwd_ms']:.4f}: {t['flash_fwd_ms'] / t['library_fwd_ms']:.3f}x; K6 {t['flash_bwd_dkv_ms']:.4f} "
        f"+ K7 {t['flash_bwd_dq_ms']:.4f} = {k6k7:.4f} ms (mma.sync {k6k7_before:.3f}) against the library "
        f"backward {t['library_bwd_ms']:.4f}: {k6k7 / t['library_bwd_ms']:.3f}x")
    return t, bounds


# ------------------------------------------------------------------ counters


def counters():
    from viforsdes_tpu_torch.ops import flash_attention as fa
    from viforsdes_tpu_torch.ops import qk_prep as qp
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    return {
        "K1": ss.FORWARD_LAUNCHES, "K2": ss.BACKWARD_LAUNCHES,
        "K3": qp.FORWARD_LAUNCHES, "K4": qp.BACKWARD_LAUNCHES,
        "K5": fa.FORWARD_LAUNCHES, "K6": fa.BACKWARD_DKV_LAUNCHES, "K7": fa.BACKWARD_DQ_LAUNCHES,
    }


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {name: c.count for name, c in counters().items()}


# ------------------------------------------------------------------ OU path


def ou_problem(vt):
    from examples_torch.ornstein_uhlenbeck import OrnsteinUhlenbeck

    observations = vt.Observations(
        times=[0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
        values=[[2.0], [1.5], [0.8], [1.2], [0.9], [1.1]],
    )
    return (
        OrnsteinUhlenbeck(),
        observations,
        vt.GaussianObservationLikelihood(variance=0.1),
        vt.Prior(type=vt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
    )


def make_trainer(vt, sampler: str, n_iterations: int, mesh=None, batch_size: int = BATCH, **training):
    sde, obs, lik, prior = ou_problem(vt)
    return vt.VariationalInferenceTrainer(
        sde, obs, lik, prior, HORIZON,
        vt.TrainingConfig(time_step=DT, batch_size=batch_size, n_iterations=n_iterations, **training),
        vt.EncoderConfig(**ENC),
        vt.HeadConfig(**HEAD, sampler=sampler),
        state_positive_dims=[],
        sde_param_positive_dims=[0, 2],
        console=vt.Console(enabled=False),
        mesh=mesh,
        device="cuda",
    )


def phase_main_path(torch, vt) -> dict:
    sde, obs, lik, prior = ou_problem(vt)
    config = vt.InferenceConfig(
        training=vt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=OU_STEPS),
        encoder=vt.EncoderConfig(**ENC),
        head=vt.HeadConfig(**HEAD),
        sde_param_positive_dims=[0, 2],
        console=vt.Console(enabled=False),
        device="cuda",
    )
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    posterior = vt.infer(sde, obs, lik, prior, HORIZON, config)
    summary = posterior.summary(n_samples=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    history = posterior.evidence_lower_bound_history
    n_steps = OU_STEPS
    expected = {"K1": n_steps + 1, "K2": n_steps, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}
    log(f"[ou] infer + summary(256): {wall:.2f} s wall, {len(history)} steps")
    log(f"[ou] ELBO history: {[round(v, 3) for v in history]}")
    log(f"[ou] launches {launches} (expected {expected})")
    if len(history) != n_steps or not all(math.isfinite(v) for v in history):
        raise AssertionError("OU path: missing or non-finite ELBO")
    if launches != expected:
        raise AssertionError(f"OU path did not run through exactly its kernels: {launches}")
    check_summary(torch, summary, (101, 1))
    log(f"[ou] posterior theta mean {summary.sde_parameter_mean.tolist()}, "
        f"std {summary.sde_parameter_std.tolist()}")
    return launches


def check_summary(torch, summary, path_shape) -> None:
    checks = {
        "theta mean": (summary.sde_parameter_mean, (3,)),
        "theta std": (summary.sde_parameter_std, (3,)),
        "path mean": (summary.diffusion_path_mean, path_shape),
        "path std": (summary.diffusion_path_std, path_shape),
    }
    for name, (value, shape) in checks.items():
        if tuple(value.shape) != shape or not bool(torch.isfinite(value).all()):
            raise AssertionError(f"posterior summary {name}: {tuple(value.shape)} not finite {shape}")


def step_elbo_and_grads(torch, trainer):
    """One step's ELBO and gradient per parameter group from the trainer's
    step-0 draws."""
    from viforsdes_tpu_torch.inference.optimizer import GROUPS

    theta_eps, noise = trainer.draws(0)[0]
    leaves = {g: trainer.flat_params[g].detach().requires_grad_() for g in GROUPS}
    result = trainer._elbo_from_params(trainer.layout.unpack(leaves), theta_eps, noise)
    grads = torch.autograd.grad(result.evidence_lower_bound, [leaves[g] for g in GROUPS])
    return result.evidence_lower_bound.detach(), dict(zip(GROUPS, grads))


def phase_step_parity(torch, vt) -> None:
    """One step's ELBO and gradient at the bench config: kernels vs plain loop
    on the same weights and draws."""
    results = {s: step_elbo_and_grads(torch, make_trainer(vt, s, 1)) for s in ("auto", "scan")}
    torch.cuda.synchronize()
    (e_k, g_k), (e_p, g_p) = results["auto"], results["scan"]
    rel = abs(float(e_k) - float(e_p)) / abs(float(e_p))
    log(f"[ou parity] ELBO kernels {float(e_k):.6f} plain {float(e_p):.6f} rel {rel:.2e}")
    if rel > ELBO_RTOL:
        raise AssertionError("bench-config ELBO differs between kernels and plain loop")
    for g in g_k:
        e = max_err(g_k[g], g_p[g], BWD_RTOL, BWD_ATOL, f"bench-config gradient ({g})")
        log(f"[ou parity] gradient {g}: max |err| {e:.3e}")


def timed_turns(torch, arms: dict, n_per_turn: int, order, label: str):
    """ms/step of each arm, run in turns (``order``), each step ended by a
    synchronize; the peak device memory of each arm over its timed steps."""
    steps = {name: 0 for name in arms}
    samples = {name: [] for name in arms}
    peak = {name: 0 for name in arms}

    def run(name: str, n: int) -> list[float]:
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            with arms[name][1]():
                arms[name][0].train_step(steps[name])
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            steps[name] += 1
        return out

    for name in arms:
        run(name, 1)  # warm-up: allocator, cuBLAS handles
    for name in order:
        torch.cuda.reset_peak_memory_stats()
        samples[name] += run(name, n_per_turn)
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    stats = {}
    for name, v in samples.items():
        q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
        stats[name] = {"median_ms": statistics.median(v), "q1_ms": q[0], "q3_ms": q[2], "n": len(v),
                       "peak_gib": peak[name] / 2**30}
    log(f"[step] {label} ms/step: " + json.dumps(stats))
    return steps, stats


def phase_step_times(torch, vt):
    """ms/step with the kernels and with the plain loop, in turns
    (plain, kernel, kernel, plain)."""
    arms = {s: (make_trainer(vt, s, 10_000), contextlib.nullcontext) for s in ("auto", "scan")}
    steps, stats = timed_turns(torch, arms, OU_TIMED // 2, ("scan", "auto", "auto", "scan"), "OU bench config")
    return arms["auto"][0], steps["auto"], stats


def phase_profile(torch, trainer, step: int, wall_ms: float, label: str, n: int = 5) -> None:
    """Device time by kernel over a few kernel-path steps; the idle share is
    taken against the unprofiled median step time ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            trainer.train_step(step + i)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    total_us = sum(getattr(e, attr) for e in events) / n
    log(f"[profile] {label}, {n} kernel-path steps: device kernel time {total_us / 1e3:.2f} ms/step "
        f"in {len(events)} kernel names, {sum(e.count for e in events) // n} launches/step; "
        f"against the unprofiled {wall_ms:.2f} ms/step: "
        f"device idle share {max(0.0, 1 - total_us / 1e3 / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:12]:
        log(f"[profile]   {getattr(e, attr) / n / 1e3:8.3f} ms/step  x{e.count // n:<4d} {e.key[:90]}")


# -------------------------------------------------------------- Lorenz path


def lorenz_problem(torch, vt):
    """Stochastic Lorenz-63 (examples/lorenz63.py) with observations of all
    three coordinates every 0.5 time units, simulated from a seeded generator."""
    from examples_torch.lorenz63 import StochasticLorenz63

    sde = StochasticLorenz63()
    gen = torch.Generator().manual_seed(17)
    traj = vt.euler_maruyama(
        sde, torch.tensor([[1.0, 1.0, 25.0]]), torch.tensor([LZ_TRUE]), LZ_HORIZON, LZ_DT,
        generator=gen,
    )
    stride = round(LZ_OBS_EVERY / LZ_DT)
    idx = list(range(0, traj.shape[1], stride))
    if not bool(torch.isfinite(traj).all()):
        raise AssertionError("Lorenz observations: non-finite simulation")
    observations = vt.Observations(times=[i * LZ_DT for i in idx], values=traj[0, idx])
    return (
        sde,
        observations,
        vt.GaussianObservationLikelihood(variance=1.0),
        vt.Prior(type=vt.PriorType.LOG_NORMAL, mean=1.0, std=1.5, dim=3),
    )


def lorenz_trainer(torch, vt, sampler: str, compute_dtype: str = "bfloat16", **training):
    sde, obs, lik, prior = lorenz_problem(torch, vt)
    return vt.VariationalInferenceTrainer(
        sde, obs, lik, prior, LZ_HORIZON,
        vt.TrainingConfig(**{"time_step": LZ_DT, "batch_size": LZ_BATCH, "n_iterations": 10_000,
                             "compute_dtype": compute_dtype, **training}),
        vt.EncoderConfig(**ENC),
        vt.HeadConfig(**HEAD, sampler=sampler),
        state_positive_dims=[],
        sde_param_positive_dims=[0, 1, 2],
        console=vt.Console(enabled=False),
        device="cuda",
    )


@contextlib.contextmanager
def plain_attention():
    """The plain path's attention: the dispatch sends every grid to the dense
    path (and so to the unfused RMSNorm + RoPE)."""
    from viforsdes_tpu_torch.ops import attention

    saved = attention.use_flash_attention
    attention.use_flash_attention = lambda seq_len: False
    try:
        yield
    finally:
        attention.use_flash_attention = saved


@contextlib.contextmanager
def timed_pretrain(torch):
    """Wall time and result of each pretraining inside the block (the
    trainer's ``pretrain_sde_parameters``, wrapped for the block): yields a
    dict that holds ``seconds`` and ``theta`` (constrained) afterwards."""
    from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer

    record: dict = {}
    saved = VariationalInferenceTrainer.pretrain_sde_parameters

    def timed(self, config=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = saved(self, config)
        torch.cuda.synchronize()
        record["seconds"] = time.perf_counter() - t0
        pos = torch.zeros_like(mean, dtype=torch.bool)
        pos[self.sde_param_positive_dims] = True
        record["theta"] = torch.where(pos, torch.exp(mean), mean).tolist()
        return mean

    VariationalInferenceTrainer.pretrain_sde_parameters = timed
    try:
        yield record
    finally:
        VariationalInferenceTrainer.pretrain_sde_parameters = saved


def phase_lorenz_path(torch, vt) -> dict:
    sde, obs, lik, prior = lorenz_problem(torch, vt)
    depth = ENC["depth"]
    config = vt.InferenceConfig(
        training=vt.TrainingConfig(time_step=LZ_DT, batch_size=LZ_BATCH, n_iterations=LZ_STEPS),
        encoder=vt.EncoderConfig(**ENC),
        head=vt.HeadConfig(**HEAD),
        sde_param_positive_dims=[0, 1, 2],
        pretrain=vt.PretrainConfig(),
        console=vt.Console(enabled=False),
        device="cuda",
    )
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with timed_pretrain(torch) as pre:
        posterior = vt.infer(sde, obs, lik, prior, LZ_HORIZON, config)
    summary = posterior.summary(n_samples=LZ_SAMPLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    cfg = vt.PretrainConfig()
    log(f"[lorenz] pretrain (PretrainConfig(): global, {cfg.sweep_candidates} sweep candidates at "
        f"population {cfg.batch_size}, {cfg.cem_rounds} CEM rounds): {pre['seconds']:.2f} s wall; "
        f"theta {pre['theta']} against the true {list(LZ_TRUE)}")

    n = LZ_STEPS
    # per training step: K5-K7 once per block, K3/K4 for q and for k of each
    # block; summary() runs the encoder forward once more (one chunk);
    # pretraining launches none of them
    expected = {"K1": n + 1, "K2": n, "K3": 2 * depth * (n + 1), "K4": 2 * depth * n,
                "K5": depth * (n + 1), "K6": depth * n, "K7": depth * n}
    history = posterior.evidence_lower_bound_history
    log(f"[lorenz] {len(obs.times)} observations, grid {posterior.model.encoder.n_grid} tokens")
    log(f"[lorenz] infer + summary({LZ_SAMPLES}): {wall:.2f} s wall, {len(history)} steps")
    log(f"[lorenz] ELBO history: {[round(v, 3) for v in history]}")
    log(f"[lorenz] launches {launches} (expected {expected})")
    if len(history) != n or not all(math.isfinite(v) for v in history):
        raise AssertionError("Lorenz path: missing or non-finite ELBO")
    if launches != expected:
        raise AssertionError(f"Lorenz path did not run through exactly its kernels: {launches}")
    check_summary(torch, summary, (posterior.model.encoder.n_grid, 3))
    log(f"[lorenz] posterior theta mean {summary.sde_parameter_mean.tolist()}, "
        f"std {summary.sde_parameter_std.tolist()}")
    return launches


# head widths of [repairs]: 16 and 48 run K5-K7 zero-padded to 32 and 64, 256
# takes the dense path (no flash kernel past 128)
REPAIR_WIDTHS = (16, 48, 256)
REPAIR_BATCH = 4


def phase_repairs(torch, vt) -> dict:
    """``attention()`` at S=2001 in bf16 on the card at head widths 16, 48
    and 256 (2 heads), forward and backward (the input and the QKV weight
    gradient), against the plain path (dense attention, unfused QK prep)
    within the bf16 bars, with K3-K7 counted: K5-K7 once each at 16 and 48,
    none at 256, and no K3/K4 at any of them (none is a kernel width). Then
    one Lorenz-length ``infer()`` step with ``EncoderConfig(hidden_dim=64,
    num_heads=4)`` (head width 16): a finite ELBO, through K5-K7 and not
    K3/K4."""
    from viforsdes_tpu_torch.ops import attention as at
    from viforsdes_tpu_torch.ops.embeddings import precompute_rope

    s = 2001
    out = {}
    for d in REPAIR_WIDTHS:
        cfg = at.AttentionConfig(embed_dim=2 * d, num_heads=2)
        params = at.attention_init(torch.Generator().manual_seed(d), cfg)
        params = {k: {n: t.cuda() for n, t in v.items()} for k, v in params.items()}
        params["gate_proj"]["w"] = 0.1 * torch.randn(params["gate_proj"]["w"].shape, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(d)
        x = torch.randn((REPAIR_BATCH, s, 2 * d), generator=gen, device="cuda").to(torch.bfloat16)
        ct = torch.randn((REPAIR_BATCH, s, 2 * d), generator=gen, device="cuda").to(torch.bfloat16)
        rotary = precompute_rope(d, end=s).to("cuda")

        def run():
            xx = x.clone().requires_grad_()
            w = params["qkv_proj"]["w"].clone().requires_grad_()
            o, _ = at.attention({**params, "qkv_proj": {**params["qkv_proj"], "w": w}}, cfg, xx, rotary=rotary)
            return (o, *torch.autograd.grad(o, [xx, w], grad_outputs=ct))

        reset_counts()
        got = run()
        torch.cuda.synchronize()
        counts = read_counts()
        with plain_attention():
            ref = run()
        torch.cuda.synchronize()
        errs = [check_close(a.float(), r.float(), torch.bfloat16, None, bar, f"[repairs] {name} at head_dim {d}")
                for name, a, r, bar in zip(("out", "d_x", "d_w_qkv"), got, ref, (BF16_FWD, BF16_BWD, BF16_BWD))]
        flash = int(d <= 128)
        want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": flash, "K6": flash, "K7": flash}
        if counts != want:
            raise AssertionError(f"[repairs] head_dim {d}: launches {counts}, expected {want}")
        log(f"[repairs] attention at [{REPAIR_BATCH}, {s}, 2 heads x {d}] bf16: out, d_x, d_w_qkv within the bf16 "
            f"bars of the plain path (max |err| {[f'{e:.3e}' for e in errs]}); launches {counts}")
        out[d] = {"errs": errs, "launches": counts}

    sde, obs, lik, prior = lorenz_problem(torch, vt)
    config = vt.InferenceConfig(
        training=vt.TrainingConfig(time_step=LZ_DT, batch_size=LZ_BATCH, n_iterations=1),
        encoder=vt.EncoderConfig(hidden_dim=64, num_heads=4),
        head=vt.HeadConfig(**HEAD),
        sde_param_positive_dims=[0, 1, 2],
        console=vt.Console(enabled=False),
        device="cuda",
    )
    reset_counts()
    posterior = vt.infer(sde, obs, lik, prior, LZ_HORIZON, config)
    torch.cuda.synchronize()
    counts, history = read_counts(), posterior.evidence_lower_bound_history
    depth = config.encoder.depth
    want = {"K1": 1, "K2": 1, "K3": 0, "K4": 0, "K5": depth, "K6": depth, "K7": depth}
    log(f"[repairs] infer() one Lorenz step ({posterior.model.encoder.n_grid} tokens) with EncoderConfig("
        f"hidden_dim=64, num_heads=4), head width 16: ELBO {history}; launches {counts} (expected {want})")
    if len(history) != 1 or not math.isfinite(history[0]) or counts != want:
        raise AssertionError("[repairs] the head-width-16 Lorenz step failed or missed its kernels")
    out["lorenz_h16"] = {"elbo": history[0], "launches": counts}
    return out


WIDE_HEAD = 320     # wider than K1 takes: sampler="auto" runs the plain loop on the card
WIDE_HEAD_STEPS = 2


def phase_wide_head(torch, vt) -> dict:
    """``HeadConfig(hidden_dim=320)`` under ``sampler="auto"`` trains
    ``WIDE_HEAD_STEPS`` OU steps on the card through the plain loop (no K1/K2
    launch, finite ELBOs); ``sampler="pallas"`` at that width is refused
    when the model is built, naming K1's limit."""
    from viforsdes_tpu_torch.ops.sde_sampler import K1_MAX_HIDDEN

    sde, obs, lik, prior = ou_problem(vt)

    def config(sampler):
        return vt.InferenceConfig(
            training=vt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=WIDE_HEAD_STEPS),
            encoder=vt.EncoderConfig(**ENC),
            head=vt.HeadConfig(hidden_dim=WIDE_HEAD, num_layers=2, sampler=sampler),
            sde_param_positive_dims=[0, 2],
            console=vt.Console(enabled=False),
            device="cuda",
        )

    reset_counts()
    posterior = vt.infer(sde, obs, lik, prior, HORIZON, config("auto"))
    torch.cuda.synchronize()
    counts, history = read_counts(), posterior.evidence_lower_bound_history
    if len(history) != WIDE_HEAD_STEPS or not all(math.isfinite(v) for v in history) or counts["K1"] or counts["K2"]:
        raise AssertionError(f"[head320] auto: ELBO {history}, launches {counts}")
    try:
        vt.infer(sde, obs, lik, prior, HORIZON, config("pallas"))
    except ValueError as exc:
        if f"hidden_dim <= {K1_MAX_HIDDEN}" not in str(exc):
            raise
        refused = str(exc)
    else:
        raise AssertionError("[head320] sampler='pallas' at hidden_dim 320 was not refused")
    log(f"[head320] HeadConfig(hidden_dim={WIDE_HEAD}, sampler='auto'): {WIDE_HEAD_STEPS} OU steps on the card, "
        f"ELBO {[round(v, 3) for v in history]}, K1/K2 launches {counts['K1']}/{counts['K2']}; "
        f"sampler='pallas' refused: {refused}")
    return {"history": history}


def perturbed_lorenz_trainer(torch, vt, sampler: str, compute_dtype: str):
    """A Lorenz trainer whose SiT modulators and head output have seeded
    weights: at init adaLN-Zero makes every block the identity and the head's
    zero out_proj hides the encoder from the ELBO, which would give the flash
    backward a zero cotangent."""
    trainer = lorenz_trainer(torch, vt, sampler, compute_dtype)
    gen = torch.Generator().manual_seed(5)
    params = trainer.params  # views of the flat buffers
    weights = [b["cond"]["net"]["w"] for b in params["encoder"]["sit"]["blocks"]]
    with torch.no_grad():
        for w in weights:
            w.copy_(0.05 * torch.randn(w.shape, generator=gen))
        w = params["head"]["out_proj"]["w"]
        w.copy_(0.1 * torch.randn(w.shape, generator=gen))
    return trainer


def phase_lorenz_parity(torch, vt) -> dict:
    """One Lorenz step's ELBO and gradients with the kernels against the plain
    path (dense attention, unfused QK prep, the plain sampler loop) on the
    same weights and draws, in fp32 and in bf16; each gradient leaf to the
    bar times its own largest value."""
    from viforsdes_tpu_torch.utils.tree import tree_items

    out = {}
    for dtype, bar in (("float32", ELBO_RTOL), ("bfloat16", BF16_ELBO)):
        trainer = perturbed_lorenz_trainer(torch, vt, "auto", dtype)
        kern = step_elbo_and_grads(torch, trainer)
        reset_counts()
        with plain_attention():
            plain = step_elbo_and_grads(torch, perturbed_lorenz_trainer(torch, vt, "scan", dtype))
        torch.cuda.synchronize()
        if any(read_counts().values()):
            raise AssertionError(f"the plain path launched kernels: {read_counts()}")
        (e_k, g_k), (e_p, g_p) = kern, plain
        qkv = trainer.layout.unpack(g_k)["encoder"]["sit"]["blocks"][-1]["attn"]["qkv_proj"]["w"]
        log(f"[lorenz parity] {dtype}: max |d qkv_proj.w| of the last block {float(qkv.abs().max()):.3e}")
        if float(qkv.abs().max()) == 0.0:
            raise AssertionError("the attention weights got no gradient")
        rel = abs(float(e_k) - float(e_p)) / abs(float(e_p))
        log(f"[lorenz parity] {dtype}: ELBO kernels {float(e_k):.6f} plain {float(e_p):.6f} "
            f"rel {rel:.2e} (bar {bar})")
        if not math.isfinite(float(e_k)) or rel > bar:
            raise AssertionError(f"Lorenz {dtype} ELBO differs between kernels and plain path")
        for g in g_k:
            if not bool(torch.isfinite(g_k[g]).all()):
                raise AssertionError(f"Lorenz {dtype} gradient {g}: non-finite values")
        # each leaf's max |err| against its own max |ref|
        ratios = []
        t_k, t_p = trainer.layout.unpack(g_k), trainer.layout.unpack(g_p)
        for (path, a), (_, r) in zip(tree_items(t_k), tree_items(t_p)):
            ref_max = float(r.abs().max())
            ratios.append((float((a - r).abs().max()) / max(ref_max, 1e-30), path, ref_max))
        ratios.sort(reverse=True)
        for ratio, path, ref_max in ratios[:5]:
            log(f"[lorenz parity] {dtype} gradient {path}: max |err| / max |ref| {ratio:.2e} "
                f"(max |ref| {ref_max:.3e})")
        worst = ratios[0][0]
        if worst > bar:
            raise AssertionError(f"Lorenz {dtype} gradient {ratios[0][1]} differs beyond {bar} x max|ref|")
        out[dtype] = {"elbo_rel": rel, "grad_rel": worst}
    return out


def phase_lorenz_times(torch, vt):
    """ms/step of the kernel path and the plain path, in turns
    (plain, kernel, kernel, plain), with each arm's peak device memory; the
    dense arm holds the [B, H, S, S] probabilities of all 8 blocks."""
    arms = {
        "kernels": (lorenz_trainer(torch, vt, "auto"), contextlib.nullcontext),
        "plain": (lorenz_trainer(torch, vt, "scan"), plain_attention),
    }
    steps, stats = timed_turns(torch, arms, LZ_TIMED, ("plain", "kernels", "kernels", "plain"),
                               "Lorenz-63 (B=32, 2001 tokens)")
    return arms["kernels"][0], steps["kernels"], stats


# ---------------------------------------------------------- examples' path

EX_STEPS, EX_EVERY = 20, 10  # examples/ornstein_uhlenbeck.py runs 20,000 steps


def phase_examples(torch, vt) -> dict:
    """examples/ornstein_uhlenbeck.py's calls at its configuration, cut to
    20 steps with a checkpoint every 10: the console on, ``PretrainConfig()``
    (auto: the global sweep and CEM), then the posterior's summary,
    diagnostics, summary table, plot, save and load, and a resume from the
    step-10 checkpoint against the unbroken run."""
    import importlib.util
    import shutil
    import tempfile

    has_rich = importlib.util.find_spec("rich") is not None
    has_plot = importlib.util.find_spec("matplotlib") is not None
    log(f"[examples] rich {'present' if has_rich else 'absent: the console runs disabled'}; "
        f"matplotlib {'present' if has_plot else 'absent: plot() is not called'}")
    sde, obs, lik, prior = ou_problem(vt)
    names = ["kappa", "mu", "sigma"]
    console = vt.Console(enabled=has_rich)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, ckpt10 = os.path.join(tmp, "run.npz"), os.path.join(tmp, "step10.npz")

        def keep_step10(step: int, elbo: float) -> None:
            # step 10's metrics are read only after the step-10 checkpoint is
            # written and before the step-20 one
            if step == EX_EVERY:
                shutil.copyfile(ckpt, ckpt10)

        def config(**kw):
            return vt.InferenceConfig(
                training=vt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=EX_STEPS,
                                           learning_rate=1e-4, sde_param_lr=1e-3, grad_clip_norm=1.0),
                encoder=vt.EncoderConfig(hidden_dim=256, num_heads=4, depth=8),
                head=vt.HeadConfig(hidden_dim=64, num_layers=2),
                sde_param_positive_dims=[0, 2], param_names=names, pretrain=vt.PretrainConfig(),
                checkpoint_every=EX_EVERY, device="cuda", **kw)

        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with timed_pretrain(torch) as pre:
            posterior = vt.infer(sde, obs, lik, prior, HORIZON,
                                 config(console=console, checkpoint_path=ckpt, callback=keep_step10))
        summary = posterior.summary(n_samples=500)
        diag = posterior.diagnostics()
        console.summary_table(summary, diag, param_names=names)
        if has_plot:
            fig = posterior.plot(n_trajectories=30, show=False)
            fig.savefig(os.path.join(tmp, "ou_posterior.png"), dpi=120)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        # 20 steps; summary(500) samples two chunks, plot(30) one
        expected = {"K1": EX_STEPS + 2 + int(has_plot), "K2": EX_STEPS,
                    "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}
        cfg = vt.PretrainConfig()
        log(f"[examples] pretrain (PretrainConfig(): global, {cfg.sweep_candidates} candidates at "
            f"population {cfg.batch_size}, {cfg.cem_rounds} CEM rounds): {pre['seconds']:.2f} s wall; "
            f"theta {pre['theta']}")
        log(f"[examples] infer (pretrain + {EX_STEPS} steps, checkpoints at {EX_EVERY} and {EX_STEPS}) "
            f"+ summary(500) + summary table + plot(30): {wall:.2f} s wall")
        log(f"[examples] launches {launches} (expected {expected})")
        if launches != expected:
            raise AssertionError(f"examples path did not run through exactly its kernels: {launches}")
        history = posterior.evidence_lower_bound_history
        if diag.n_iterations != EX_STEPS or not all(math.isfinite(v) for v in history):
            raise AssertionError("examples path: missing or non-finite ELBO")
        check_summary(torch, summary, (101, 1))
        log(f"[examples] posterior theta mean {summary.sde_parameter_mean.tolist()}; "
            f"final ELBO {diag.final_evidence_lower_bound:.3f}")

        saved = os.path.join(tmp, "ou_posterior.npz")
        posterior.save(saved)
        loaded = vt.VariationalPosterior.load(saved, posterior.model, prior, obs)
        from viforsdes_tpu_torch.utils.tree import tree_items

        for (path, a), (_, b) in zip(tree_items(loaded.ema_params), tree_items(posterior.ema_params)):
            if not torch.equal(a, b):
                raise AssertionError(f"examples: EMA leaf {path} differs after save and load")
        if loaded.evidence_lower_bound_history != history:
            raise AssertionError("examples: the ELBO history differs after save and load")
        log("[examples] save -> load: every EMA leaf bitwise equal, history equal")

        torch.cuda.synchronize()
        reset_counts()
        resumed = vt.infer(sde, obs, lik, prior, HORIZON,
                           config(console=vt.Console(enabled=False), checkpoint_path=ckpt, resume_from=ckpt10))
        torch.cuda.synchronize()
        r_launches = read_counts()
    r_hist = resumed.evidence_lower_bound_history
    rel = max(abs(a - b) / abs(b) for a, b in zip(r_hist, history))
    bitwise = r_hist == history
    log(f"[examples] resume from the step-{EX_EVERY} checkpoint to {EX_STEPS}: launches {r_launches}; "
        f"history against the unbroken run: max rel {rel:.2e} (bar {ELBO_RTOL}), bitwise {bitwise}")
    if len(r_hist) != EX_STEPS or rel > ELBO_RTOL:
        raise AssertionError("examples: the resumed run differs from the unbroken one")
    if r_launches["K1"] != EX_STEPS - EX_EVERY or r_launches["K2"] != EX_STEPS - EX_EVERY:
        raise AssertionError(f"examples: the resume did not run its {EX_STEPS - EX_EVERY} steps: {r_launches}")
    return {"pretrain_s": pre["seconds"], "wall_s": wall, "resume_bitwise": bitwise}


# ------------------------------------------------- several steps per graph

# (steps per call K, training steps per arm, flush interval): one eager warm
# chunk, then replays of the captured graph
GRAPH_OU = (10, 40, 10)
GRAPH_LZ = (5, 15, 5)
GRAPH_WINDOWS = 2  # K-step windows per arm and turn of the timing
PROFILE_TRIES = 3  # profiled replays, at most, for the kernel counts of [graph]

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


def trainer_state(trainer) -> dict:
    from viforsdes_tpu_torch.inference.optimizer import GROUPS

    s = trainer.opt_state
    out = {f"params/{g}": trainer.flat_params[g] for g in GROUPS}
    out.update({f"ema/{g}": trainer.flat_ema[g] for g in GROUPS})
    out.update({f"adam mu/{g}": s["mu"][g] for g in GROUPS})
    out.update({f"adam nu/{g}": s["nu"][g] for g in GROUPS})
    return out


def graph_pool_gib(torch, graph) -> float | str:
    """GiB reserved by ``graph``'s private memory pool (the allocator's
    segments of that pool), which no allocation statistic shows during a
    replay; "not measured" where the snapshot does not name its pools."""
    segments = torch.cuda.memory._snapshot()["segments"]
    if not segments or "segment_pool_id" not in segments[0]:
        return "not measured"
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == pool) / 2**30


def phase_graph(torch, label: str, make, k: int, n_steps: int, interval: int,
                expected_counts: dict) -> dict:
    """``steps_per_call=k`` (one CUDA graph of k steps, after one eager warm
    chunk) against ``steps_per_call=1`` from the same seed, ``n_steps`` steps
    each through ``train()``: ELBO histories, params, EMA and AdamW moments
    against the per-step arm (bitwise reported; held to ``ELBO_RTOL`` and the
    backward bars), each arm's peak memory; then ms/step of both arms in
    turns (per-step, graph, graph, per-step), ``GRAPH_WINDOWS`` windows of k
    steps each, every window ended by a synchronize; then a profile of one
    replay: device time, idle share, and K1-K7 counted by kernel name."""
    import re

    from torch.profiler import ProfilerActivity, profile

    arms = {"per-step": make(1), "graph": make(k)}
    histories, peaks = {}, {}
    reset_counts()
    for name, trainer in arms.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        histories[name] = trainer.train(update_interval=interval).evidence_lower_bound_history
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        how = f"one eager chunk, the capture, {n_steps // k - 1} replays" if name == "graph" else "one step a call"
        log(f"[graph] {label} {name}: {n_steps} steps through train() ({how}) in "
            f"{time.perf_counter() - t0:.2f} s; peak {peaks[name]:.3f} GiB allocated")
    launches = read_counts()  # both train() runs: the per-step arm, the eager chunk and the capture
    chunk = arms["graph"]._train_chunks.get(k)
    if chunk is None or chunk.graph is None:
        raise AssertionError(f"[graph] {label}: the {k}-step chunk was not captured")
    if arms["per-step"]._train_chunks:
        raise AssertionError(f"[graph] {label}: the per-step arm built a chunk")
    a, b = histories["per-step"], histories["graph"]
    if len(a) != n_steps or len(b) != n_steps or not all(math.isfinite(v) for v in a + b):
        raise AssertionError(f"[graph] {label}: missing or non-finite ELBO")
    rel = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    bitwise = {"history": a == b}
    worst = {}
    sa, sb = trainer_state(arms["per-step"]), trainer_state(arms["graph"])
    for key in sa:
        bitwise[key] = bool(torch.equal(sa[key], sb[key]))
        worst[key] = max_err(sb[key], sa[key], BWD_RTOL, BWD_ATOL, f"[graph] {label} {key}")
    log(f"[graph] {label}: ELBO history max rel {rel:.3e} (bar {ELBO_RTOL}); bitwise equal: {json.dumps(bitwise)}; "
        f"max |err| {json.dumps(worst)}")
    if rel > ELBO_RTOL:
        raise AssertionError(f"[graph] {label}: the graph arm's ELBO history differs from the per-step arm's")

    # timing in turns, from the next step of each arm
    step = {name: trainer._completed_steps for name, trainer in arms.items()}
    samples = {name: [] for name in arms}

    def window(name: str) -> float:
        trainer = arms[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "graph":
            chunk(step[name])
        else:
            for i in range(k):
                trainer.train_step(step[name] + i)
        torch.cuda.synchronize()
        step[name] += k
        return (time.perf_counter() - t0) * 1e3 / k

    for name in ("per-step", "graph", "graph", "per-step"):
        samples[name] += [window(name) for _ in range(GRAPH_WINDOWS)]
    stats = {}
    for name, v in samples.items():
        q = statistics.quantiles(v, n=4)
        stats[name] = {"median_ms": statistics.median(v), "q1_ms": q[0], "q3_ms": q[2], "n_windows": len(v),
                       "steps_per_window": k, "peak_gib": peaks[name]}
    pool = graph_pool_gib(torch, chunk.graph)
    log(f"[graph] {label} ms/step (windows of {k} steps, synchronized at each window's end; peak_gib: "
        f"allocated during the train() run, the capture included): " + json.dumps(stats)
        + f"; the graph's private pool holds {pool} GiB")

    # one replay under the profiler; the profiler can drop a few of a replay's
    # ~12,000 kernel records (seen once at Lorenz: 4 of 80 K3 and 1 of 40 K5),
    # so a replay whose counts miss is profiled again, up to PROFILE_TRIES
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk(step["graph"])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if not events:
            raise AssertionError(f"[graph] {label}: the profile of one replay holds no device kernel")
        counts = {kern: sum(e.count for e in events if re.search(pattern, e.key))
                  for kern, pattern in KERNEL_NAMES.items()}
        if counts == expected_counts:
            break
        log(f"[graph] {label}: profile {attempt} of one replay counted {json.dumps(counts)}, expected "
            f"{json.dumps(expected_counts)}" + ("; profiling another replay" if attempt < PROFILE_TRIES else ""))
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    device_ms = sum(getattr(e, attr) for e in events) / 1e3 / k
    kernel_ms = {kern: sum(getattr(e, attr) for e in events if re.search(pattern, e.key)) / 1e3 / k
                 for kern, pattern in KERNEL_NAMES.items()}
    graph_ms = stats["graph"]["median_ms"]
    idle = max(0.0, 1 - device_ms / graph_ms)
    log(f"[graph] {label} profile of one replay ({k} steps, with the draws and input copies before it): "
        f"device kernel time {device_ms:.3f} ms/step in {sum(e.count for e in events)} launches; against "
        f"the unprofiled {graph_ms:.3f} ms/step: device idle share {idle:.3f}; kernels by name {json.dumps(counts)} "
        f"(expected {json.dumps(expected_counts)})")
    log(f"[graph] {label} K1-K7 ms/step in that replay: " + json.dumps({n: round(v, 4) for n, v in kernel_ms.items()}))
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:8]:
        log(f"[graph]   {getattr(e, attr) / k / 1e3:8.3f} ms/step  x{e.count:<4d} {e.key[:90]}")
    if counts != expected_counts:
        raise AssertionError(f"[graph] {label}: kernel counts of one replay {counts}, expected {expected_counts}")
    return {"elbo_rel": rel, "bitwise": bitwise, "stats": stats, "pool_gib": pool, "device_ms": device_ms,
            "idle": idle, "counts": counts, "kernel_ms": kernel_ms, "launches": launches}


def phase_graph_ou(torch, vt) -> dict:
    k, n, interval = GRAPH_OU
    zero = {"K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}
    return phase_graph(torch, "OU bench config", lambda spc: make_trainer(vt, "auto", n, steps_per_call=spc),
                       k, n, interval, {"K1": k, "K2": k, **zero})


def phase_graph_lorenz(torch, vt, compute_dtype: str = "bfloat16") -> dict:
    k, n, interval = GRAPH_LZ
    depth = ENC["depth"]
    expected = {"K1": k, "K2": k, "K3": 2 * depth * k, "K4": 2 * depth * k,
                "K5": depth * k, "K6": depth * k, "K7": depth * k}
    label = "Lorenz-63" if compute_dtype == "bfloat16" else f"Lorenz-63 {compute_dtype}"
    return phase_graph(torch, label, lambda spc: lorenz_trainer(torch, vt, "auto", compute_dtype, n_iterations=n,
                                                                steps_per_call=spc),
                       k, n, interval, expected)


def phase_fp32(torch, vt) -> dict:
    """``[fp32]``: the Lorenz-63 long grid at full width with
    ``TrainingConfig(compute_dtype="float32")``: the encoder's attention runs
    the 3xTF32 K5, K6 and K7. ``phase_graph``'s graph of 5 steps against one
    step a call from one seed, with every kernel's launches over both
    ``train()`` runs; fails unless K5, K6 and K7 ran."""
    t0 = time.perf_counter()
    out = phase_graph_lorenz(torch, vt, "float32")
    n = out["launches"]
    st = out["stats"]
    log(f"[fp32] Lorenz-63 fp32 (B={LZ_BATCH}, 2001 tokens): graph {st['graph']['median_ms']:.2f} ms/step, per-step "
        f"{st['per-step']['median_ms']:.2f}; K5/K6/K7 ms/step in one replay {out['kernel_ms']['K5']:.3f} / "
        f"{out['kernel_ms']['K6']:.3f} / {out['kernel_ms']['K7']:.3f}; launches over both train() runs "
        f"{json.dumps(n)}; peak {st['graph']['peak_gib']:.3f} GiB (per-step {st['per-step']['peak_gib']:.3f}), "
        f"pool {out['pool_gib']} GiB; {time.perf_counter() - t0:.1f} s")
    if not (n["K5"] and n["K6"] and n["K7"]):
        raise AssertionError(f"[fp32] the fp32 Lorenz path launched no K5, K6 or K7: {n}")
    return out


# ------------------------------------------------------ diffusion-matched head

MATCHED_STEPS = 5


def phase_matched(torch, vt) -> dict:
    """``infer()`` with ``HeadConfig(cholesky="matched")`` at the OU bench
    configuration: the user's diffusion runs inside the head's loop, so no
    path-sampler kernel launches; ``sampler="pallas"`` is refused."""
    sde, obs, lik, prior = ou_problem(vt)

    def config(**head):
        return vt.InferenceConfig(
            training=vt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=MATCHED_STEPS),
            encoder=vt.EncoderConfig(**ENC),
            head=vt.HeadConfig(**HEAD, cholesky="matched", **head),
            sde_param_positive_dims=[0, 2],
            console=vt.Console(enabled=False),
            device="cuda",
        )

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    posterior = vt.infer(sde, obs, lik, prior, HORIZON, config())
    summary = posterior.summary(n_samples=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    history = posterior.evidence_lower_bound_history
    log(f"[matched] infer ({MATCHED_STEPS} steps) + summary(64): {wall:.2f} s wall; ELBO history "
        f"{[round(v, 3) for v in history]}; launches {launches} (expected none)")
    if len(history) != MATCHED_STEPS or not all(math.isfinite(v) for v in history):
        raise AssertionError("[matched] missing or non-finite ELBO")
    if any(launches.values()):
        raise AssertionError(f"[matched] the matched head launched kernels: {launches}")
    check_summary(torch, summary, (101, 1))
    try:
        vt.infer(sde, obs, lik, prior, HORIZON, config(sampler="pallas"))
    except ValueError as err:
        log(f"[matched] sampler='pallas' refused: {err}")
    else:
        raise AssertionError("[matched] sampler='pallas' was not refused")
    return {"wall_s": wall, "history": history}


# ------------------------------------------------------- the quality ladder

# the sampler shapes the ladder's recipes add (examples_torch/quality_eval.py
# RUNGS), held against the plain version: label -> (B, T, D, H, L, dt)
LADDER_SHAPES = {
    "lorenz r3": (32, 2000, 3, 128, 3, LZ_DT),   # head 128 x 3, 4 theta draws x IW-8, full Cholesky
    "highdim r5": (512, 100, 32, 128, 2, DT),    # d=32, head 128 x 2, batch 512 (64 draws x IW-8)
    "sir": (64, 400, 2, 64, 2, 0.02),
    "lv": (24, 400, 2, 64, 2, 0.1),
}
LADDER_STEPS, LADDER_K = 20, 10  # training steps a rung, LADDER_K steps a graph
LADDER_WINDOWS = 2               # timed replays of LADDER_K steps after a rung's run
LADDER_EXAMPLE_STEPS = 3         # training steps of each example's main()
# every example but highdim_ou_dp: its batch of 4096 in one pass does not fit
# one card; [dp] trains its configuration in 4 microbatches
LADDER_EXAMPLES = ("ornstein_uhlenbeck", "lotka_volterra", "sir_epidemic", "lorenz63")
# the rungs on the flash path (K3-K7): more than 512 grid tokens
LADDER_FLASH_RUNGS = ("lorenz",)


def phase_ladder_sampler(torch) -> tuple[float, float]:
    """K1 and K2 against the plain loop at the ladder's sampler shapes, on
    the plan the card picks (equal to its mirror)."""
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    n_sms, optin = device_limits(torch)
    dev = torch.cuda.current_device()
    worst_f = worst_b = 0.0
    for i, (label, (B, T, D, H, L, dt)) in enumerate(LADDER_SHAPES.items()):
        spec, w, x0, gc, eps, cot = sampler_case(torch, B, T, D, H, L, "full", 40 + i, dt=dt, on_card=True)
        slots = ss.cluster_slots(spec, dev)
        fplan, bplan = ss.forward_plan(spec, B, dev), ss.backward_plan(spec, B, dev)
        check_plan(fplan, ss.plan_forward(spec, B, n_sms, optin, slots["fwd"]), f"K1 {label}")
        check_plan(bplan, ss.plan_backward(spec, B, n_sms, optin, slots["bwd"]), f"K2 {label}")
        out = ss.sampler_forward(spec, w, x0, gc, eps, save_h=True)
        ref = ss._forward_plain(spec, w, x0, gc, eps, save_h=True)
        torch.cuda.synchronize()
        for name in ("paths", "raw", "chol_vals", "h_all"):
            worst_f = max(worst_f, max_err(getattr(out, name), getattr(ref, name), FWD_RTOL, FWD_ATOL,
                                           f"K1 {name} {label}"))
        got, want = (sampler_grads(torch, fn, spec, w, x0, gc, eps, cot)
                     for fn in (ss.sample_paths, ss.sample_paths_scan))
        torch.cuda.synchronize()
        for name, a, r in zip(["x0", "gates_const", "eps", *ss.SamplerWeights._fields], got, want):
            if a.numel():
                worst_b = max(worst_b, max_err(a, r, BWD_RTOL, BWD_ATOL, f"K2 d_{name} {label}"))
        log(f"[ladder] K1/K2 {label} B={B} T={T} D={D} H={H} L={L}: within the bars (max |err| so far "
            f"{worst_f:.3e} / {worst_b:.3e}); K1 plan {plan_text(fplan)}, K2 plan {plan_text(bplan)} "
            f"(the mirrors')")
    return worst_f, worst_b


@contextlib.contextmanager
def trainers_seen():
    """Every trainer that ``train()`` runs inside the block, in order."""
    from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer

    seen: list = []
    saved = VariationalInferenceTrainer.train

    def train(self, *args, **kwargs):
        seen.append(self)
        return saved(self, *args, **kwargs)

    VariationalInferenceTrainer.train = train
    try:
        yield seen
    finally:
        VariationalInferenceTrainer.train = saved


def replay_ms(torch, trainer, first_step: int) -> list[float]:
    """ms/step of ``LADDER_WINDOWS`` replays of the trainer's captured
    chunk of ``LADDER_K`` steps, each ended by a synchronize."""
    chunk = trainer._get_train_chunk(LADDER_K)
    out = []
    for w in range(LADDER_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(first_step + w * LADDER_K)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / LADDER_K)
    return out


def release(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_ladder_rungs(torch, smi: str, out_dir: str) -> dict:
    """Every rung of the ladder at its committed recipe and full width,
    through the harness's own functions, cut to ``LADDER_STEPS`` steps in
    graphs of ``LADDER_K``: its real pretraining, finite ELBOs, K1/K2 (and
    on the long grid K3-K7) launched, the result's keys those of the JAX
    package's committed result; then its ms/step over replays of the graph,
    its pretraining seconds and peak memory."""
    from examples_torch import quality_eval as qe

    rows = {}
    for name, (fn, kw, n_committed, ref) in qe.RUNGS.items():
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        opts = qe.RunOptions(steps_per_call=LADDER_K, out_dir=out_dir)
        t0 = time.perf_counter()
        with timed_pretrain(torch) as pre, trainers_seen() as seen:
            result = fn(LADDER_STEPS, **kw, opts=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        (trainer,) = seen
        history = trainer.evidence_lower_bound_history
        if len(history) != LADDER_STEPS or not all(math.isfinite(v) for v in history):
            raise AssertionError(f"[ladder] {name}: missing or non-finite ELBO: {history}")
        flash = name in LADDER_FLASH_RUNGS
        if not (launches["K1"] and launches["K2"]):
            raise AssertionError(f"[ladder] {name}: K1 or K2 launched no time: {launches}")
        if any(bool(launches[k]) != flash for k in ("K3", "K4", "K5", "K6", "K7")):
            raise AssertionError(f"[ladder] {name}: K3-K7 {'not all' if flash else 'some'} launched: {launches}")
        with open(os.path.join(REPO, ref)) as f:
            committed = json.load(f)
        missing = sorted(set(committed) - set(result))
        if missing or set(result["posterior_mean"]) != set(committed["posterior_mean"]):
            raise AssertionError(f"[ladder] {name}: the result lacks the JAX schema's keys {missing}")
        ms = replay_ms(torch, trainer, LADDER_STEPS)
        grid = trainer.model.encoder.n_grid
        del trainer, seen
        rows[name] = {"ms_per_step": statistics.median(ms), "windows_ms": ms, "pretrain_s": pre.get("seconds"),
                      "peak_gib": peak, "wall_s": wall, "grid": grid, "launches": launches,
                      "elbo_last": history[-1], "committed_steps": n_committed}
        log(f"[ladder] {name} ({grid} tokens; {n_committed} steps committed, {LADDER_STEPS} run, "
            f"{LADDER_K} a graph): pretrain {'none' if 'seconds' not in pre else f'{pre['seconds']:.2f} s'}, "
            f"infer + summary {wall:.2f} s; "
            f"replays {[round(v, 3) for v in ms]} ms/step; peak {peak:.3f} GiB; launches {launches}; "
            f"ELBO {history[0]:.3f} -> {history[-1]:.3f}; theta mean {result['posterior_mean']}; "
            f"JAX schema keys present; {smi}")
    release(torch)
    return rows


def phase_ladder_examples(torch, vt) -> dict:
    """Each example's ``main()`` (``examples_torch/``) on the card at its own
    configuration, with ``infer`` cut to ``LADDER_EXAMPLE_STEPS`` steps: the
    console, ``summary(500)``, the summary table, ``plot(30)`` (where
    matplotlib is present) and ``save``."""
    import importlib
    import importlib.util
    import tempfile

    from viforsdes_tpu_torch.posterior.posterior import VariationalPosterior

    has_plot = importlib.util.find_spec("matplotlib") is not None
    has_rich = importlib.util.find_spec("rich") is not None
    real_infer, real_plot, real_console = vt.infer, VariationalPosterior.plot, vt.Console
    seen: list = []

    def infer(**kw):
        c = kw["config"]
        kw["config"] = dataclasses.replace(
            c, training=c.training.model_copy(update={"n_iterations": LADDER_EXAMPLE_STEPS}))
        seen.append(real_infer(**kw))
        return seen[-1]

    class NoFigure:
        def savefig(self, *args, **kwargs) -> None:
            pass

    vt.infer = infer
    if not has_rich:
        vt.Console = lambda enabled=True: real_console(enabled=False)
    if not has_plot:
        VariationalPosterior.plot = lambda self, n_trajectories=50, show=True: NoFigure()
    cwd = os.getcwd()
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            for module in LADDER_EXAMPLES:
                release(torch)
                reset_counts()
                t0 = time.perf_counter()
                importlib.import_module(f"examples_torch.{module}").main()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
                history = seen[-1].evidence_lower_bound_history
                if len(history) != LADDER_EXAMPLE_STEPS or not all(math.isfinite(v) for v in history):
                    raise AssertionError(f"[ladder] example {module}: missing or non-finite ELBO {history}")
                if not (launches["K1"] and launches["K2"]):
                    raise AssertionError(f"[ladder] example {module}: K1 or K2 launched no time: {launches}")
                files = sorted(os.listdir(tmp))
                log(f"[ladder] example {module}: main() with {LADDER_EXAMPLE_STEPS} steps in {wall:.2f} s; "
                    f"ELBO {[round(v, 3) for v in history]}; launches {launches}; wrote {files}")
                out[module] = {"wall_s": wall, "launches": launches}
                for f in files:
                    os.remove(os.path.join(tmp, f))
            seen.clear()
    finally:
        os.chdir(cwd)
        vt.infer, vt.Console = real_infer, real_console
        VariationalPosterior.plot = real_plot
    log(f"[ladder] examples: rich {'present' if has_rich else 'absent: the console runs disabled'}; "
        f"matplotlib {'present' if has_plot else 'absent: plot() returns no figure'}; "
        f"highdim_ou_dp's main() not run (batch 4096 in one pass; [dp] trains its configuration)")
    release(torch)
    return out


def phase_ladder(torch, vt, smi: str) -> dict:
    import tempfile

    t0 = time.perf_counter()
    errs = phase_ladder_sampler(torch)
    with tempfile.TemporaryDirectory() as tmp:
        rungs = phase_ladder_rungs(torch, smi, tmp)
    examples = phase_ladder_examples(torch, vt)
    log(f"[ladder] {smi}: rungs ms/step (replayed graphs of {LADDER_K}) "
        f"{ {k: round(v['ms_per_step'], 3) for k, v in rungs.items()} }; pretrain s "
        f"{ {k: None if v['pretrain_s'] is None else round(v['pretrain_s'], 2) for k, v in rungs.items()} }; "
        f"peak GiB { {k: round(v['peak_gib'], 3) for k, v in rungs.items()} }; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"errs": errs, "rungs": rungs, "examples": examples}


# ------------------------------------------- the LV rung's bf16 step (card vs CPU)

# The card's bf16 gradient error against its own fp32 gradient, over the CPU's
# against the CPU's fp32 gradient (both in total over every leaf and over the
# encoder's leaves), at most this: the card's bf16 step may round no more than
# the CPU's plain path does on the same weights and draws. Both ratios were
# 0.999 on an NVIDIA H100 80GB HBM3 at 700 W; the bar leaves room for another
# choice of cuBLAS algorithms. The same bar holds each leaf's error over the
# CPU's (at most 1.061 there, on 128 leaves), above a floor: a sum of one
# bias's gradient in bf16 moves that leaf alone, by far more than the floor,
# and the total hardly at all.
LV_BF16_BAR = 1.5
# a leaf's card error under this passes whatever the CPU's: a quarter of one
# bf16 rounding (2**-8); the head's and theta's leaves, which the bf16 step
# reaches only through the context, read 4e-5 to 1.1e-3 on both sides
LV_LEAF_FLOOR = 1e-3
# ``v_residual_lambda``'s floor: each is one scalar whose gradient subtracts
# two sums over the batch and grid, 7.7e-3 to 2.8e-2 on both sides; a bf16
# sum of it misses by 1.05 (the JAX package's CPU step, ROADMAP)
LV_VRES_FLOOR = 0.1
# the card's fp32 step against the CPU's: the ELBO to ELBO_RTOL, the total
# gradient error at most this (5.2e-7 on that card)
LV_FP32_GRAD = 1e-5


def lv_bf16_failures(out: dict) -> list[str]:
    """What fails ``[lv bf16]``'s bars in ``tools/lv_step.py``'s ``run``
    output: non-finite errors; the card's bf16 error over the CPU's, in
    total, over the encoder or on any leaf above its floor, past
    ``LV_BF16_BAR``; the card's fp32 step away from the CPU's."""
    bad = []
    for side in ("cuda", "cpu"):
        if not all(math.isfinite(v) for v in (out[side]["elbo_rel"], out[side]["all"], out[side]["encoder"],
                                              *out[side]["leaf"].values())):
            bad.append(f"{side}: non-finite errors")
    card, cpu = out["cuda"], out["cpu"]
    for w in ("all", "encoder"):
        if card[w] > LV_BF16_BAR * cpu[w]:
            bad.append(f"{w}: card {card[w]:.4e} over {LV_BF16_BAR} x CPU {cpu[w]:.4e}")
    for p, e in card["leaf"].items():
        floor = LV_VRES_FLOOR if p.endswith("v_residual_lambda") else LV_LEAF_FLOOR
        if e > max(LV_BF16_BAR * cpu["leaf"][p], floor):
            bad.append(f"leaf {p}: card {e:.4e} over max({LV_BF16_BAR} x CPU {cpu['leaf'][p]:.4e}, {floor})")
    cross = out["fp32_card_vs_cpu"]
    if cross["elbo_rel"] > ELBO_RTOL or cross["all"] > LV_FP32_GRAD:
        bad.append(f"the card's fp32 step differs from the CPU's: ELBO {cross['elbo_rel']:.3e}, "
                   f"gradient {cross['all']:.3e}")
    return bad


def phase_lv_bf16(torch) -> None:
    """``[lv bf16]``: one step of the LV rung's problem at its full width
    (SiT 256 x 4 x 8, GRU 64 x 2, 401 tokens, batch 24) on one set of weights
    and draws, in bf16 and fp32 on the card (the kernel path: K1/K2, the
    dense SDPA, cuBLAS) and on this machine's CPU (the plain path), each
    side's bf16 gradient against its own fp32 gradient (``tools/lv_step.py``),
    held to ``lv_bf16_failures``'s bars."""
    from tools import lv_step

    reset_counts()
    out = lv_step.run(log=log, after_card=read_counts)
    launches = out["launches"]
    if not (launches["K1"] and launches["K2"]) or any(launches[k] for k in ("K3", "K4", "K5", "K6", "K7")):
        raise AssertionError(f"[lv bf16] the card's steps should run K1/K2 and no attention kernel: {launches}")
    card, cpu = out["cuda"], out["cpu"]
    leaf = max(card["leaf"], key=lambda p: card["leaf"][p] / max(cpu["leaf"][p], 1e-30))
    log(f"[lv bf16] card over CPU: total {card['all'] / cpu['all']:.3f}, encoder "
        f"{card['encoder'] / cpu['encoder']:.3f}, largest leaf {card['leaf'][leaf] / cpu['leaf'][leaf]:.3f} "
        f"({leaf}) (bar {LV_BF16_BAR}; leaf floors {LV_LEAF_FLOOR}, v_residual_lambda {LV_VRES_FLOOR}); "
        f"launches {launches}")
    bad = lv_bf16_failures(out)
    if bad:
        raise AssertionError("[lv bf16] " + "; ".join(bad))


# ------------------------------------------------- data parallel (parallel/)

# examples/highdim_ou_dp.py's configuration: d=32, batch 4096 (global), the
# example's encoder and head; cut to DP_STEPS steps (the example runs 5000) in
# graphs of DP_K steps, and to DP_ACCUM microbatches a step, since one card
# cannot hold 4096 paths in one pass
DP_DIM, DP_BATCH, DP_ACCUM = 32, 4096, 4
DP_STEPS, DP_K = 10, 5
DP_ENC = dict(hidden_dim=256, num_heads=4, depth=8)
DP_WINDOWS = 2        # timed windows of DP_K steps per arm
DP_GLOO_STEPS = 5     # steps of the two-rank gloo runs at the OU bench config
# the gloo runs' layouts: the bench batch split in two, and one whose
# microbatch does not split evenly (3 importance groups of 16 paths a
# microbatch over 2 ranks: 2 and 1)
DP_GLOO_CASES = {"even": {}, "uneven": {"batch_size": 96, "grad_accum_steps": 2, "iw_samples": 16}}


def dp_problem(torch, vt):
    """The d=32 OU of examples/highdim_ou_dp.py (shared kappa, mu, sigma;
    diffusion sigma I), observed every 1.0 on a path simulated at dt 0.01
    from a seeded generator."""

    class HighDimOU:
        state_dim = DP_DIM
        sde_param_dim = 3

        def drift(self, x, p):
            return p[..., 0:1] * (p[..., 1:2] - x)

        def diffusion(self, x, p):
            eye = torch.eye(DP_DIM, dtype=x.dtype, device=x.device)
            return p[..., 2:3][..., None] * eye

    sde = HighDimOU()
    gen = torch.Generator().manual_seed(3)
    traj = vt.euler_maruyama(sde, 2.0 * torch.ones(1, DP_DIM), torch.tensor([[1.2, 0.8, 0.5]]), HORIZON, 0.01,
                             generator=gen)
    idx = list(range(0, traj.shape[1], 100))
    if not bool(torch.isfinite(traj).all()):
        raise AssertionError("[dp] observations: non-finite simulation")
    observations = vt.Observations(times=[i * 0.01 for i in idx], values=traj[0, idx])
    return (sde, observations, vt.GaussianObservationLikelihood(variance=0.1),
            vt.Prior(type=vt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3))


@contextlib.contextmanager
def recorded_chunks():
    """The training chunks called inside the block (``TrainChunk.__call__``,
    wrapped for the block), in the order of their first call."""
    from viforsdes_tpu_torch.inference.chunk import TrainChunk

    seen: list = []
    saved = TrainChunk.__call__

    def call(self, first_step):
        if not any(c is self for c in seen):
            seen.append(self)
        return saved(self, first_step)

    TrainChunk.__call__ = call
    try:
        yield seen
    finally:
        TrainChunk.__call__ = saved


@contextlib.contextmanager
def counted_all_reduces(torch):
    """Calls of ``torch.distributed.all_reduce`` inside the block: all of
    them, and those made while the current stream was capturing a graph."""
    import torch.distributed as dist

    counts = {"calls": 0, "captured": 0}
    saved = dist.all_reduce

    def counted(*args, **kwargs):
        counts["calls"] += 1
        counts["captured"] += int(torch.cuda.is_current_stream_capturing())
        return saved(*args, **kwargs)

    dist.all_reduce = counted
    try:
        yield counts
    finally:
        dist.all_reduce = saved


def dp_windows(torch, chunk, first_step: int) -> list[float]:
    """ms/step of ``DP_WINDOWS`` replays of ``chunk``, each ended by a
    synchronize."""
    out = []
    for w in range(DP_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(first_step + w * DP_K)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / DP_K)
    return out


def dp_arm(torch, vt, mesh, label: str):
    """``infer()`` at the d=32 configuration, ``DP_STEPS`` steps in graphs of
    ``DP_K``, on ``mesh`` (or none): its posterior, its chunk and what it
    measured (the state after the run copied to the host)."""
    sde, obs, lik, prior = dp_problem(torch, vt)
    config = vt.InferenceConfig(
        training=vt.TrainingConfig(time_step=DT, batch_size=DP_BATCH, n_iterations=DP_STEPS,
                                   grad_accum_steps=DP_ACCUM, steps_per_call=DP_K),
        encoder=vt.EncoderConfig(**DP_ENC),
        head=vt.HeadConfig(**HEAD),
        sde_param_positive_dims=[0, 2],
        param_names=["kappa", "mu", "sigma"],
        console=vt.Console(enabled=False),
        mesh=mesh,
        device="cuda",
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with recorded_chunks() as chunks, counted_all_reduces(torch) as reduces:
        posterior = vt.infer(sde, obs, lik, prior, HORIZON, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_counts()
    if len(chunks) != 1 or chunks[0].length != DP_K or chunks[0].graph is None:
        raise AssertionError(f"[dp] {label}: expected one captured {DP_K}-step chunk, got {len(chunks)}")
    chunk = chunks[0]
    history = posterior.evidence_lower_bound_history
    state = {k: v.cpu() for k, v in trainer_state(chunk.trainer).items()}
    pool = graph_pool_gib(torch, chunk.graph)
    log(f"[dp] {label}: infer() {DP_STEPS} steps (one eager chunk of {DP_K}, the capture, "
        f"{DP_STEPS // DP_K - 1} replay) in {wall:.2f} s; peak {peak:.3f} GiB allocated; the graph's private "
        f"pool holds {pool} GiB; launches {launches}; all_reduce calls {reduces['calls']}, "
        f"{reduces['captured']} of them inside the capture")
    log(f"[dp] {label}: ELBO history {[round(v, 3) for v in history]}")
    if len(history) != DP_STEPS or not all(math.isfinite(v) for v in history):
        raise AssertionError(f"[dp] {label}: missing or non-finite ELBO")
    # the eager chunk and the capture each call the wrappers once per
    # microbatch and step; a replay calls none
    per_chunk = DP_ACCUM * DP_K
    expected = {"K1": 2 * per_chunk, "K2": 2 * per_chunk, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}
    if launches != expected:
        raise AssertionError(f"[dp] {label}: launches {launches}, expected {expected}")
    # per step: one all-reduce per parameter group and one of the ELBO terms
    want = {"calls": 2 * 3 * DP_K, "captured": 3 * DP_K} if mesh is not None else {"calls": 0, "captured": 0}
    if reduces != want:
        raise AssertionError(f"[dp] {label}: all_reduce calls {reduces}, expected {want}")
    return posterior, chunk, {"wall_s": wall, "peak_gib": peak, "pool_gib": pool, "history": history,
                              "state": state, "launches": launches}


def dp_profile(torch, chunk, first_step: int) -> dict:
    """One replay under the profiler: device time, K1/K2 and NCCL kernels
    counted by name, K1+K2's share of the device time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk(first_step)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not events:
        raise AssertionError("[dp] the profile of one replay holds no device kernel")
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    total_us = sum(getattr(e, attr) for e in events)
    counts, us = {}, {}
    for kern in ("K1", "K2"):
        hit = [e for e in events if re.search(KERNEL_NAMES[kern], e.key)]
        counts[kern], us[kern] = sum(e.count for e in hit), sum(getattr(e, attr) for e in hit)
    nccl = [e for e in events if "nccl" in e.key.lower()]
    counts["nccl"] = sum(e.count for e in nccl)
    share = (us["K1"] + us["K2"]) / total_us
    log(f"[dp] profile of one replay ({DP_K} steps): device kernel time {total_us / 1e3 / DP_K:.3f} ms/step in "
        f"{sum(e.count for e in events)} launches; by name {json.dumps(counts)} "
        f"(K1/K2 expected {DP_ACCUM * DP_K} each); K1 {us['K1'] / 1e3 / DP_K:.3f} + K2 "
        f"{us['K2'] / 1e3 / DP_K:.3f} ms/step: {share:.3f} of the device time; NCCL kernels "
        f"{[e.key[:60] for e in nccl]}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:8]:
        log(f"[dp]   {getattr(e, attr) / DP_K / 1e3:8.3f} ms/step  x{e.count:<4d} {e.key[:90]}")
    if counts["K1"] != DP_ACCUM * DP_K or counts["K2"] != DP_ACCUM * DP_K:
        raise AssertionError(f"[dp] kernel counts of one replay {counts}")
    return {"device_ms": total_us / 1e3 / DP_K, "counts": counts, "k1k2_share": share,
            "k1_ms": us["K1"] / 1e3 / DP_K, "k2_ms": us["K2"] / 1e3 / DP_K}


def eager_nccl_kernels(torch) -> int:
    """NCCL kernels launched by one eager in-place ``all_reduce`` (SUM) of
    4 MB on the default group, counted in a profile."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dist.all_reduce(x)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA" and "nccl" in e.key.lower())


def phase_dp_mesh(torch, vt) -> dict:
    """The d=32, batch-4096 configuration through ``infer(mesh=make_data_mesh())``
    (a world of one process, NCCL, the all-reduces inside the graphs) and
    through ``infer(mesh=None)`` from the same seed, one arm after the other:
    bitwise equal; each arm's ms/step, peak and graph pool; a profile of one
    replay; on the mesh arm summary, diagnostics and save -> load."""
    import gc
    import tempfile

    import torch.distributed as dist

    from viforsdes_tpu_torch.utils.tree import tree_items

    mesh = vt.make_data_mesh()
    log(f"[dp] mesh {mesh.mesh.tolist()} over {dist.get_world_size()} process(es), backend "
        f"{dist.get_backend()}; cuts: grad_accum_steps={DP_ACCUM} (4096 paths do not fit one pass), "
        f"{DP_STEPS} steps instead of 5000, steps_per_call={DP_K}")
    out = {}
    posterior, chunk, arm = dp_arm(torch, vt, mesh, "mesh")
    log(f"[dp] one eager all_reduce on this world of {dist.get_world_size()} launches "
        f"{eager_nccl_kernels(torch)} NCCL kernel(s)")
    reset_counts()
    t0 = time.perf_counter()
    summary = posterior.summary(n_samples=500)
    diag = posterior.diagnostics()
    with tempfile.TemporaryDirectory() as tmp:
        saved = os.path.join(tmp, "highdim_ou_posterior.npz")
        posterior.save(saved)
        loaded = vt.VariationalPosterior.load(saved, posterior.model, posterior.prior, posterior.observations)
    torch.cuda.synchronize()
    for (path, a), (_, b) in zip(tree_items(loaded.ema_params), tree_items(posterior.ema_params)):
        if not torch.equal(a, b):
            raise AssertionError(f"[dp] EMA leaf {path} differs after save and load")
    check_summary(torch, summary, (101, DP_DIM))
    log(f"[dp] mesh: summary(500) + diagnostics + save -> load in {time.perf_counter() - t0:.2f} s "
        f"(launches {read_counts()}); EMA leaves bitwise equal after load; theta mean "
        f"{summary.sde_parameter_mean.tolist()} (true 1.2, 0.8, 0.5 after 5000 steps); final ELBO "
        f"{diag.final_evidence_lower_bound:.3f}")
    arm["profile"] = dp_profile(torch, chunk, DP_STEPS)
    arm["window_ms"] = dp_windows(torch, chunk, DP_STEPS + DP_K)
    out["mesh"] = arm
    del posterior, chunk, loaded, summary
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    posterior, chunk, arm = dp_arm(torch, vt, None, "no mesh")
    arm["window_ms"] = dp_windows(torch, chunk, DP_STEPS)
    out["none"] = arm
    del posterior, chunk
    gc.collect()
    torch.cuda.empty_cache()

    bitwise = {"history": out["mesh"]["history"] == out["none"]["history"]}
    for key, a in out["mesh"]["state"].items():
        bitwise[key] = bool(torch.equal(a, out["none"]["state"][key]))
    for name in ("mesh", "none"):
        w = out[name]["window_ms"]
        out[name]["median_ms"] = statistics.median(w)
    log(f"[dp] mesh against no mesh, same seed: bitwise equal {json.dumps(bitwise)}; ms/step (windows of "
        f"{DP_K} replayed steps, synchronized): mesh {out['mesh']['window_ms']}, no mesh {out['none']['window_ms']}")
    if not all(bitwise.values()):
        raise AssertionError("[dp] the world-1 mesh run differs from the run without a mesh")
    return out


def dp_gloo_child(rank: int, store_path: str, out_dir: str) -> None:
    """One of two ranks sharing the card over gloo: the OU bench config at
    each of ``DP_GLOO_CASES``, one step per call."""
    import datetime

    import torch
    import torch.distributed as dist

    import viforsdes_tpu_torch as vt

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = vt.make_data_mesh()
        out = {"backend": dist.get_backend()}
        for case, training in DP_GLOO_CASES.items():
            trainer = make_trainer(vt, "auto", DP_GLOO_STEPS, mesh=mesh, steps_per_call=1, **training)
            out[case] = {"history": trainer.train().evidence_lower_bound_history, "groups": trainer._groups,
                         "state": {k: v.cpu() for k, v in trainer_state(trainer).items()}}
        try:
            make_trainer(vt, "auto", DP_GLOO_STEPS, mesh=mesh, steps_per_call=5)
            out["refused"] = ""
        except ValueError as err:
            out["refused"] = str(err)
        torch.cuda.synchronize()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_dp_gloo(torch, vt) -> dict:
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device), spawned on a ``FileStore``: the OU bench config at batch 128
    global, and a layout whose microbatch does not split evenly over the two
    ranks, each against the run without a mesh from the same seed. This
    checks the semantics, not the speed."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(dp_gloo_child, args=(os.path.join(tmp, "store"), tmp), nprocs=2, start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    out = {"wall_s": wall}
    for case, training in DP_GLOO_CASES.items():
        ref = make_trainer(vt, "auto", DP_GLOO_STEPS, steps_per_call=1, **training)
        ref_history = ref.train().evidence_lower_bound_history
        ref_state = trainer_state(ref)
        got = [r[case] for r in ranks]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got[0]["history"], ref_history))
        worst = {key: max_err(got[0]["state"][key].cuda(), ref_state[key], BWD_RTOL, BWD_ATOL,
                              f"[dp] gloo {case} rank 0 {key} against the run without a mesh")
                 for key in ref_state}
        same = {key: bool(torch.equal(a, got[1]["state"][key])) for key, a in got[0]["state"].items()}
        same["history"] = got[0]["history"] == got[1]["history"]
        batch = training.get("batch_size", BATCH)
        log(f"[dp] gloo {case}, 2 ranks sharing the card (semantics, not speed): backend {ranks[0]['backend']}, "
            f"batch {batch} global, training {json.dumps(training)}, importance groups of each microbatch by rank "
            f"{[g['groups'] for g in got]}; {DP_GLOO_STEPS} steps; ELBO history against the run without a mesh "
            f"max rel {rel:.3e} (bar {ELBO_RTOL}); params max |err| {json.dumps(worst)}; rank 0 and rank 1 "
            f"bitwise equal {json.dumps(same)}")
        if len(got[0]["history"]) != DP_GLOO_STEPS or rel > ELBO_RTOL:
            raise AssertionError(f"[dp] gloo {case}: the two-rank ELBO history differs from the run without a mesh")
        if not all(same.values()):
            raise AssertionError(f"[dp] gloo {case}: the two ranks differ")
        out[case] = {"elbo_rel": rel, "worst": worst}
    log(f"[dp] gloo: both cases in {wall:.2f} s with the spawn; steps_per_call=5 refused: {ranks[0]['refused']}")
    if "gloo" not in ranks[0]["refused"] or "gloo" not in ranks[1]["refused"]:
        raise AssertionError("[dp] gloo: steps_per_call=5 was not refused by name")
    return out


def phase_dp(torch, vt, smi: str) -> dict:
    t0 = time.perf_counter()
    mesh = phase_dp_mesh(torch, vt)
    gloo = phase_dp_gloo(torch, vt)
    m, n, p = mesh["mesh"], mesh["none"], mesh["mesh"]["profile"]
    log(f"[dp] {smi}: d={DP_DIM} batch {DP_BATCH} ({DP_ACCUM} microbatches), graphs of {DP_K} steps: "
        f"mesh {m['median_ms']:.2f} ms/step, no mesh {n['median_ms']:.2f}; peak {m['peak_gib']:.3f} / "
        f"{n['peak_gib']:.3f} GiB, pool {m['pool_gib']} / {n['pool_gib']} GiB; device {p['device_ms']:.2f} "
        f"ms/step, K1+K2 {p['k1k2_share']:.3f} of it; mesh == no mesh bitwise; gloo 2 ranks, even and uneven, "
        f"within bars, ranks bitwise equal; {time.perf_counter() - t0:.1f} s")
    return {"mesh": mesh, "gloo": gloo}


SPAN_CELLS = ("lorenz_r3.bf16", "highdim_r5.bf16", "lorenz_r3.fp32")
SPAN_SEED = 4610000001
SPAN_RING_BAR = 0.02  # the ring's span times against the trace's, per family
SPAN_ROUNDS = 6       # rounds of (on, off, off, on) windows of one chunk each


def span_arm(torch, cell, spans_on: bool):
    """The cell's trainer (the benchmark's harness) from ``SPAN_SEED``'s
    weights, through its first chunk (eager, then captured with spans on or
    off) and one replay."""
    from portbench.harness import problem
    from portbench.harness.program import Program
    from viforsdes_tpu_torch.utils import profiling

    cfg, traffic = cell.config, cell.traffic
    sde = problem.make_sde(cfg)
    times, values = problem.observations(cfg)
    shapes = problem.shapes(cfg, values.shape[-1], sde)
    prog = Program(cfg, traffic, sde, times, values, SPAN_SEED, "cuda")
    prog.load(problem.make_weights(cfg, shapes, SPAN_SEED, torch.device("cuda")))
    k = int(traffic["steps_per_call"])
    profiling.set_device_spans(spans_on)
    try:
        prog.train_to(k)
    finally:
        profiling.set_device_spans(True)
    prog.train_to(2 * k)
    torch.cuda.synchronize()
    return prog


def span_walls(trace) -> dict:
    """Per span, the device ms between its markers' starts in ``trace``, a
    step; the ring's quantity, from the profiler's clock."""
    from portbench.harness.spans import MARKER, SPANS

    walls: dict = {}
    opened = []
    for op in sorted(trace.device, key=lambda op: op.start):
        m = MARKER.search(op.name)
        if m is None:
            continue
        span = SPANS[int(m.group(2))]
        if m.group(1) == "begin":
            opened.append((span, op.start))
        else:
            begun, t0 = opened.pop()
            if begun != span:
                raise AssertionError(f"[spans] {span!r} ends inside {begun!r} in the trace")
            walls[span] = walls.get(span, 0.0) + (op.start - t0) * 1e-3 / trace.steps
    if opened:
        raise AssertionError(f"[spans] spans left open in the trace: {opened[:4]}")
    return walls


def span_families(walls: dict) -> dict:
    """The benchmark's families from inclusive span times: attention apart
    from the encoder that holds it."""
    from portbench.harness.spans import FAMILIES

    fam = {name: sum(walls.get(s, 0.0) for s in spans) for name, spans in FAMILIES.items()}
    fam["encoder"] -= fam["attention"]
    return fam


def span_cell(torch, name: str) -> dict:
    import shutil
    import tempfile
    from pathlib import Path

    from torch.profiler import record_function

    from portbench.harness import spans as span_reader
    from portbench.harness import spec
    from portbench.harness.trace import WINDOW, read_chrome_trace
    from viforsdes_tpu_torch.utils import profiling

    cell = spec.load_cell(name)
    traffic = cell.traffic
    k = int(traffic["steps_per_call"])
    accum = int(traffic["grad_accum_steps"])
    depth = int(cell.config["encoder"]["depth"])
    arms = {"on": span_arm(torch, cell, True), "off": span_arm(torch, cell, False)}
    chunks = {arm: prog.trainer._train_chunks[k] for arm, prog in arms.items()}

    # the state after the eager chunk and one replay: bitwise the same
    sa, sb = trainer_state(arms["on"].trainer), trainer_state(arms["off"].trainer)
    for key in ("count", "notfinite_count", "total_notfinite"):
        sa[key], sb[key] = arms["on"].trainer.opt_state[key], arms["off"].trainer.opt_state[key]
    unequal = [key for key in sa if not torch.equal(sa[key], sb[key])]
    if unequal:
        raise AssertionError(f"[spans] {name}: state after a replay differs with spans on and off: {unequal}")
    markers = len(chunks["on"].spans.boundaries)
    extra = chunks["on"].nodes - chunks["off"].nodes
    if chunks["off"].spans is not None or extra != markers:
        raise AssertionError(f"[spans] {name}: the graph with spans has {extra} nodes more than without, "
                             f"{markers} markers")

    # one replay traced: markers, the ring against the trace, the split
    expected = {s: accum for s in span_reader.SPANS}
    expected.update({"step": 1, "optimizer": 1, "attention": depth * accum, "attention.bwd": depth * accum})
    prog = arms["on"]
    for attempt in range(1, PROFILE_TRIES + 1):
        out = Path(tempfile.mkdtemp(prefix="spans_trace_"))
        try:
            torch.cuda.synchronize()
            with profiling.trace(str(out)):
                with record_function(WINDOW):
                    prog.train_to(prog.completed + k)
                    torch.cuda.synchronize()
            trace = read_chrome_trace(next(out.glob("*.json")), k)
        finally:
            shutil.rmtree(out, ignore_errors=True)
        counts = {}
        for op in trace.device:
            m = span_reader.MARKER.search(op.name)
            if m is not None:
                key = (span_reader.SPANS[int(m.group(2))], m.group(1))
                counts[key] = counts.get(key, 0) + 1
        want = {(s, kind): n * k for s, n in expected.items() for kind in ("begin", "end")}
        if counts == want:
            break
        log(f"[spans] {name}: profile {attempt} counted markers "
            f"{json.dumps({f'{s} {kd}': n for (s, kd), n in counts.items()})}"
            + ("; profiling another replay" if attempt < PROFILE_TRIES else ""))
    if counts != want:
        raise AssertionError(f"[spans] {name}: markers of one replay {counts}, expected {want}")
    ring = profiling.device_span_ms(prog.trainer)
    walls = span_walls(trace)
    ring_fam, trace_fam = span_families(ring.ms), span_families(walls)
    off = {f: abs(ring_fam[f] - trace_fam[f]) / trace_fam[f] for f in ring_fam}
    split = span_reader.split(trace)
    kernel_fam = {f: split.family_s(f) * 1e3 / k for f in span_reader.FAMILIES}
    busy = split.total_s() * 1e3 / k
    unspanned = busy - sum(kernel_fam.values())
    marker_ms = sum(op.dur for op in trace.device if span_reader.MARKER.search(op.name)) * 1e-3 / k
    launches = {f: sum(split.ops[s] for s in spans) / k for f, spans in span_reader.FAMILIES.items()}
    log(f"[spans] {name}: {markers // k} markers a step ({marker_ms:.4f} ms of marker kernels a step), "
        f"{extra} graph nodes more than without; state after a replay bitwise equal on and off")
    log(f"[spans] {name} ring ms/step (with children): " + json.dumps({s: round(v, 4) for s, v in ring.ms.items()}))
    log(f"[spans] {name} ring graph nodes/step: " + json.dumps({s: round(v, 1) for s, v in ring.nodes.items()}))
    log(f"[spans] {name} families, ring against trace (marker to marker, ms/step): "
        + json.dumps({f: [round(ring_fam[f], 4), round(trace_fam[f], 4), round(off[f], 5)] for f in ring_fam}))
    log(f"[spans] {name} split of {busy:.3f} kernel ms/step: "
        + json.dumps({f: round(v, 4) for f, v in kernel_fam.items()})
        + f", unspanned {unspanned:.4f} ({100 * unspanned / busy:.2f}%); launches/step "
        + json.dumps({f: round(v, 1) for f, v in launches.items()})
        + f", in all {split.total_ops() / k:.1f} (theta {split.ops['theta'] / k:.1f}, grads.tail "
        f"{split.ops['grads.tail'] / k:.1f}, step {split.ops['step'] / k:.1f}, outside {split.ops[None] / k:.1f})")
    bad = {f: v for f, v in off.items() if v > SPAN_RING_BAR}
    if bad:
        raise AssertionError(f"[spans] {name}: ring and trace differ by more than {SPAN_RING_BAR}: {bad}")

    # ms a step in turns: on, off, off, on; one chunk a window
    samples = {"on": [], "off": []}

    def window(arm: str) -> float:
        p = arms[arm]
        first = p.completed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks[arm](first)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / k

    for _ in range(SPAN_ROUNDS):
        for arm in ("on", "off", "off", "on"):
            samples[arm].append(window(arm))
    med = {arm: statistics.median(v) for arm, v in samples.items()}
    cost = (med["on"] - med["off"]) / med["off"]
    log(f"[spans] {name} ms/step in turns ({len(samples['on'])} windows of {k} steps an arm): on "
        f"{med['on']:.4f}, off {med['off']:.4f}: spans cost {100 * cost:.4f}% "
        f"(quartiles on {[round(q, 4) for q in statistics.quantiles(samples['on'], n=4)]}, "
        f"off {[round(q, 4) for q in statistics.quantiles(samples['off'], n=4)]})")
    del arms, prog, chunks, sa, sb
    release(torch)
    return {"markers": markers // k, "cost": cost, "ring_off": off, "families_ms": kernel_fam,
            "unspanned_ms": unspanned, "busy_ms": busy, "launches": split.total_ops() / k}


def phase_spans(torch) -> dict:
    return {name: span_cell(torch, name) for name in SPAN_CELLS}


ADALN_SHAPES = ((LZ_BATCH, 2001, 256), (512, 101, 256))  # the Lorenz r3 and highdim r5 cells' norm sites
ADALN_CELLS = ("lorenz_r3.bf16", "highdim_r5.bf16", "lorenz_r3.fp32")
ADALN_SEED = 4620000001
ADALN_EPS = 1e-5
ADALN_KERNELS = ("forward_kernel", "backward_kernel", "reduce_kernel")
# m's bars against the eager composition (tests/test_torch_adaln_norm.py):
# the row statistics differ by a few fp32 roundings (summation order), which
# in bf16 flip the rounded mean or rstd of a few rows (one ulp more there)
# and in fp32, where they stay unrounded, move m by |n| times as many
ADALN_BF16_ULPS, ADALN_FP32_ULPS = 2.0, 16.0


def adaln_case(torch, shape, dtype, residual: bool, seed: int):
    """A norm site's operands on the card: x, y, gate, scale, shift and the
    cotangents of x_new and m (y and gate None without a residual)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h = shape

    def draw(*dims, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*dims, generator=gen, device="cuda")).to(dtype)

    x, y = draw(b, s, h, mean=0.3), draw(b, s, h)
    gate, scale, shift = (draw(b, 1, h, std=0.3) for _ in range(3))
    dx_new, dm = draw(b, s, h), draw(b, s, h)
    return (x, y if residual else None, gate if residual else None, scale, shift,
            dx_new if residual else None, dm)


def ulps(torch, a, ref, dtype):
    """|a - ref| in ulps of ``dtype`` at max(|ref|, 1): one unit is one
    rounding of a value of the LayerNorm's output scale."""
    mant = 7 if dtype == torch.bfloat16 else 23
    ulp = torch.exp2(torch.floor(torch.log2(ref.double().abs().clamp(min=1.0))) - mant)
    return (a.double() - ref.double()).abs() / ulp


def adaln_check(torch, shape, dtype, residual: bool, seed: int) -> dict:
    """The kernel pair against the eager composition (forward), the plain
    VJP (the same fp32 math) and fp32 autograd; twice, bitwise equal."""
    from viforsdes_tpu_torch.ops import adaln_norm as an

    x, y, gate, scale, shift, dx_new, dm = adaln_case(torch, shape, dtype, residual, seed)
    runs = []
    for _ in range(2):
        x_new, m, stats = an._forward_cuda(x, y, gate, scale, shift, ADALN_EPS)
        grads = an._backward_cuda(x_new, y, gate, scale, stats, dx_new, dm)
        torch.cuda.synchronize()
        runs.append((x_new, m, stats, *grads))
    same_bits({"first": runs[0], "second": runs[1]}, f"[adaln] {shape} {dtype} residual={residual}")
    x_new, m, stats, *grads = runs[0]
    want_x_new, want_m = an._forward_plain(x, y, gate, scale, shift, ADALN_EPS)
    if not torch.equal(x_new, want_x_new):
        raise AssertionError(f"[adaln] {shape} {dtype}: x_new differs from x + y*gate")
    mean, rstd = stats[..., :1].to(dtype), stats[..., 1:].to(dtype)
    if not torch.equal(m, (1 + scale) * ((x_new - mean) * rstd) + shift):
        raise AssertionError(f"[adaln] {shape} {dtype}: m differs from the composition given its statistics")
    u = ulps(torch, m, want_m, dtype)
    want_stats = an._row_stats(want_x_new, ADALN_EPS)
    stats_err = float(((stats - want_stats).abs() / want_stats.abs().clamp(min=1e-3)).max())
    plain = an._backward_plain(x_new, y, gate, scale, stats, dx_new, dm)
    leaves = [None if t is None else t.detach().float().requires_grad_() for t in (x, y, gate, scale, shift)]
    f_new, f_m = an._forward_plain(*leaves, ADALN_EPS)
    outs, cots = [f_m], [dm.float()]
    if residual:
        outs.append(f_new)
        cots.append(dx_new.float())
    auto = iter(torch.autograd.grad(outs, [t for t in leaves if t is not None], cots))
    exact = [None if t is None else next(auto) for t in leaves]
    errs = {}
    for name, g, p, e in zip(("dx", "dy", "dgate", "dscale", "dshift"), grads, plain, exact):
        if g is None:
            continue
        errs[name] = (check_close(g, p, dtype, (1e-5, 1e-6), 8e-3, f"[adaln] {name} against the plain VJP"),
                      check_close(g, e, dtype, (5e-5, 5e-6), BF16_BWD, f"[adaln] {name} against fp32 autograd"))
    out = {"m_max_ulps": float(u.max()), "m_over_one_ulp": int((u > 1).sum()), "stats_rel": stats_err,
           "grad_errs": errs}
    log(f"[adaln] {shape} {str(dtype)[6:]} residual={residual}: x_new bitwise, m bitwise given its statistics "
        f"and max {out['m_max_ulps']:.3f} "
        f"ulps ({out['m_over_one_ulp']} elements over one), stats rel {stats_err:.2e}; backward max |err| "
        f"(plain VJP, fp32 autograd) " + json.dumps({k: [float(f"{a:.3e}"), float(f"{b:.3e}")]
                                                       for k, (a, b) in errs.items()})
        + "; two runs bitwise equal")
    if out["m_max_ulps"] > (ADALN_BF16_ULPS if dtype == torch.bfloat16 else ADALN_FP32_ULPS):
        raise AssertionError(f"[adaln] {shape} {dtype}: m {out['m_max_ulps']} ulps from the eager composition")
    if stats_err > 1e-5:
        raise AssertionError(f"[adaln] {shape} {dtype}: row statistics {stats_err} from the eager ones")
    return out


def adaln_times(torch, shape, dtype, n: int = 50) -> dict:
    """One residual site's forward and backward (with its reduction) on the
    card, the eager composition's forward + autograd backward, and the bound:
    each input read once, each output written once, at 3.35 TB/s."""
    from viforsdes_tpu_torch.ops import adaln_norm as an

    x, y, gate, scale, shift, dx_new, dm = adaln_case(torch, shape, dtype, True, ADALN_SEED)
    x_new, m, stats = an._forward_cuda(x, y, gate, scale, shift, ADALN_EPS)
    grads = an._backward_cuda(x_new, y, gate, scale, stats, dx_new, dm)
    fwd_bytes = nbytes(x, y, gate, scale, shift, x_new, m, stats)
    bwd_bytes = nbytes(x_new, y, gate, scale, stats, dx_new, dm, grads)
    leaves = [t.detach().requires_grad_() for t in (x, y, gate, scale, shift)]

    def eager():
        e_new, e_m = an._forward_plain(*leaves, ADALN_EPS)
        torch.autograd.grad([e_m, e_new], leaves, [dm, dx_new])

    out = {
        "fwd_ms": cuda_ms(torch, lambda: an._forward_cuda(x, y, gate, scale, shift, ADALN_EPS), n),
        "bwd_ms": cuda_ms(torch, lambda: an._backward_cuda(x_new, y, gate, scale, stats, dx_new, dm), n),
        "plain_ms": cuda_ms(torch, eager, max(n // 5, 3)),
        "fwd_bound_ms": bound(0, fwd_bytes, "bf16")["bound_ms"],
        "bwd_bound_ms": bound(0, bwd_bytes, "bf16")["bound_ms"],
    }
    out["site_ms"] = out["fwd_ms"] + out["bwd_ms"]
    out["site_bound_ms"] = out["fwd_bound_ms"] + out["bwd_bound_ms"]
    log(f"[adaln] {shape} {str(dtype)[6:]} times: forward {out['fwd_ms']:.4f} ms (bound {out['fwd_bound_ms']:.4f}, "
        f"{out['fwd_bound_ms'] / out['fwd_ms']:.3f} of it), backward {out['bwd_ms']:.4f} ms (bound "
        f"{out['bwd_bound_ms']:.4f}, {out['bwd_bound_ms'] / out['bwd_ms']:.3f}); the site {out['site_ms']:.4f} "
        f"against {out['site_bound_ms']:.4f} ({out['site_bound_ms'] / out['site_ms']:.3f}); eager forward + "
        f"backward {out['plain_ms']:.4f} ms ({out['plain_ms'] / out['site_ms']:.2f}x the kernels)")
    return out


def adaln_counts(torch, name: str) -> dict:
    """The cell's trainer through its first chunk (eager, then captured):
    16 forward and 16 backward launches a SiT call by the counters; then one
    replay profiled: the kernels by name, a step, and their device ms."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import spec
    from viforsdes_tpu_torch.models import encoder as enc_mod
    from viforsdes_tpu_torch.ops import adaln_norm as an

    cell = spec.load_cell(name)
    k = int(cell.traffic["steps_per_call"])
    sites = 2 * int(cell.config["encoder"]["depth"])
    per_step = sites * int(cell.traffic["grad_accum_steps"])
    calls = [0]
    real_sit = enc_mod.sit

    def counting_sit(*args, **kwargs):
        calls[0] += 1
        return real_sit(*args, **kwargs)

    an.FORWARD_LAUNCHES.reset()
    an.BACKWARD_LAUNCHES.reset()
    enc_mod.sit = counting_sit
    try:
        prog = span_arm(torch, cell, True)  # the first chunk, captured, and one replay
    finally:
        enc_mod.sit = real_sit
    fwd, bwd = an.FORWARD_LAUNCHES.count, an.BACKWARD_LAUNCHES.count
    if calls[0] == 0 or fwd != sites * calls[0] or bwd != sites * calls[0]:
        raise AssertionError(f"[adaln] {name}: {fwd} forward and {bwd} backward launches over {calls[0]} "
                             f"SiT calls, expected {sites} each a call")
    want = {kern: per_step * k for kern in ADALN_KERNELS}
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prog.train_to(prog.completed + k)
            torch.cuda.synchronize()
        got = {kern: 0 for kern in ADALN_KERNELS}
        dev_us = {kern: 0.0 for kern in ADALN_KERNELS}
        for evt in prof.key_averages():
            for kern in ADALN_KERNELS:
                if f"adaln::{kern}" in evt.key:
                    got[kern] += evt.count
                    dev_us[kern] += getattr(evt, "device_time_total", 0.0) or getattr(evt, "cuda_time_total", 0.0)
        if got == want:
            break
        log(f"[adaln] {name}: profile {attempt} counted {got}"
            + ("; profiling another replay" if attempt < PROFILE_TRIES else ""))
    if got != want:
        raise AssertionError(f"[adaln] {name}: kernels of one replay {got}, expected {want}")
    ms = {kern: dev_us[kern] * 1e-3 / k for kern in ADALN_KERNELS}
    log(f"[adaln] {name}: {calls[0]} SiT calls through the first chunk, {fwd} forward and {bwd} backward "
        f"launches ({sites} each a call); one replay: " + json.dumps({kern: got[kern] // k for kern in got})
        + f" a step, device ms a step " + json.dumps({kern: round(v, 4) for kern, v in ms.items()})
        + f" ({sum(ms.values()):.4f} in all, {sum(ms.values()) / per_step:.4f} a site)")
    del prog
    release(torch)
    return {"calls": calls[0], "per_step": per_step, "ms": ms}


def phase_adaln(torch) -> dict:
    """The fused norm site: kernel pair against the composition at both
    cells' shapes, bf16 and fp32, with and without a residual; its time
    against its byte bound; its launches in each cell's captured chunk."""
    t0 = time.perf_counter()
    checks = {(shape, str(dtype), residual): adaln_check(torch, shape, dtype, residual, ADALN_SEED + i)
              for i, (shape, dtype, residual) in enumerate(
                  (shape, dtype, residual) for shape in ADALN_SHAPES
                  for dtype in (torch.bfloat16, torch.float32) for residual in (True, False))}
    times = {(shape, str(dtype)): adaln_times(torch, shape, dtype)
             for shape in ADALN_SHAPES for dtype in (torch.bfloat16, torch.float32)}
    counts = {name: adaln_counts(torch, name) for name in ADALN_CELLS}
    log(f"[adaln] done in {time.perf_counter() - t0:.1f} s")
    return {"checks": checks, "times": times, "counts": counts}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import viforsdes_tpu_torch as vt

    t_start = time.perf_counter()

    def mark(what: str) -> None:
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    smi, kind = phase_card(torch)
    phase_build(torch)
    if sys.argv[1:] in (["spans"], ["adaln"]):
        {"spans": phase_spans, "adaln": phase_adaln}[sys.argv[1]](torch)
        mark(sys.argv[1])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    errs = {"K1": phase_forward(torch), "K2": phase_backward(torch)}
    errs["K3"], errs["K4"] = phase_qk_prep(torch)
    phase_flash_plan(torch)
    errs.update(phase_flash(torch))
    mark("build and kernel checks")
    times, bounds = phase_kernel_times(torch)
    att, att_bounds = phase_attention_times(torch)
    bounds.update(att_bounds)
    mark("kernel times")

    phase_main_path(torch, vt)
    phase_step_parity(torch, vt)
    trainer, step, stats = phase_step_times(torch, vt)
    phase_profile(torch, trainer, step, stats["auto"]["median_ms"], "OU bench config")
    del trainer
    mark("OU path")

    launches = phase_lorenz_path(torch, vt)
    phase_lorenz_parity(torch, vt)
    trainer, step, stats = phase_lorenz_times(torch, vt)
    phase_profile(torch, trainer, step, stats["kernels"]["median_ms"], "Lorenz-63", n=2)
    del trainer
    mark("Lorenz path")
    phase_examples(torch, vt)
    phase_graph_ou(torch, vt)
    phase_graph_lorenz(torch, vt)
    phase_matched(torch, vt)
    mark("examples, graphs and matched head")
    fp32 = phase_fp32(torch, vt)
    mark("fp32 Lorenz path")
    phase_repairs(torch, vt)
    phase_wide_head(torch, vt)
    mark("repairs")
    ladder = phase_ladder(torch, vt, smi)
    errs["K1"] = max(errs["K1"], ladder["errs"][0])
    errs["K2"] = max(errs["K2"], ladder["errs"][1])
    mark("ladder")
    phase_lv_bf16(torch)
    mark("LV bf16 step")
    phase_dp(torch, vt, smi)
    torch.cuda.synchronize()
    mark("data parallel")
    phase_spans(torch)
    mark("spans")
    phase_adaln(torch)
    mark("adaln")

    rows = [  # (key, name, source, TPU kernel, ms, plain ms, library ms)
        ("K1", "sde_sampler_fwd", "sde_sampler_fwd.cu", "viforsdes_tpu/ops/pallas/sde_sampler.py:141",
         times["fwd_ms_lorenz"], times["fwd_plain_ms_lorenz"], None),
        ("K2", "sde_sampler_bwd", "sde_sampler_bwd.cu", "viforsdes_tpu/ops/pallas/sde_sampler.py:238",
         times["bwd_ms_lorenz"], times["bwd_plain_ms_lorenz"], None),
        ("K3", "qk_prep_fwd", "qk_prep.cu", "viforsdes_tpu/ops/pallas/qk_prep.py:39",
         att["qk_prep_fwd_ms"], att["qk_prep_fwd_plain_ms"], None),
        ("K4", "qk_prep_bwd", "qk_prep.cu", "viforsdes_tpu/ops/pallas/qk_prep.py:53",
         att["qk_prep_bwd_ms"], att["qk_prep_bwd_plain_ms"], None),
        ("K5", "flash_attn_fwd", "flash_attn_fwd.cu", "viforsdes_tpu/ops/pallas/flash_fixed.py:362",
         att["flash_fwd_ms"], att["flash_fwd_plain_ms"], att["library_fwd_ms"]),
        ("K6", "flash_attn_bwd_dkv", "flash_attn_bwd.cu", "viforsdes_tpu/ops/pallas/flash_fixed.py:574",
         att["flash_bwd_dkv_ms"], att["flash_bwd_plain_ms"], att["library_bwd_ms"]),
        ("K7", "flash_attn_bwd_dq", "flash_attn_bwd.cu", "viforsdes_tpu/ops/pallas/flash_fixed.py:159",
         att["flash_bwd_dq_ms"], att["flash_bwd_plain_ms"], att["library_bwd_ms"]),
        # fp32 inputs (the [fp32] path): K5-K7 in 3xTF32
        ("K5 fp32", "flash_attn_fwd_fp32", "flash_attn_fwd.cu", "viforsdes_tpu/ops/pallas/flash_fixed.py:362",
         att["flash_fwd_fp32_ms"], att["flash_fwd_plain_fp32_ms"], att["library_fwd_fp32_ms"]),
        ("K6 fp32", "flash_attn_bwd_dkv_fp32", "flash_attn_bwd.cu", "viforsdes_tpu/ops/pallas/flash_fixed.py:574",
         att["flash_bwd_dkv_fp32_ms"], att["flash_bwd_plain_fp32_ms"], att["library_bwd_fp32_ms"]),
        ("K7 fp32", "flash_attn_bwd_dq_fp32", "flash_attn_bwd.cu", "viforsdes_tpu/ops/pallas/flash_fixed.py:159",
         att["flash_bwd_dq_fp32_ms"], att["flash_bwd_plain_fp32_ms"], att["library_bwd_fp32_ms"]),
    ]
    for k in ("K5", "K6", "K7"):
        launches[k + " fp32"] = fp32["launches"][k]
    ms_of = {row[0]: row[4] for row in rows}
    for k, bd in bounds.items():
        earlier = f" (mma.sync: {MMA_SYNC_MS[k]} ms)" if k in MMA_SYNC_MS else ""
        log(f"[bounds] {k}: {ms_of[k]:.4f} ms{earlier} against a bound of {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']}: {bd['flop'] / 1e9:.2f} GFLOP at the {bd['peak']} peak, "
            f"{bd['bytes'] / 1e6:.1f} MB), {bd['bound_ms'] / ms_of[k]:.4f} of the bound")
    kernels = [
        {"name": name, "route": "cuda", "source": f"viforsdes_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[k], "max_abs_err": errs[k],
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[k]["bound_ms"],
         "bound_by": bounds[k]["bound_by"], "library_ms": library_ms}
        for k, name, src, replaces, ms, plain_ms, library_ms in rows
    ]
    log(smi)  # again here, beside the results, since the build report is long
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
