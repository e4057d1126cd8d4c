#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit); TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from ``viforsdes_tpu_torch/csrc/`` (cached in
   ``viforsdes_tpu_torch/_build/``);
3. K1, the path-sampler forward kernel, against its plain PyTorch version;
4. K2, the path-sampler backward kernels, against autograd through the plain
   version, including Cholesky diagonals at and below the clamp and a
   non-zero noise cotangent;
5. the main path: ``infer()`` at the ``bench.py`` configuration (OU 1-D, batch
   128, 100 path steps, SiT 256 x 4 heads x 8 deep, GRU 64 x 2), then
   ``posterior.summary(n_samples=256)``, with every kernel launch counted; one
   step's ELBO and gradient through the kernels against the plain loop; and
   the step time with the kernels (``sampler="auto"``) and with the plain loop
   (``sampler="scan"``), measured in turns, plus a profile of the kernel path.

The line before the last is ``{"kernels": [...]}`` with each kernel's launches
in the main path, its largest error against the plain version, and its time
beside the plain version's at the main path's shapes; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's configuration
BATCH, DT, HORIZON = 128, 0.05, 5.0
ENC = dict(hidden_dim=256, cond_dim=256, num_heads=4, depth=8)
HEAD = dict(hidden_dim=64, num_layers=2)
N_WARMUP, N_TIMED = 5, 20

# Tolerances on the card, elementwise |kernel - plain| <= rtol*|plain| +
# atol*max|plain|. Both sides are fp32 but sum in other orders (cuBLAS vs the
# kernels' FMA chains) over 100 dependent steps, and the weight gradients sum
# 12800 rows, so the bars sit above the CPU tests' 1e-5 / 1e-4.
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4
ELBO_RTOL = 1e-4  # the ELBO bar of tests/test_reference_parity.py


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card(torch) -> str:
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
    return torch.cuda.get_device_name(0)


def phase_build(torch) -> None:
    from viforsdes_tpu_torch.ops import kernel_build
    from viforsdes_tpu_torch.ops.sde_sampler import _Kernels

    t0 = time.perf_counter()
    _Kernels.get()
    log(f"[build] sde_sampler library ready in {time.perf_counter() - t0:.1f} s")
    sources = ["sde_sampler_fwd.cu", "sde_sampler_bwd.cu"]
    report = kernel_build.library_path("sde_sampler", sources).with_suffix(".log")
    for line in report.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")
    torch.cuda.synchronize()


def max_err(a, ref, rtol: float, atol: float, what: str) -> float:
    import torch

    a, ref = a.detach().double(), ref.detach().double()
    if a.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(a.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (a - ref).abs()
    bound = rtol * ref.abs() + atol * max(1.0, float(ref.abs().max()))
    if bool((err > bound).any()):
        raise AssertionError(
            f"{what}: max |err| {float(err.max()):.3e} exceeds the tolerance "
            f"(rtol {rtol}, atol {atol}); max |ref| {float(ref.abs().max()):.3e}"
        )
    return float(err.max())


def sampler_case(torch, B, T, D, H, L, cholesky, seed, clamp_cases=False):
    """Weights and streams for one sampler shape, on the card."""
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
    spec = head.spec(DT)
    w = prep_weights(spec, params)
    w = type(w)(*(t.cuda().contiguous() for t in w))
    x0 = torch.randn(B, D, generator=gen).cuda()
    gc = torch.randn(T, B, 3 * H, generator=gen).cuda()
    eps = torch.randn(T, B, D, generator=gen).cuda()
    cot = (
        torch.randn(B, T + 1, D, generator=gen).cuda(),
        torch.randn(B, T, D, generator=gen).cuda(),
        torch.randn(B, T, spec.n_tril, generator=gen).cuda(),
    )
    return spec, w, x0, gc, eps, cot


def cuda_ms(torch, fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


SHAPES = [  # (B, T, D, H, L, cholesky, clamp_cases)
    (BATCH, 100, 1, 64, 2, "full", False),  # the main path's shape
    (37, 7, 3, 32, 3, "full", True),        # ragged tile, tril, three layers
    (16, 9, 2, 16, 1, "diag", True),        # diag mode, one layer
]


def phase_forward(torch) -> float:
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    worst = 0.0
    for i, (B, T, D, H, L, chol, clamp) in enumerate(SHAPES):
        spec, w, x0, gc, eps, _ = sampler_case(torch, B, T, D, H, L, chol, 10 + i, clamp)
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
        log(f"[K1] B={B} T={T} D={D} H={H} L={L} {chol}: max |err| so far {worst:.3e}")
    return worst


def phase_backward(torch) -> float:
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    worst = 0.0
    for i, (B, T, D, H, L, chol, clamp) in enumerate(SHAPES):
        spec, w, x0, gc, eps, cot = sampler_case(torch, B, T, D, H, L, chol, 20 + i, clamp)

        def grads(sample_fn):
            ins = [t.clone().requires_grad_() for t in (x0, gc, eps, *w)]
            outs = sample_fn(spec, ss.SamplerWeights(*ins[3:]), *ins[:3])
            got = torch.autograd.grad(outs, ins, grad_outputs=cot, allow_unused=True)
            return [torch.zeros_like(t) if g is None else g for t, g in zip(ins, got)]

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
        log(f"[K2] B={B} T={T} D={D} H={H} L={L} {chol}: max |err| so far {worst:.3e}")
    return worst


def phase_kernel_times(torch) -> dict:
    """K1/K2 and their plain versions at the main path's shape (B=128: 32
    blocks of 4 rows); the kernels again at B=528, one block per SM, to show
    how much of the card B=128 leaves idle."""
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    times = {}
    for B in (BATCH, 528):
        _, T, D, H, L, chol, _ = SHAPES[0]
        spec, w, x0, gc, eps, cot = sampler_case(torch, B, T, D, H, L, chol, 30)
        fwd = ss.sampler_forward(spec, w, x0, gc, eps, save_h=True)
        d_paths = cot[0][:, 1:].transpose(0, 1).contiguous()
        d_means = cot[1].transpose(0, 1).contiguous()
        d_cholv = cot[2].transpose(0, 1).contiguous()
        bwd_args = (spec, w, x0, gc, eps, fwd, d_paths, d_means, d_cholv)
        sfx = "" if B == BATCH else f"_b{B}"
        times["fwd_ms" + sfx] = cuda_ms(torch, lambda: ss._forward_cuda(spec, w, x0, gc, eps, save_h=True), 50)
        times["bwd_ms" + sfx] = cuda_ms(torch, lambda: ss._backward_cuda(*bwd_args), 50)
        if B == BATCH:
            times["fwd_plain_ms"] = cuda_ms(torch, lambda: ss._forward_plain(spec, w, x0, gc, eps, save_h=True), 5)
            times["bwd_plain_ms"] = cuda_ms(torch, lambda: ss._backward_plain(*bwd_args), 5)
    log(f"[times] sampler T=100 D=1 H=64 L=2 (B={BATCH} unless suffixed): " + json.dumps(times))
    return times


def ou_problem(vt):
    class OU:
        state_dim = 1
        sde_param_dim = 3

        def drift(self, x, p):
            return p[..., 0:1] * (p[..., 1:2] - x)

        def diffusion(self, x, p):
            return p[..., 2:3][..., None]

    observations = vt.Observations(
        times=[0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
        values=[[2.0], [1.5], [0.8], [1.2], [0.9], [1.1]],
    )
    return (
        OU(),
        observations,
        vt.GaussianObservationLikelihood(variance=0.1),
        vt.Prior(type=vt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
    )


def make_trainer(vt, sampler: str, n_iterations: int):
    sde, obs, lik, prior = ou_problem(vt)
    return vt.VariationalInferenceTrainer(
        sde, obs, lik, prior, HORIZON,
        vt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=n_iterations),
        vt.EncoderConfig(**ENC),
        vt.HeadConfig(**HEAD, sampler=sampler),
        state_positive_dims=[],
        sde_param_positive_dims=[0, 2],
        device="cuda",
    )


def phase_main_path(torch, vt) -> dict:
    from viforsdes_tpu_torch.ops import sde_sampler as ss

    sde, obs, lik, prior = ou_problem(vt)
    config = vt.InferenceConfig(
        training=vt.TrainingConfig(time_step=DT, batch_size=BATCH, n_iterations=N_WARMUP + N_TIMED),
        encoder=vt.EncoderConfig(**ENC),
        head=vt.HeadConfig(**HEAD),
        sde_param_positive_dims=[0, 2],
        device="cuda",
    )
    torch.cuda.synchronize()
    ss.FORWARD_LAUNCHES.reset()
    ss.BACKWARD_LAUNCHES.reset()
    t0 = time.perf_counter()
    posterior = vt.infer(sde, obs, lik, prior, HORIZON, config)
    summary = posterior.summary(n_samples=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": ss.FORWARD_LAUNCHES.count, "bwd": ss.BACKWARD_LAUNCHES.count}

    history = posterior.evidence_lower_bound_history
    n_steps = N_WARMUP + N_TIMED
    log(f"[main] infer + summary(256): {wall:.2f} s wall, {len(history)} steps")
    log(f"[main] ELBO history: {[round(v, 3) for v in history]}")
    log(f"[main] launches: K1 {launches['fwd']} (expected {n_steps} + 1 sampling), "
        f"K2 {launches['bwd']} (expected {n_steps})")
    if len(history) != n_steps or not all(math.isfinite(v) for v in history):
        raise AssertionError("main path: missing or non-finite ELBO")
    if launches != {"fwd": n_steps + 1, "bwd": n_steps}:
        raise AssertionError(f"main path did not run through the kernels: {launches}")
    checks = {
        "theta mean": (summary.sde_parameter_mean, (3,)),
        "theta std": (summary.sde_parameter_std, (3,)),
        "path mean": (summary.diffusion_path_mean, (101, 1)),
        "path std": (summary.diffusion_path_std, (101, 1)),
    }
    for name, (value, shape) in checks.items():
        if tuple(value.shape) != shape or not bool(torch.isfinite(value).all()):
            raise AssertionError(f"posterior summary {name}: {tuple(value.shape)} not finite {shape}")
    log(f"[main] posterior theta mean {summary.sde_parameter_mean.tolist()}, "
        f"std {summary.sde_parameter_std.tolist()}")
    return launches


def phase_step_parity(torch, vt) -> None:
    """One step's ELBO and gradient at the bench config: kernels vs plain loop
    on the same weights and draws."""
    from viforsdes_tpu_torch.inference.optimizer import GROUPS

    results = {}
    for sampler in ("auto", "scan"):
        trainer = make_trainer(vt, sampler, 1)
        theta_eps, noise = trainer.draws(0)[0]
        leaves = {g: trainer.flat_params[g].detach().requires_grad_() for g in GROUPS}
        result = trainer._elbo_from_params(trainer.layout.unpack(leaves), theta_eps, noise)
        grads = torch.autograd.grad(result.evidence_lower_bound, [leaves[g] for g in GROUPS])
        results[sampler] = (result.evidence_lower_bound.detach(), grads)
    torch.cuda.synchronize()
    (e_k, g_k), (e_p, g_p) = results["auto"], results["scan"]
    rel = abs(float(e_k) - float(e_p)) / abs(float(e_p))
    log(f"[parity] bench-config ELBO kernels {float(e_k):.6f} plain {float(e_p):.6f} rel {rel:.2e}")
    if rel > ELBO_RTOL:
        raise AssertionError("bench-config ELBO differs between kernels and plain loop")
    for g, a, r in zip(GROUPS, g_k, g_p):
        e = max_err(a, r, BWD_RTOL, BWD_ATOL, f"bench-config gradient ({g})")
        log(f"[parity] gradient {g}: max |err| {e:.3e}")


def phase_step_times(torch, vt):
    """ms/step with the kernels and with the plain loop, in turns
    (plain, kernel, kernel, plain), each step ended by a synchronize."""
    trainers = {s: make_trainer(vt, s, 10_000) for s in ("auto", "scan")}
    steps = {s: 0 for s in trainers}

    def run(sampler: str, n: int) -> list[float]:
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            trainers[sampler].train_step(steps[sampler])
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            steps[sampler] += 1
        return out

    for s in trainers:
        run(s, 3)  # warm-up: allocator, cuBLAS handles
    torch.cuda.reset_peak_memory_stats()
    samples = {"auto": [], "scan": []}
    for s in ("scan", "auto", "auto", "scan"):
        samples[s] += run(s, N_TIMED // 2)
    stats = {}
    for s, v in samples.items():
        q = statistics.quantiles(v, n=4)
        stats[s] = {"median_ms": statistics.median(v), "q1_ms": q[0], "q3_ms": q[2], "n": len(v)}
    log(f"[step] ms/step at the bench config: " + json.dumps(stats))
    log(f"[step] peak device memory over the timed steps (both trainers): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return trainers["auto"], steps["auto"], stats


def phase_profile(torch, trainer, step: int, wall_ms: float) -> None:
    """Device time by kernel over a few kernel-path steps; the idle share is
    taken against the unprofiled median step time ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            trainer.train_step(step + i)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    total_us = sum(getattr(e, attr) for e in events) / n
    log(f"[profile] {n} kernel-path steps: device kernel time {total_us / 1e3:.2f} ms/step "
        f"in {len(events)} kernel names, {sum(e.count for e in events) // n} launches/step; "
        f"against the unprofiled {wall_ms:.2f} ms/step: "
        f"device idle share {max(0.0, 1 - total_us / 1e3 / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:12]:
        log(f"[profile]   {getattr(e, attr) / n / 1e3:8.3f} ms/step  x{e.count // n:<4d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import viforsdes_tpu_torch as vt

    kind = phase_card(torch)
    phase_build(torch)
    fwd_err = phase_forward(torch)
    bwd_err = phase_backward(torch)
    times = phase_kernel_times(torch)
    launches = phase_main_path(torch, vt)
    phase_step_parity(torch, vt)
    trainer, step, stats = phase_step_times(torch, vt)
    phase_profile(torch, trainer, step, stats["auto"]["median_ms"])
    torch.cuda.synchronize()

    kernels = [
        {
            "name": "sde_sampler_fwd", "route": "cuda",
            "source": "viforsdes_tpu_torch/csrc/sde_sampler_fwd.cu",
            "replaces": "viforsdes_tpu/ops/pallas/sde_sampler.py:141",
            "launches": launches["fwd"], "max_abs_err": fwd_err,
            "ms": times["fwd_ms"], "plain_ms": times["fwd_plain_ms"],
        },
        {
            "name": "sde_sampler_bwd", "route": "cuda",
            "source": "viforsdes_tpu_torch/csrc/sde_sampler_bwd.cu",
            "replaces": "viforsdes_tpu/ops/pallas/sde_sampler.py:238",
            "launches": launches["bwd"], "max_abs_err": bwd_err,
            "ms": times["bwd_ms"], "plain_ms": times["bwd_plain_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
