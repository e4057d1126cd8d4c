#!/usr/bin/env python3
"""Time K6 and K7, the flash-attention backward, with fp32 inputs, as built
from several versions of their source on one NVIDIA GPU, beside PyTorch's
memory-efficient attention backward.

    python3 tools/time_flash.py [--turns 5] [--launches 5] [--steps 0] [--no-check] [LABEL=PATH ...]

``tree`` is the package's ``csrc/flash_attn_bwd.cu``. Each ``LABEL=PATH``
names another version: a directory is the root of a copy of the repository
(``git archive`` of another commit, unpacked under the git-ignored
``/_chip/``), whose ``viforsdes_tpu_torch/csrc/flash_attn_bwd.cu`` is built
against its own headers; a file is another version of that source, built
against the package's headers. Each builds into its own library (one
``nvcc`` each, all started together) under
``viforsdes_tpu_torch/_build/flash_versions/``. ptxas's lines about each
version's K6 and K7 kernels come first (registers, spills, any wgmma it
serialized), then the tree's fp32 plans.

At the Lorenz shape [32, 4, 2001, 64] in fp32 (q, k, v strided views of one
projection, as on the main path) every version's dq, dk and dv are held to
the plain backward within ``chip_smoke.py``'s fp32 bars and compared bit for
bit with the tree's (``--no-check`` reports the other versions' errors
without holding them to the bars: copies with phases cut out). Then each
version's K6 and K7 and the library backward
(``scaled_dot_product_attention`` on its memory-efficient backend, which
serves K6 and K7 together) are timed with CUDA events in turns (each turn
runs the arms in order, then in reverse), beside two bounds: the 3xTF32
products at 495 TFLOP/s of dense TF32, and the same products once in fp32
FMA at 67 TFLOP/s. With ``--steps N`` the Lorenz-63 long grid of
``chip_smoke.py`` (2001 tokens, batch 32, SiT 256 x 4 heads x 8 deep, GRU
64 x 2) with ``compute_dtype="float32"`` then trains one step a call through
each version's K6 and K7 (the rest of the step runs the package's kernels
and code), in windows of N steps in turns, from one trainer per version on
the same seed. The card's name and power limit come first, the medians last,
as one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 4, 2001, 64)
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4  # chip_smoke.py's fp32 backward bars
PEAK_TF32, PEAK_FP32 = 495e12, 67e12  # dense, one H100 SXM at 700 W
KERNELS = ("dkv_tf32_kernel", "dq_tf32_kernel", "dkv_kernel", "dq_kernel")


def build(variant: tuple[str, str, str]) -> tuple[str, str]:
    """The library of one variant (label, source, include directory) and the
    compiler's report."""
    from viforsdes_tpu_torch.ops.kernel_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    label, source, include = variant
    out_dir = BUILD_DIR / "flash_versions"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libflash_bwd_{label}.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{include}", "-shared", "-o", str(lib), source]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{proc.stderr}")
    return str(lib), proc.stdout + proc.stderr


def kernel_report(report: str) -> list[str]:
    """ptxas's lines about the backward kernels: those from a kernel's
    'Compiling entry' line up to the next entry."""
    lines, inside = [], False
    for line in report.splitlines():
        if "Compiling entry" in line:
            inside = any(k in line for k in KERNELS)
        if inside and any(w in line for w in ("Compiling entry", "registers", "spill", "wgmma", "arning")):
            lines.append(line.strip())
    return lines


def variant_of(spec: str) -> tuple[str, str, str]:
    label, path = spec.split("=", 1)
    path = os.path.abspath(path)
    if os.path.isdir(path):
        csrc = os.path.join(path, "viforsdes_tpu_torch", "csrc")
        return label, os.path.join(csrc, "flash_attn_bwd.cu"), csrc
    from viforsdes_tpu_torch.ops.kernel_build import CSRC_DIR

    return label, path, str(CSRC_DIR)


def max_err(torch, a, ref, what: str, check: bool = True) -> float:
    """Largest |a - ref|, held elementwise to rtol |ref| + atol max|ref|
    where ``check``."""
    a, ref = a.double(), ref.double()
    err = (a - ref).abs()
    bad = not bool(torch.isfinite(a).all()) or bool((err > BWD_RTOL * ref.abs() + BWD_ATOL * ref.abs().max()).any())
    if check and bad:
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3e} beyond the fp32 bars")
    return float(err.max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--turns", type=int, default=5)
    parser.add_argument("--launches", type=int, default=5, help="launches per timed window")
    parser.add_argument("--steps", type=int, default=0, help="fp32 Lorenz steps a window (0: no step timing)")
    parser.add_argument("--no-check", action="store_true", help="do not hold versions other than the tree to the bars")
    parser.add_argument("versions", nargs="*", default=[], help="LABEL=PATH: a repository root or a source file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from viforsdes_tpu_torch.ops import flash_attention as fa
    from viforsdes_tpu_torch.ops.kernel_build import ATTENTION, CSRC_DIR, raise_on

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = [("tree", str(CSRC_DIR / "flash_attn_bwd.cu"), str(CSRC_DIR))]
    variants += [variant_of(v) for v in args.versions]
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        built = list(pool.map(build, variants))
    libs = {}
    for (label, source, _), (path, report) in zip(variants, built):
        for line in kernel_report(report):
            print(f"[ptxas {label}] {line}", flush=True)
        lib = ctypes.CDLL(path)
        lib.flash_attn_bwd.argtypes = ATTENTION.signatures["flash_attn_bwd"]
        lib.flash_attn_bwd.restype = ctypes.c_int
        libs[label] = lib
        print(f"[build] {label}: {source}", flush=True)
    for kernel in ("dkv", "dq"):
        print(f"[plan] tree {kernel} fp32 D=64: {fa.flash_plan(kernel, 64, torch.float32)}", flush=True)

    b, h, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(80)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in torch.chunk(qkv, 3, dim=-1))
    do = torch.randn(SHAPE, generator=gen, device="cuda")
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._forward_cuda(q, k, v, s, scale)
    (c_args, keep), dq, dk, dv = fa._backward_operands(q, k, v, o, lse, do, s, scale)
    refs = [g.float() for g in fa._backward_plain(q, k, v, o, lse, do, s, scale)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(label: str, pass_: int) -> None:
        raise_on(libs[label].flash_attn_bwd(*c_args, pass_, stream), f"{label} pass {pass_}")

    errs, outs = {}, {}
    for label in libs:
        for g in (dq, dk, dv):
            g.zero_()
        launch(label, 0)
        launch(label, 1)
        torch.cuda.synchronize()
        check = label == "tree" or not args.no_check
        errs[label] = {n: max_err(torch, g, r, f"{label} {n}", check)
                       for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
        outs[label] = [g.clone() for g in (dq, dk, dv)]
        same = [bool(torch.equal(x, y)) for x, y in zip(outs[label], outs["tree"])]
        print(f"[check] {label}: max |err| {json.dumps(errs[label])} within rtol {BWD_RTOL}, atol {BWD_ATOL} x "
              f"max|ref|; bitwise equal to the tree's dq, dk, dv: {same}", flush=True)
    del outs

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(*ins)
    arms = {"library_bwd_fp32": lambda: torch.autograd.grad(out, ins, do, retain_graph=True)}
    for label in libs:
        arms[f"{label}_K6"] = lambda label=label: launch(label, 0)
        arms[f"{label}_K7"] = lambda label=label: launch(label, 1)
    for fn in arms.values():  # warm every arm and the clocks
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    windows = {name: [] for name in arms}
    for _ in range(args.turns):
        for name in [*arms, *reversed(arms)]:
            start.record()
            for _ in range(args.launches):
                arms[name]()
            end.record()
            torch.cuda.synchronize()
            windows[name].append(start.elapsed_time(end) / args.launches)
    product = 2 * b * h * s * s * d
    bounds = {kern: {"tf32_ms": 3 * n * product / PEAK_TF32 * 1e3, "fma_ms": n * product / PEAK_FP32 * 1e3}
              for kern, n in (("K6", 4), ("K7", 3))}
    med = {name: statistics.median(w) for name, w in windows.items()}
    lib_ms = med["library_bwd_fp32"]
    result = {"card": smi, "shape": list(SHAPE), "launches_per_window": args.launches, "turns": args.turns,
              "bounds_ms": bounds, "library_bwd_fp32_ms": lib_ms, "variants": {}}
    print(f"[time] library backward (memory-efficient, K6 + K7's work): median {lib_ms:.4f} ms "
          f"(min {min(windows['library_bwd_fp32']):.4f}, max {max(windows['library_bwd_fp32']):.4f})", flush=True)
    for label in libs:
        row = {"max_abs_err": errs[label]}
        for kern in ("K6", "K7"):
            ts = windows[f"{label}_{kern}"]
            m = statistics.median(ts)
            bd = bounds[kern]
            row[kern] = {"median_ms": m, "windows_ms": ts, "share_tf32": bd["tf32_ms"] / m,
                         "share_fma": bd["fma_ms"] / m}
            print(f"[time] {label} {kern} fp32: median {m:.4f} ms over {len(ts)} windows (min {min(ts):.4f}, "
                  f"max {max(ts):.4f}); 3xTF32 bound {bd['tf32_ms']:.4f} ms ({bd['tf32_ms'] / m:.3f} of it), "
                  f"FMA bound {bd['fma_ms']:.4f} ms ({bd['fma_ms'] / m:.3f})", flush=True)
        total = row["K6"]["median_ms"] + row["K7"]["median_ms"]
        row["K6_plus_K7_ms"], row["over_library"] = total, total / lib_ms
        print(f"[time] {label} K6 + K7 fp32: {total:.4f} ms, {total / lib_ms:.3f}x the library backward", flush=True)
        result["variants"][label] = row
    del keep, ins, out, refs, q, k, v, qkv, do, o, lse, dq, dk, dv
    if args.steps:
        result["lorenz_fp32_step"] = lorenz_steps(torch, fa, libs, args.steps, args.turns)
    print(json.dumps(result))
    return 0


class _Backward:
    """The package's attention library with ``flash_attn_bwd`` (K6, K7)
    taken from another build."""

    def __init__(self, tree, bwd) -> None:
        self.tree, self.bwd = tree, bwd

    def __getattr__(self, name: str):
        return self.bwd.flash_attn_bwd if name == "flash_attn_bwd" else getattr(self.tree, name)


class _Swap:
    """Stands in for ``kernel_build.ATTENTION`` in ``ops/flash_attention.py``:
    ``get()`` gives the library of the version in use."""

    def __init__(self, tree, libs: dict) -> None:
        self.versions = {label: _Backward(tree, lib) for label, lib in libs.items()}
        self.label = "tree"

    def get(self):
        return self.versions[self.label]


def lorenz_steps(torch, fa, libs: dict, n: int, turns: int) -> dict:
    """ms per fp32 Lorenz step, one step a call, of each version's K6/K7."""
    import time

    import chip_smoke
    import viforsdes_tpu_torch as vt

    tree = fa.ATTENTION
    swap = _Swap(tree.get(), libs)
    fa.ATTENTION = swap
    try:
        trainers, step = {}, {}
        for label in libs:
            swap.label = label
            trainers[label] = chip_smoke.lorenz_trainer(torch, vt, "auto", "float32", steps_per_call=1)
            trainers[label].train_step(0)  # warm: first launches, allocator
            step[label] = 1
        torch.cuda.synchronize()
        windows = {label: [] for label in libs}
        for _ in range(turns):
            for label in [*libs, *reversed(libs)]:
                swap.label = label
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(n):
                    trainers[label].train_step(step[label] + i)
                torch.cuda.synchronize()
                windows[label].append((time.perf_counter() - t0) * 1e3 / n)
                step[label] += n
    finally:
        fa.ATTENTION = tree
    out = {}
    for label, ts in windows.items():
        out[label] = {"median_ms": statistics.median(ts), "windows_ms": ts}
        print(f"[step] {label}: fp32 Lorenz step median {statistics.median(ts):.2f} ms over {len(ts)} windows of "
              f"{n} steps (min {min(ts):.2f}, max {max(ts):.2f})", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
