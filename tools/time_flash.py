#!/usr/bin/env python3
"""Time the flash-attention kernels with fp32 inputs, K5 (the forward) or K6
and K7 (the backward), as built from several versions of their source on one
NVIDIA GPU, beside PyTorch's memory-efficient attention.

    python3 tools/time_flash.py [--kernel bwd|fwd] [--turns 5] [--launches 5] [--steps 0] [--no-check]
                                [LABEL=PATH ...]

``--kernel`` picks the source: ``bwd`` (the default) ``csrc/flash_attn_bwd.cu``
with K6 and K7, ``fwd`` ``csrc/flash_attn_fwd.cu`` with K5. ``tree`` is the
package's source. Each ``LABEL=PATH`` names another version: a directory is
the root of a copy of the repository (``git archive`` of another commit,
unpacked under the git-ignored ``/_chip/``), whose source of that name under
``viforsdes_tpu_torch/csrc/`` is built against its own headers; a file is
another version of that source, built against the package's headers. Each
builds into its own library (one ``nvcc`` each, all started together) under
``viforsdes_tpu_torch/_build/flash_versions/``. ptxas's lines about each
version's fp32 kernels come first (registers, spills, any wgmma it
serialized), then the tree's fp32 plans.

At the Lorenz shape [32, 4, 2001, 64] in fp32 (q, k, v strided views of one
projection, as on the main path) every version's outputs (o and lse, or dq,
dk and dv) are held to the plain version within ``chip_smoke.py``'s fp32
bars and compared bit for bit with the tree's (``--no-check`` reports the
other versions' errors without holding them to the bars: copies with phases
cut out). Then each version's kernels and the library call
(``scaled_dot_product_attention`` on its memory-efficient backend: its
forward for K5, its backward, which serves K6 and K7 together, for K6 and
K7) are timed with CUDA events in turns (each turn runs the arms in order,
then in reverse), beside two bounds: the 3xTF32 products at 495 TFLOP/s of
dense TF32, and the same products once in fp32 FMA at 67 TFLOP/s. With
``--steps N`` the Lorenz-63 long grid of ``chip_smoke.py`` (2001 tokens,
batch 32, SiT 256 x 4 heads x 8 deep, GRU 64 x 2) with
``compute_dtype="float32"`` then trains one step a call through each
version's kernels (the rest of the step runs the package's kernels and
code), in windows of N steps in turns, from one trainer per version on the
same seed. The card's name and power limit come first, the medians last, as
one JSON line.
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
PEAK_TF32, PEAK_FP32 = 495e12, 67e12  # dense, one H100 SXM at 700 W
# Per --kernel: its source, the C entry point, the kernels whose ptxas lines
# are shown (the 3xTF32 ones and the fp32 FMA ones they replaced), the
# kernels timed with the [S, S] x D products each does, the outputs, and
# chip_smoke.py's fp32 bars (rtol, atol times max|ref|).
SPECS = {
    "bwd": {"source": "flash_attn_bwd.cu", "entry": "flash_attn_bwd",
            "ptxas": ("dkv_tf32_kernel", "dq_tf32_kernel", "dkv_kernel", "dq_kernel"),
            "kernels": (("K6", 4), ("K7", 3)), "outputs": ("dq", "dk", "dv"), "bars": (1e-3, 1e-4)},
    "fwd": {"source": "flash_attn_fwd.cu", "entry": "flash_attn_fwd",
            "ptxas": ("fwd_tf32_kernel", "fwd_kernel"),
            "kernels": (("K5", 2),), "outputs": ("o", "lse"), "bars": (1e-4, 1e-5)},
}


def build(variant: tuple[str, str, str]) -> tuple[str, str]:
    """The library of one variant (label, source, include directory) and the
    compiler's report."""
    from viforsdes_tpu_torch.ops.kernel_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    label, source, include = variant
    out_dir = BUILD_DIR / "flash_versions"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{os.path.basename(source)[:-3]}_{label}.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{include}", "-shared", "-o", str(lib), source]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{proc.stderr}")
    return str(lib), proc.stdout + proc.stderr


def kernel_report(report: str, kernels: tuple[str, ...]) -> list[str]:
    """ptxas's lines about ``kernels``: those from a kernel's 'Compiling
    entry' line up to the next entry."""
    lines, inside = [], False
    for line in report.splitlines():
        if "Compiling entry" in line:
            inside = any(k in line for k in kernels)
        if inside and any(w in line for w in ("Compiling entry", "registers", "spill", "wgmma", "arning")):
            lines.append(line.strip())
    return lines


def variant_of(spec: str, source: str) -> tuple[str, str, str]:
    label, path = spec.split("=", 1)
    path = os.path.abspath(path)
    if os.path.isdir(path):
        csrc = os.path.join(path, "viforsdes_tpu_torch", "csrc")
        return label, os.path.join(csrc, source), csrc
    from viforsdes_tpu_torch.ops.kernel_build import CSRC_DIR

    return label, path, str(CSRC_DIR)


def max_err(torch, a, ref, bars: tuple[float, float], what: str, check: bool = True) -> float:
    """Largest |a - ref|, held elementwise to rtol |ref| + atol max|ref|
    where ``check``."""
    rtol, atol = bars
    a, ref = a.double(), ref.double()
    err = (a - ref).abs()
    bad = not bool(torch.isfinite(a).all()) or bool((err > rtol * ref.abs() + atol * ref.abs().max()).any())
    if check and bad:
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3e} beyond the fp32 bars")
    return float(err.max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=sorted(SPECS), default="bwd", help="K5 (fwd) or K6 and K7 (bwd)")
    parser.add_argument("--turns", type=int, default=5)
    parser.add_argument("--launches", type=int, default=5, help="launches per timed window")
    parser.add_argument("--steps", type=int, default=0, help="fp32 Lorenz steps a window (0: no step timing)")
    parser.add_argument("--no-check", action="store_true", help="do not hold versions other than the tree to the bars")
    parser.add_argument("versions", nargs="*", default=[], help="LABEL=PATH: a repository root or a source file")
    args = parser.parse_args()
    spec = SPECS[args.kernel]

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
    variants = [("tree", str(CSRC_DIR / spec["source"]), str(CSRC_DIR))]
    variants += [variant_of(v, spec["source"]) for v in args.versions]
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        built = list(pool.map(build, variants))
    libs = {}
    for (label, source, _), (path, report) in zip(variants, built):
        for line in kernel_report(report, spec["ptxas"]):
            print(f"[ptxas {label}] {line}", flush=True)
        lib = ctypes.CDLL(path)
        entry = getattr(lib, spec["entry"])
        entry.argtypes = ATTENTION.signatures[spec["entry"]]
        entry.restype = ctypes.c_int
        libs[label] = entry
        print(f"[build] {label}: {source}", flush=True)
    for kernel in ("fwd", "dkv", "dq"):
        print(f"[plan] tree {kernel} fp32 D=64: {fa.flash_plan(kernel, 64, torch.float32)}", flush=True)

    b, h, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(80)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in torch.chunk(qkv, 3, dim=-1))
    do = torch.randn(SHAPE, generator=gen, device="cuda")
    scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream().cuda_stream
    if args.kernel == "fwd":
        qt, kt, vt = (fa._tma_operand(t) for t in (q, k, v))
        outs_t = (fa.bshd_empty(qt), torch.empty((b, h, s), dtype=torch.float32, device="cuda"))
        c_args = (*fa.view_args(qt), *fa.view_args(kt), *fa.view_args(vt), *fa.view_args(outs_t[0]),
                  outs_t[1].data_ptr(), b, h, s, d, s, 0, scale)
        keep = (qt, kt, vt)
        refs = list(fa._forward_plain(q, k, v, s, scale))
        passes = {"K5": ()}
    else:
        o, lse = fa._forward_cuda(q, k, v, s, scale)
        (c_args, keep), *outs_t = fa._backward_operands(q, k, v, o, lse, do, s, scale)
        refs = [g.float() for g in fa._backward_plain(q, k, v, o, lse, do, s, scale)]
        passes = {"K6": (0,), "K7": (1,)}

    def launch(label: str, kern: str) -> None:
        raise_on(libs[label](*c_args, *passes[kern], stream), f"{label} {kern}")

    errs, outs = {}, {}
    for label in libs:
        for g in outs_t:
            g.zero_()
        for kern in passes:
            launch(label, kern)
        torch.cuda.synchronize()
        check = label == "tree" or not args.no_check
        errs[label] = {n: max_err(torch, g, r, spec["bars"], f"{label} {n}", check)
                       for n, g, r in zip(spec["outputs"], outs_t, refs)}
        outs[label] = [g.clone() for g in outs_t]
        same = [bool(torch.equal(x, y)) for x, y in zip(outs[label], outs["tree"])]
        print(f"[check] {label}: max |err| {json.dumps(errs[label])} within rtol {spec['bars'][0]}, atol "
              f"{spec['bars'][1]} x max|ref|; bitwise equal to the tree's {', '.join(spec['outputs'])}: {same}",
              flush=True)
    del outs

    lib_name, library = library_arm(torch, args.kernel, q, k, v, do)
    arms = {lib_name: library}
    for label in libs:
        for kern in passes:
            arms[f"{label}_{kern}"] = lambda label=label, kern=kern: launch(label, kern)
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
              for kern, n in spec["kernels"]}
    med = {name: statistics.median(w) for name, w in windows.items()}
    lib_ms = med[lib_name]
    result = {"card": smi, "kernel": args.kernel, "shape": list(SHAPE), "launches_per_window": args.launches,
              "turns": args.turns, "bounds_ms": bounds, f"{lib_name}_ms": lib_ms, "variants": {}}
    print(f"[time] library {args.kernel} (memory-efficient, {' + '.join(passes)}'s work): median {lib_ms:.4f} ms "
          f"(min {min(windows[lib_name]):.4f}, max {max(windows[lib_name]):.4f})", flush=True)
    for label in libs:
        row = {"max_abs_err": errs[label]}
        for kern in passes:
            ts = windows[f"{label}_{kern}"]
            m = statistics.median(ts)
            bd = bounds[kern]
            row[kern] = {"median_ms": m, "windows_ms": ts, "share_tf32": bd["tf32_ms"] / m,
                         "share_fma": bd["fma_ms"] / m}
            print(f"[time] {label} {kern} fp32: median {m:.4f} ms over {len(ts)} windows (min {min(ts):.4f}, "
                  f"max {max(ts):.4f}); 3xTF32 bound {bd['tf32_ms']:.4f} ms ({bd['tf32_ms'] / m:.3f} of it), "
                  f"FMA bound {bd['fma_ms']:.4f} ms ({bd['fma_ms'] / m:.3f})", flush=True)
        total = sum(row[kern]["median_ms"] for kern in passes)
        row["total_ms"], row["over_library"] = total, total / lib_ms
        print(f"[time] {label} {' + '.join(passes)} fp32: {total:.4f} ms, {total / lib_ms:.3f}x the library "
              f"{args.kernel}", flush=True)
        result["variants"][label] = row
    del keep, refs, q, k, v, qkv, do, outs_t, arms, library
    if args.steps:
        result["lorenz_fp32_step"] = lorenz_steps(torch, fa, spec["entry"], libs, args.steps, args.turns)
    print(json.dumps(result))
    return 0


def library_arm(torch, kernel: str, q, k, v, do):
    """The yardstick (the port never calls it): the name and a call of
    PyTorch's memory-efficient attention on the same inputs, its forward for
    K5, its backward on one retained graph for K6 and K7."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if kernel == "fwd":
        def forward() -> None:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                F.scaled_dot_product_attention(q, k, v)

        return "library_fwd_fp32", forward
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(*ins)
    return "library_bwd_fp32", lambda: torch.autograd.grad(out, ins, do, retain_graph=True)


class _Version:
    """The package's attention library with the entry point ``name`` (K5, or
    K6 and K7) taken from another build."""

    def __init__(self, tree, name: str, fn) -> None:
        self.tree, self.name, self.fn = tree, name, fn

    def __getattr__(self, name: str):
        return self.fn if name == self.name else getattr(self.tree, name)


class _Swap:
    """Stands in for ``kernel_build.ATTENTION`` in ``ops/flash_attention.py``:
    ``get()`` gives the library of the version in use."""

    def __init__(self, tree, name: str, libs: dict) -> None:
        self.versions = {label: _Version(tree, name, fn) for label, fn in libs.items()}
        self.label = "tree"

    def get(self):
        return self.versions[self.label]


def lorenz_steps(torch, fa, name: str, libs: dict, n: int, turns: int) -> dict:
    """ms per fp32 Lorenz step, one step a call, through each version's entry
    point ``name``."""
    import time

    import chip_smoke
    import viforsdes_tpu_torch as vt

    tree = fa.ATTENTION
    swap = _Swap(tree.get(), name, libs)
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
