#!/usr/bin/env python3
"""Time K7, the bf16 flash-attention dQ pass, as built from several versions
of its source on one NVIDIA GPU.

    python3 tools/time_k7_tiles.py [--turns 3] [FILE ...]

Builds the package's ``csrc/flash_attn_bwd.cu`` (as ``tree``) and each FILE,
another version of that source (``base0``, ``base1``, ...; the package's
headers are on the include path), into ``viforsdes_tpu_torch/_build/k7_tiles/``
(one ``nvcc`` each, all started together). For each build it prints ptxas's
lines for ``dq_wgmma_kernel`` (registers, spills, and any warning that it
serialized the wgmma products) and K7's plan (q rows a block, kv rows a
stage), checks that its dq at the Lorenz shape [32, 4, 2001, 64] bf16 (q, k,
v strided views of one projection, as on the main path) is within the bf16
bar of the plain backward, and then times the builds' dq pass in turns (each
turn runs the builds in order, then in reverse) with CUDA events. To time
another kv-tile height, copy the source and change ``DqPlan::kKv``. The
card's name and power limit come first, the medians last, as one JSON line.
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
BF16_BWD = 3e-2  # chip_smoke.py's bar: max |err| <= bar * max|ref|
LAUNCHES = 20    # launches per timed window


def build(variant: tuple[str, str]) -> tuple[str, str]:
    """The library of one variant (label, source) and the compiler's report."""
    from viforsdes_tpu_torch.ops.kernel_build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc

    label, source = variant
    out_dir = BUILD_DIR / "k7_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libflash_bwd_{label}.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-shared", "-o", str(lib), source]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{proc.stderr}")
    return str(lib), proc.stdout + proc.stderr


def k7_report(report: str) -> list[str]:
    """ptxas's lines about dq_wgmma_kernel: those from its 'Compiling entry'
    line up to the next entry, and any other line that names it."""
    lines, inside = [], False
    for line in report.splitlines():
        if "Compiling entry" in line:
            inside = "dq_wgmma_kernel" in line
        if inside or "dq_wgmma_kernel" in line:
            if any(w in line for w in ("Compiling entry", "registers", "spill", "wgmma", "arning")):
                lines.append(line.strip())
    return lines


def window_ms(torch, fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--turns", type=int, default=3)
    parser.add_argument("sources", nargs="*", default=[],
                        help="other versions of flash_attn_bwd.cu to time beside the package's")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_k7_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from viforsdes_tpu_torch.ops import flash_attention as fa
    from viforsdes_tpu_torch.ops.kernel_build import ATTENTION, CSRC_DIR, raise_on

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    variants = [("tree", str(CSRC_DIR / "flash_attn_bwd.cu"))]
    variants += [(f"base{i}", os.path.abspath(path)) for i, path in enumerate(args.sources)]
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        built = list(pool.map(build, variants))
    libs = {}
    for (label, source), (path, report) in zip(variants, built):
        for line in k7_report(report):
            print(f"[ptxas {label}] {line}", flush=True)
        lib = ctypes.CDLL(path)
        for fn in ("flash_attn_bwd", "flash_attn_bwd_plan"):
            getattr(lib, fn).argtypes = ATTENTION.signatures[fn]
            getattr(lib, fn).restype = ctypes.c_int
        plan = (ctypes.c_longlong * 5)()
        raise_on(lib.flash_attn_bwd_plan(SHAPE[3], 1, 1, plan), f"K7 plan {label}")
        print(f"[plan {label}] {source}: {plan[0]} q rows a block, {plan[1]} kv rows a stage", flush=True)
        libs[label] = lib

    b, h, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(80)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in torch.chunk(qkv, 3, dim=-1))
    do = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._forward_cuda(q, k, v, s, scale)
    (c_args, keep), dq, _, _ = fa._backward_operands(q, k, v, o, lse, do, s, scale)
    dq_ref = fa._backward_plain(q, k, v, o, lse, do, s, scale)[0].float()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(label: str) -> None:
        raise_on(libs[label].flash_attn_bwd(*c_args, 1, stream), f"K7 {label}")

    errs = {}
    for label in libs:
        dq.zero_()
        launch(label)
        torch.cuda.synchronize()
        err = float((dq.float() - dq_ref).abs().max())
        errs[label] = err
        if not math.isfinite(err) or err > BF16_BWD * float(dq_ref.abs().max()):
            raise AssertionError(f"K7 {label}: max |err| {err:.3e} against the plain dq")
        print(f"[check] {label}: dq max |err| {err:.3e} (bar {BF16_BWD} x max|ref| "
              f"{float(dq_ref.abs().max()):.3e})", flush=True)

    labels = list(libs)
    times = {label: [] for label in labels}
    for label in labels:  # warm every build and the clocks
        for _ in range(50):
            launch(label)
    torch.cuda.synchronize()
    for _ in range(args.turns):
        for label in [*labels, *reversed(labels)]:
            times[label].append(window_ms(torch, lambda: launch(label)))
    flop = 3 * 2 * b * h * s * s * d
    bound_ms = flop / 989e12 * 1e3
    result = {"card": smi, "shape": list(SHAPE), "bound_ms": bound_ms, "variants": {}}
    for label, ts in times.items():
        med = statistics.median(ts)
        result["variants"][label] = {"median_ms": med, "windows_ms": ts, "share_of_bound": bound_ms / med,
                                     "max_abs_err": errs[label]}
        print(f"[time] {label}: median {med:.4f} ms over {len(ts)} windows of {LAUNCHES} "
              f"(min {min(ts):.4f}, max {max(ts):.4f}), {bound_ms / med:.3f} of the {bound_ms:.4f} ms bound",
              flush=True)
    del keep
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
