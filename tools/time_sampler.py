#!/usr/bin/env python3
"""Time K1 and K2, the path-sampler kernels, as built from several versions
of the package on one NVIDIA GPU, in turns.

    python3 tools/time_sampler.py [--turns 2] [--shapes ou,lorenz,...] [--rungs lorenz,...] [LABEL=DIR ...]

``tree`` is the package beside this script. Each ``LABEL=DIR`` names another
version: DIR is the root of a copy of the repository (``git archive`` of
another commit, or a copy with an edited kernel source), whose
``viforsdes_tpu_torch/ops/sde_sampler.py`` is loaded under its own name and
whose ``viforsdes_tpu_torch/csrc/sde_sampler_*.cu`` are built into their own
library (one ``nvcc`` per source, all started together, into
``viforsdes_tpu_torch/_build/sampler_versions/``). Every version gets the
same weights and streams at each shape. K1 is held to the plain forward of
the tree and K2 to its plain backward within ``chip_smoke.py``'s bars
(``--no-check`` skips that, for copies with phases cut out); then each
version's K1 and K2 are timed with CUDA events, in turns (each turn runs the
versions in order, then in reverse). Where a version's ``_forward_cuda``
takes ``staged``, K1 is also timed on its streaming plan. The card's name
and power limit come first, the medians last, as one JSON line.

``--rungs`` names rungs of ``examples_torch/quality_eval.py`` (``RUNGS``;
``--shapes ""`` times none of the shapes): each trains ``RUNG_STEPS`` steps
at its committed recipe and full width in one CUDA graph, then every
version captures a chunk of as many steps on its own K1 and K2 (the tree's
``sampler_forward`` and ``sampler_backward`` swapped for the version's
while it captures), the chunks' replays are timed in turns, and one replay
of each is profiled: device ms per step, and K1 and K2's three parts (the
gate pass, the BPTT, the weight gradients) by kernel name.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# label -> (B, T, D, H, L, dt): the OU and Lorenz paths, the [dp] microbatch,
# examples/highdim_ou_dp.py's batch on one card, the ladder's Lorenz r3 and
# highdim r5 heads (128 x 3, 128 x 2) and the Lorenz shape at K1's widest head
SHAPES = {
    "ou": (128, 100, 1, 64, 2, 0.05),
    "lorenz": (32, 2000, 3, 64, 2, 0.01),
    "d32": (1024, 100, 32, 64, 2, 0.05),
    "d32_wide": (4096, 500, 32, 64, 2, 0.05),
    "lorenz_r3": (32, 2000, 3, 128, 3, 0.01),
    "highdim_r5": (512, 100, 32, 128, 2, 0.05),
    "h256": (32, 2000, 3, 256, 2, 0.01),
}
RUNG_STEPS = 10  # steps of a rung's run, and of each version's chunk
RUNG_WINDOWS = 2  # timed replays of each version's chunk a turn
# the sampler's device kernels by the profiler's name: K1, and K2's three passes
SAMPLER_KERNELS = {
    "K1": r"sde_sampler::fwd_(cluster_)?kernel",
    "K2 gates": r"sde_sampler::gates_kernel",
    "K2 bptt": r"sde_sampler::bptt_(cluster_)?kernel",
    "K2 wgrad": r"sde_sampler::wgrad_(partial|sum)",
}
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5   # chip_smoke.py's bars
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4
DIAG_MIN = 1e-3


def build(variant: tuple[str, str]) -> tuple[str, str]:
    """The sampler library of one version (label, package root) and the
    compiler's report."""
    from viforsdes_tpu_torch.ops.kernel_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    label, root = variant
    csrc = os.path.join(root, "viforsdes_tpu_torch", "csrc")
    out_dir = BUILD_DIR / "sampler_versions" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    objs, cmds = [], []
    for src in ("sde_sampler_fwd.cu", "sde_sampler_bwd.cu"):
        obj = str(out_dir / (src + ".o"))
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, f"-I{csrc}", "-c", "-o", obj, os.path.join(csrc, src)])
    with ThreadPoolExecutor(max_workers=2) as pool:
        procs = list(pool.map(lambda c: subprocess.run(c, capture_output=True, text=True), cmds))
    for cmd, proc in zip(cmds, procs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}: {' '.join(cmd)}\n{proc.stderr}")
    lib = str(out_dir / "libsde_sampler.so")
    link = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed for {label}:\n{link.stderr}")
    return lib, "".join(p.stdout + p.stderr for p in procs)


class Loaded:
    """A built library in the shape of ``kernel_build.Library``."""

    def __init__(self, path: str, signatures: dict) -> None:
        self.lib = ctypes.CDLL(path)
        for fn, argtypes in signatures.items():
            if hasattr(self.lib, fn):
                getattr(self.lib, fn).argtypes = argtypes
                getattr(self.lib, fn).restype = ctypes.c_int

    def get(self) -> ctypes.CDLL:
        return self.lib


def load_module(label: str, root: str, library_path: str):
    """``ops/sde_sampler.py`` of the version at ``root``, bound to its own
    library (the signatures come from that version's ``kernel_build.py``)."""
    ops = os.path.join(root, "viforsdes_tpu_torch", "ops")
    kb_spec = importlib.util.spec_from_file_location(f"_kb_{label}", os.path.join(ops, "kernel_build.py"))
    kb = importlib.util.module_from_spec(kb_spec)
    kb_spec.loader.exec_module(kb)
    spec = importlib.util.spec_from_file_location(f"_sde_sampler_{label}", os.path.join(ops, "sde_sampler.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SDE_SAMPLER = Loaded(library_path, kb.SDE_SAMPLER.signatures)
    return mod


def window_ms(torch, fn, n: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(torch, fn) -> dict:
    """Device time of each kernel (by name) in one call of ``fn``, from the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out[e.key[:60]] = round(us / 1e3, 4)
    return out


def cluster_occupancy(torch, ss, spec, batch: int) -> dict:
    """The tree's K1 and K2 plans at ``batch`` and, on the cluster path, how
    many of their clusters the card holds at once."""
    out = {}
    lib = ss.SDE_SAMPLER.get()
    for kind, plan_fn, query in (("K1", ss.forward_plan, lib.sde_sampler_fwd_max_clusters),
                                 ("K2", ss.backward_plan, lib.sde_sampler_bwd_max_clusters)):
        plan = plan_fn(spec, batch, 0)
        out[kind] = {"path": ss.PATH_NAMES[plan.path], "cluster": plan.cluster, "rows": plan.rows,
                     "threads": plan.threads, "smem": plan.smem_bytes}
        if plan.path == ss.PATH_CLUSTER:
            n = ctypes.c_int(0)
            ss.raise_on(query(plan.cluster, plan.rw, plan.threads, plan.smem_bytes, ctypes.addressof(n)),
                        "max active clusters")
            out[kind]["max_active_clusters"] = n.value
            out[kind]["clusters"] = -(-batch // plan.rows)
    return out


def make_case(torch, ss, shape, seed: int):
    """Weights (as the head initializes its GRU; ``W_out`` at 0.1) and streams
    at ``shape`` (full Cholesky), drawn on the card."""
    B, T, D, H, L, dt = shape
    spec = ss.SamplerSpec(D, H, L, dt, DIAG_MIN, "full")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, generator=gen, device="cuda")

    def uniform(*s):  # the head's GRU init, U(+-1/sqrt(H))
        return (2 * torch.rand(s, generator=gen, device="cuda") - 1) * H ** -0.5

    g = 3 * H
    w = ss.SamplerWeights(
        w_x=uniform(D, g), w_hh0=uniform(H, g), b_hh0=uniform(g), w_ih_st=uniform(L - 1, H, g),
        w_hh_st=uniform(L - 1, H, g), b_ih_st=uniform(L - 1, g), b_hh_st=uniform(L - 1, g),
        w_out=randn(H, spec.n_out, scale=0.1), b_out=randn(spec.n_out, scale=0.1),
    )
    x0, gc, eps = randn(B, D), randn(T, B, g), randn(T, B, D)
    cot = (randn(T, B, D), randn(T, B, D), randn(T, B, spec.n_tril))
    return spec, w, x0, gc, eps, cot


def rel_err(a, ref, rtol: float, atol: float) -> float:
    """Largest |a - ref| / (rtol |ref| + atol max|ref|): at most 1 within the bar."""
    a, ref = a.double(), ref.double()
    bar = rtol * ref.abs() + atol * max(1.0, float(ref.abs().max()))
    return float(((a - ref).abs() / bar).max())


def rung_trainer(name: str):
    """The trainer of one rung (``quality_eval.RUNGS``) after ``RUNG_STEPS``
    steps at its committed recipe, in one chunk of as many steps."""
    from examples_torch import quality_eval as qe
    from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer

    fn, kw, _, _ = qe.RUNGS[name]
    seen = []
    saved = VariationalInferenceTrainer.train

    def train(self, *args, **kwargs):
        seen.append(self)
        return saved(self, *args, **kwargs)

    VariationalInferenceTrainer.train = train
    try:
        with tempfile.TemporaryDirectory() as out:
            fn(RUNG_STEPS, **kw, opts=qe.RunOptions(steps_per_call=RUNG_STEPS, out_dir=out))
    finally:
        VariationalInferenceTrainer.train = saved
    (trainer,) = seen
    return trainer


def replay_profile(torch, chunk, step: int) -> dict:
    """Device ms per step of one replay of ``chunk`` and of the sampler's
    kernels in it (``SAMPLER_KERNELS``), with their launches per replay."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk(step)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if events and hasattr(events[0], "self_device_time_total") else \
        "self_cuda_time_total"
    n = chunk.length
    out = {"device_ms_per_step": sum(getattr(e, attr) for e in events) / 1e3 / n}
    for kern, pattern in SAMPLER_KERNELS.items():
        hits = [e for e in events if re.search(pattern, e.key)]
        out[kern] = {"ms_per_step": sum(getattr(e, attr) for e in hits) / 1e3 / n,
                     "launches_per_replay": sum(e.count for e in hits)}
    return out


def rung_times(torch, tree, mods: dict, name: str, turns: int) -> dict:
    """One rung trained ``RUNG_STEPS`` steps, then each version's chunk of
    as many steps, captured on that version's K1 and K2: ms/step of the
    replays in turns (``RUNG_WINDOWS`` a version and turn, each ended by a
    synchronize), then one profiled replay of each."""
    import gc

    from viforsdes_tpu_torch.inference.chunk import TrainChunk

    trainer = rung_trainer(name)
    step = trainer._completed_steps
    chunks = {}
    saved = tree.sampler_forward, tree.sampler_backward
    try:
        for label, ss in mods.items():
            tree.sampler_forward, tree.sampler_backward = ss.sampler_forward, ss.sampler_backward
            chunks[label] = TrainChunk(trainer, RUNG_STEPS)
            chunks[label](step)  # the eager warm chunk, then the capture
            step += RUNG_STEPS
    finally:
        tree.sampler_forward, tree.sampler_backward = saved
    times = {label: [] for label in chunks}
    labels = list(chunks)
    for _ in range(turns):
        for label in [*labels, *reversed(labels)]:
            for _ in range(RUNG_WINDOWS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chunks[label](step)
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3 / RUNG_STEPS)
                step += RUNG_STEPS
    profiles = {}
    for label, chunk in chunks.items():
        profiles[label] = replay_profile(torch, chunk, step)
        step += RUNG_STEPS
    med = {label: statistics.median(v) for label, v in times.items()}
    print(f"[rung {name}] ms/step of {RUNG_STEPS}-step graph replays in turns: "
          + "; ".join(f"{k} {m:.3f} (min {min(times[k]):.3f}, max {max(times[k]):.3f})" for k, m in med.items())
          + f"; one profiled replay each: {json.dumps(profiles)}", flush=True)
    del trainer, chunks
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"median_ms_per_step": med, "windows_ms_per_step": times, "profiles": profiles}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--launches", type=int, default=3, help="launches per timed window")
    parser.add_argument("--shapes", default=",".join(SHAPES))
    parser.add_argument("--rungs", default="", help="rungs of examples_torch/quality_eval.py to time end to end")
    parser.add_argument("--no-check", action="store_true", help="time versions without holding them to the plain path")
    parser.add_argument("versions", nargs="*", default=[], help="LABEL=DIR: another version of the repository")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_sampler: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from viforsdes_tpu_torch.ops import sde_sampler as tree

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    versions = [tuple(v.split("=", 1)) for v in args.versions]
    with ThreadPoolExecutor(max_workers=max(1, len(versions))) as pool:
        built = list(pool.map(build, [(label, os.path.abspath(root)) for label, root in versions]))
    mods = {"tree": tree}
    for (label, root), (path, report) in zip(versions, built):
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill")):
                print(f"[ptxas {label}] {line.strip()}", flush=True)
        mods[label] = load_module(label, os.path.abspath(root), path)

    result = {"card": smi, "launches_per_window": args.launches, "shapes": {}, "rungs": {}}
    for name in filter(None, args.shapes.split(",")):
        shape = SHAPES[name]
        spec, w, x0, gc, eps, (d_paths, d_means, d_cholv) = make_case(torch, tree, shape, 7)
        ref_f = ref_b = None
        if not args.no_check and shape[0] * shape[1] <= 102400:  # the plain loop at the small shapes
            ref_f = tree._forward_plain(spec, w, x0, gc, eps, save_h=True)
            ref_b = tree._backward_plain(spec, w, x0, gc, eps, ref_f, d_paths, d_means, d_cholv)
        # every version's K2 reads the tree's K1 outputs
        fwd = tree._forward_cuda(spec, w, x0, gc, eps, save_h=True)
        arms, errs = {}, {}
        for label, ss in mods.items():
            sp = ss.SamplerSpec(*spec)
            ww = ss.SamplerWeights(*w)
            if ref_f is not None:
                out = ss._forward_cuda(sp, ww, x0, gc, eps, save_h=True)
                grads = ss._backward_cuda(sp, ww, x0, gc, eps, ss.SamplerOutputs(*ref_f), d_paths, d_means, d_cholv)
                torch.cuda.synchronize()
                errs[label] = {
                    "K1": max(rel_err(getattr(out, f), getattr(ref_f, f), FWD_RTOL, FWD_ATOL)
                              for f in ("paths", "raw", "h_all")),
                    "K2": max(rel_err(a, r, BWD_RTOL, BWD_ATOL) for a, r in zip(
                        (grads.d_gc, grads.d_eps, grads.d_x0, *grads.weights),
                        (ref_b.d_gc, ref_b.d_eps, ref_b.d_x0, *ref_b.weights))),
                }
                if max(errs[label].values()) > 1.0:
                    raise AssertionError(f"{label} at {name}: error / bar {errs[label]}")
                del out, grads
            bwd_args = (sp, ww, x0, gc, eps, ss.SamplerOutputs(*fwd), d_paths, d_means, d_cholv)
            arms[f"{label}_K1"] = (lambda ss=ss, sp=sp, ww=ww: ss._forward_cuda(sp, ww, x0, gc, eps, save_h=True))
            arms[f"{label}_K2"] = (lambda ss=ss, a=bwd_args: ss._backward_cuda(*a))
            if "staged" in inspect.signature(ss._forward_cuda).parameters:
                rows = ss.rows_per_block(shape[0], torch.cuda.get_device_properties(0).multi_processor_count)
                if ss.forward_plan(sp, rows, 0).staged:
                    arms[f"{label}_K1_streaming"] = (
                        lambda ss=ss, sp=sp, ww=ww: ss._forward_cuda(sp, ww, x0, gc, eps, save_h=True, staged=False))
        for fn in arms.values():
            fn()
        torch.cuda.synchronize()
        times = {k: [] for k in arms}
        labels = list(arms)
        for _ in range(args.turns):
            for k in [*labels, *reversed(labels)]:
                times[k].append(window_ms(torch, arms[k], args.launches))
        med = {k: statistics.median(v) for k, v in times.items()}
        occupancy = cluster_occupancy(torch, tree, spec, shape[0])
        kernels = {k: kernel_ms(torch, arms[k]) for k in ("tree_K1", "tree_K2")}
        print(f"[{name}] B={shape[0]} T={shape[1]} D={shape[2]} H={shape[3]} L={shape[4]}: "
              + "; ".join(f"{k} {m:.4f} ms (min {min(times[k]):.4f}, max {max(times[k]):.4f})"
                          for k, m in med.items())
              + (f"; error / bar {json.dumps(errs)}" if errs else ""), flush=True)
        print(f"[{name}] the tree's device kernels in one call, ms: {json.dumps(kernels)}; "
              f"its plans and the clusters the card holds at once: {json.dumps(occupancy)}", flush=True)
        result["shapes"][name] = {"shape": list(shape), "median_ms": med, "windows_ms": times,
                                  "err_over_bar": errs, "tree_kernels_ms": kernels, "tree_plans": occupancy}
        del arms, fwd, bwd_args, gc, eps, d_paths, d_means, d_cholv, ref_f, ref_b
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for name in filter(None, args.rungs.split(",")):
        result["rungs"][name] = rung_times(torch, tree, mods, name, args.turns)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
