"""Build the package's CUDA sources into shared libraries and load them.

The sources under ``viforsdes_tpu_torch/csrc/`` have a plain C interface, so
they compile with ``nvcc`` alone in seconds (no PyTorch headers) and bind with
``ctypes``. A library builds at first use: one ``nvcc`` per source, all started
together, then one link. It is cached in ``viforsdes_tpu_torch/_build/`` under
a hash of the flags, its own sources and the local headers they include, so
an edit rebuilds only the libraries that use the edited file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch import Tensor

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{CSRC_DIR} at first use"
        )
    return found


def dependencies(sources: list[str]) -> list[str]:
    """``sources`` and the ``csrc/`` headers they include, transitively."""
    seen: set[str] = set()
    todo = list(sources)
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        todo.extend(_LOCAL_INCLUDE.findall((CSRC_DIR / name).read_text()))
    return sorted(seen)


def library_path(name: str, sources: list[str]) -> Path:
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *sorted(sources)]).encode())
    for dep in dependencies(sources):
        digest.update(dep.encode() + (CSRC_DIR / dep).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, check=False)


def build_library(name: str, sources: list[str]) -> Path:
    """Compile ``sources`` (file names under ``csrc/``) unless the cached
    library for their current content exists. The compiler's resource report
    (``-Xptxas -v``) is kept beside the library as ``.log``."""
    lib = library_path(name, sources)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [str(Path(tmp) / f"{Path(s).stem}.o") for s in sources]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / src)]
            for src, obj in zip(sources, objects)
        ]
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            procs = list(pool.map(_run, compiles))
        link = [nvcc, "-shared", "-o", str(Path(tmp) / "lib.so"), *objects]
        if all(p.returncode == 0 for p in procs):
            procs.append(_run(link))
            compiles.append(link)
        lib.with_suffix(".log").write_text("".join(p.stdout + p.stderr for p in procs))
        for cmd, proc in zip(compiles, procs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
                )
        os.replace(Path(tmp) / "lib.so", lib)  # atomic: a concurrent process never loads half a file
    return lib


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name, sources)))


class Library:
    """A library of ``csrc/`` sources, built and loaded at its first use
    (never at import) with the argument types of its C functions set."""

    def __init__(self, name: str, sources: list[str], signatures: dict[str, list]) -> None:
        self.name = name
        self.sources = sources
        self.signatures = signatures
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = load_library(self.name, self.sources)
                for fn, argtypes in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def report(self) -> Path:
        """The compiler's resource report of the built library."""
        return library_path(self.name, self.sources).with_suffix(".log")


_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_view = [_p, _ll, _ll, _ll]  # a [B, H, S, D] view: pointer and three strides

SDE_SAMPLER = Library(
    "sde_sampler",
    ["sde_sampler_fwd.cu", "sde_sampler_bwd.cu"],
    {
        "sde_sampler_fwd": [_p] * 11 + [_i] * 10 + [_f] * 3 + [_p],
        "sde_sampler_fwd_plan": [_i] * 9 + [_p],
        "sde_sampler_bwd": [_p] * 28 + [_i] * 10 + [_f] * 3 + [_p],
        "sde_sampler_bwd_plan": [_i] * 9 + [_p],
        "sde_sampler_fwd_max_clusters": [_i, _i, _i, _ll, _p],
        "sde_sampler_bwd_max_clusters": [_i, _i, _i, _ll, _p],
        "sde_sampler_weight_grad": [_p, _i, _i, _i, _p, _i, _i, _i, _p, _i, _p, _p, _p],
    },
)

ATTENTION = Library(
    "attention",
    ["qk_prep.cu", "flash_attn_fwd.cu", "flash_attn_bwd.cu"],
    {
        "qk_prep_fwd": _view + [_p, _p] + _view + [_i] * 5 + [_f, _p],
        "qk_prep_bwd": _view * 2 + [_p, _p] + _view + [_i] * 5 + [_f, _p],
        "flash_attn_fwd": _view * 4 + [_p] + [_i] * 6 + [_f, _p],
        "flash_attn_bwd": _view * 4 + [_p, _p] + _view * 3 + [_i] * 6 + [_f, _i, _p],
        "flash_attn_fwd_plan": [_i, _i, _p],
        "flash_attn_bwd_plan": [_i, _i, _i, _p],
    },
)

# the SiT's norm sites (ops/adaln_norm.py)
ADALN_NORM = Library(
    "adaln_norm",
    ["adaln_norm.cu"],
    {
        "adaln_norm_fwd": [_p] * 3 + [_ll, _p, _ll, _p, _ll] + [_p] * 3 + [_i] * 5 + [_f, _p],
        "adaln_norm_bwd": [_p] * 3 + [_ll, _p, _ll] + [_p] * 7 + [_i] * 5 + [_p],
    },
)

# the span markers of utils/profiling.py
SPANS = Library(
    "spans",
    ["spans.cu"],
    {
        "span_mark": [_i, _i, _p, _p, _p],
        "span_captured_nodes": [_p, _p],
    },
)

LIBRARIES = (SDE_SAMPLER, ATTENTION, ADALN_NORM, SPANS)


class LaunchCounter:
    """Plain count of kernel launches made by a wrapper."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def raise_on(err: int, what: str) -> None:
    """Raise for a non-zero error code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def kernel_operand(t: Tensor) -> Tensor:
    """``t`` itself when the attention kernels can read it through its strides
    (unit stride on the last axis, 16-byte aligned rows), else a contiguous
    copy."""
    vec = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def view_args(t: Tensor) -> tuple[int, int, int, int]:
    """Pointer and the first three element strides of a ``[B, H, S, D]`` view."""
    return (t.data_ptr(), *t.stride()[:3])
