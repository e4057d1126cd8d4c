"""Build the package's CUDA sources into a shared library and load it.

The sources under ``viforsdes_tpu_torch/csrc/`` have a plain C interface, so
they compile with ``nvcc`` alone in seconds (no PyTorch headers) and bind with
``ctypes``. The build happens at first use and is cached in
``viforsdes_tpu_torch/_build/`` under a hash of the sources and flags, so a
fresh checkout builds once and an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


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


def library_path(name: str, sources: list[str]) -> Path:
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *sorted(sources)]).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):  # sources and the headers they include
        digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_library(name: str, sources: list[str]) -> Path:
    """Compile ``sources`` (file names under ``csrc/``) unless the cached
    library for their current content exists. The compiler's resource report
    (``-Xptxas -v``) is kept beside the library as ``.log``."""
    lib = library_path(name, sources)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name, sources)))
