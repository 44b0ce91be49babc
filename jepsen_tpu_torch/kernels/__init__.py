"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `.cu` file in this directory with a plain C interface
(the sparse kernels share `sparse_common.cuh`). On first use it is
compiled with `nvcc` for Hopper (`sm_90a`) into a shared library under
`build/torch_kernels/` at the repository root, named by a hash of its
source, the directory's headers and the flags, and loaded with ctypes. Nothing
here runs at import: the CPU tests import every module of the port, and
the CPU has neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[1] / "build" / "torch_kernels"
SOURCES = {"closure": "closure.cu",
           "frontier_closure": "frontier_closure.cu",
           "tiled_insert": "tiled_insert.cu"}
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source on "
                       "first use")


def library_path(name: str) -> Path:
    src = (KERNEL_DIR / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(KERNEL_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output for the build of `name` (register and shared-memory
    use per kernel, from -Xptxas=-v), or "" when it was not built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=None) -> float:
    """Compile every kernel not yet built, one nvcc each, all started
    together. Returns the seconds the builds took (0.0: all were built).
    Raises RuntimeError with nvcc's output when a build fails."""
    todo = [n for n in (SOURCES if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / SOURCES[n])]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
            continue
        library_path(n).with_suffix(".log").write_text(log)
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
