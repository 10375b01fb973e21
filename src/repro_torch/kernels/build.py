"""Build and load the CUDA sources under ``repro_torch/csrc``.

Each ``*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Libraries land
in ``build/repro_torch/`` at the repository root, named by a hash of
their sources and flags, so an edited source is never served stale.
All missing libraries are compiled in parallel, one ``nvcc`` each.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("keyswitch.cu", "modmul.cu", "bconv.cu", "ntt.cu")
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"   # when nvcc is not on PATH
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the repro_torch CUDA kernels are built from "
            "source at first use and need the CUDA toolkit")
    return path


def _lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / "common.cuh", CSRC / source):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> float:
    """Compile every missing library among `sources`, all nvcc processes
    started together. Returns wall seconds spent. The ptxas report
    (registers, shared memory, spills) is kept beside each library."""
    t0 = time.perf_counter()
    todo = [(s, _lib_path(s)) for s in sources if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, p in procs:
        log, _ = p.communicate()
        out.with_suffix(".ptxas.txt").write_text(log)
        if p.returncode != 0:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(source: str) -> str:
    """What ptxas said about `source`'s kernels (after a build)."""
    p = _lib_path(source).with_suffix(".ptxas.txt")
    return p.read_text() if p.exists() else ""


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        build([source])
        lib = _libs[source] = ctypes.CDLL(str(_lib_path(source)))
    return lib


def bind(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int):
    """Declare a C entry `int name(void* x n_ptr, int x n_int, void*
    stream)` and return it: pointers and the stream as c_void_p so
    ctypes never truncates them to 32 bits."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(fn, *args) -> None:
    """Call a bound entry on torch's current stream; raise on the
    cudaError_t it returns (the launch's cudaGetLastError)."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


LAUNCH_KEYS = ("grid_x", "grid_y", "grid_z", "cluster", "threads",
               "smem_bytes", "max_active_clusters", "registers",
               "local_bytes")


def launch_info(source: str, name: str, *dims: int) -> Dict[str, int]:
    """Call a C entry `int name(int* info, int x len(dims))` that writes
    the launch its kernel would make (csrc/common.cuh::ClusterLaunch)
    without running it, and return that launch by `LAUNCH_KEYS`."""
    fn = getattr(library(source), name)
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * len(dims)
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(LAUNCH_KEYS))()
    err = fn(ctypes.addressof(info), *dims)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return dict(zip(LAUNCH_KEYS, info))
