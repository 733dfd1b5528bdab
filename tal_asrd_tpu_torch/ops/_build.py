"""Build and load the port's CUDA kernels at first use.

The sources under `tal_asrd_tpu_torch/csrc/*.cu` expose a plain C interface
(no PyTorch headers), so `nvcc` compiles each in seconds; headers (`*.cuh`)
are included, not compiled on their own. Every source is
compiled to an object file by its own `nvcc` process, all started together,
then linked into one shared library that is loaded with `ctypes`. The library
lands in `tal_asrd_tpu_torch/_build/`, named by a hash of the sources and the
flags, so an edit rebuilds and an unchanged tree loads what is there.

Nothing here runs at import: a machine without `nvcc` (the CPU tests) imports
this module freely and only `load_library()` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # the decode sources instantiate eight kernels each; nvcc compiles them
    # in parallel (on an H100 host: 12 s instead of 38 s for one source)
    "--split-compile=8",
]


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0   # wall time of the last build (0 if it was cached)


def _find_nvcc() -> str:
    candidates = [
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels of tal_asrd_tpu_torch cannot be built")


def sources() -> List[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cu"))


def _digest() -> str:
    """Hash of the flags and of every file under csrc/ (headers included)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(paths: List[str], out_path: str) -> None:
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    procs = []
    for src in paths:
        obj = os.path.join(
            BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
        procs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, _, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _, _ in procs]
    try:
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp = f"{out_path}.{tag}.tmp"
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n{res.stdout}")
        os.replace(tmp, out_path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/ if it is not there yet."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out_path = os.path.join(BUILD_DIR, f"libtal_kernels_{_digest()}.so")
        if not os.path.exists(out_path):
            t0 = time.perf_counter()
            _build(sources(), out_path)
            build_seconds = time.perf_counter() - t0
        _lib = ctypes.CDLL(out_path)
        return _lib
