"""Host libraries built from the repository's `native/*.cpp` and loaded with
ctypes at first use (the BPE merge loop and trainer, the edit distance).

Each library is compiled with g++ into the port's own git-ignored
`tal_asrd_tpu_torch/_build/`, named by a hash of its source, and written
under a temporary name that `os.replace` moves into place: processes that
build the same library at once (test workers, the JAX package building its
own copy under native/build/) never load a half-written file.

These are host code, not kernels: every caller keeps the reference's
pure-Python path, which gives the same results, and takes it when the
library cannot be had (no source, no g++, a failed build) or when the
environment sets TAL_ASRD_NO_NATIVE.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def load_host_library(name: str) -> Optional[ctypes.CDLL]:
    """`native/<name>.cpp` as a loaded library, built at first use; None when
    TAL_ASRD_NO_NATIVE is set or the library cannot be built or loaded."""
    if os.environ.get("TAL_ASRD_NO_NATIVE"):
        return None
    with _lock:
        if name not in _libs:
            _libs[name] = _build_and_load(name)
        return _libs[name]


def _build_and_load(name: str) -> Optional[ctypes.CDLL]:
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        except (OSError, subprocess.CalledProcessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None
