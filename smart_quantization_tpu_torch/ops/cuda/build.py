"""Build and load the port's CUDA library.

``nvcc`` compiles the repository's own sources (``csrc/*.cu``) into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, never at import, and is keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
library already in ``smart_quantization_tpu_torch/_build/``.  A failed build
raises: nothing carries on without the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output (register and spill report) of the last build


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libsmaq_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is not built yet; returns its path."""
    global build_log
    out = _library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[s for s in sources() if s.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.smaq_stats.argtypes = [p, ll, p, i, i, p]
    lib.smaq_stats.restype = i
    lib.smaq_quantize.argtypes = [
        p, p, ll, p, p, i, i, ctypes.c_ulonglong, i, i, i,
        f, f, f, f, f, f, f, i, i, p, p, i, i, p,
    ]
    lib.smaq_quantize.restype = i


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def loaded() -> bool:
    return _lib is not None
