"""Build and load the port's CUDA library.

``nvcc`` compiles the repository's own sources (``csrc/*.cu``, one process
per source, all started together) and links them into one shared library
with a plain C interface, loaded with ``ctypes``.  The build
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
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# no --use_fast_math or -ftz: the float formats' subnormal grids need
# denormals kept
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# preprocessor names defined for every source: a profiling build (e.g.
# SMAQ_PHASES, profile_onepass.py) sets them before the library loads, and
# gets a library of its own (they are part of the key)
DEFINES: tuple[str, ...] = ()

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


def _flags() -> tuple[str, ...]:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in DEFINES))


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libsmaq_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build() -> str:
    """Compile the library if it is not built yet; returns its path."""
    global build_log
    out = _library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    nvcc = _nvcc()
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
    compiles = [[nvcc, *_flags(), "-c", "-o", o, s] for s, o in zip(cus, objs)]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", f"{tmp}.so", *objs]
    try:
        with ThreadPoolExecutor(len(compiles)) as pool:
            procs = list(pool.map(_run, compiles))
        build_log = "".join(p.stdout + p.stderr for p in procs)
        for cmd, proc in zip(compiles, procs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
        proc = _run(link)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{build_log}")
        os.replace(f"{tmp}.so", out)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    u32 = ctypes.c_uint
    quant = [f, f, f, f, f, f, f, i, i]  # SmaQ's threshold, ranges, clamp and bits
    # the elementwise kernels take x, y, n and the elements' dtype (launch.DTYPES)
    lib.smaq_stats.argtypes = [p, ll, i, i, *quant, p, p, p, i, i, p]
    lib.smaq_stats.restype = i
    # a stochastic kernel takes a pointer to its step key, a call index and
    # the element offset of its tensor in a larger one
    lib.smaq_quantize.argtypes = [p, p, ll, i, p, p, i, i, p, u32, ll, i, i, i, *quant, p, p, i,
                                  i, p]
    lib.smaq_quantize.restype = i
    lib.smaq_quantize_bn.argtypes = [
        p, p, ll, i, p, p, i, p, p, i, ll, p, u32, ll, i, i, i, *quant, p, p, i, i, p,
    ]
    lib.smaq_quantize_bn.restype = i
    lib.smaq_onepass.argtypes = [p, p, ll, i, i, p, u32, ll, i, i, i, *quant, p, p, p, i, i, p]
    lib.smaq_onepass.restype = i
    lib.smaq_onepass_smem.argtypes = [i, i, p]
    lib.smaq_onepass_smem.restype = i
    lib.smaq_occupancy.argtypes = [i, i, ll, p]
    lib.smaq_occupancy.restype = i
    lib.float_quantize.argtypes = [p, p, ll, i, i, i, u32, u32, f, f, p, u32, ll, i, i, i, i, p]
    lib.float_quantize.restype = i
    lib.float_occupancy.argtypes = [i, i, p]
    lib.float_occupancy.restype = i
    lib.s2fp8_stats.argtypes = [p, ll, i, p, p, i, i, p]
    lib.s2fp8_stats.restype = i
    lib.s2fp8_quantize.argtypes = [p, p, ll, i, p, p, u32, ll, i, i, i, i, p]
    lib.s2fp8_quantize.restype = i
    # the bfloat16 split form's table kernels (csrc/s2fp8.cu: bfloat16 only)
    lib.s2fp8_stats_table.argtypes = [p, ll, p, p, i, i, p]
    lib.s2fp8_stats_table.restype = i
    lib.s2fp8_quantize_window.argtypes = [p, p, ll, p, p, u32, ll, i, i, i, i, p]
    lib.s2fp8_quantize_window.restype = i
    lib.s2fp8_occupancy.argtypes = [i, i, i, i, p]
    lib.s2fp8_occupancy.restype = i
    lib.philox_fill.argtypes = [p, ll, p, u32, ll, i, i, i, p]
    lib.philox_fill.restype = i


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
